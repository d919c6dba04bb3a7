// leaf_products_lowp.cu — the leaf program's kernel (leaf_products.cuh) over fp16, fp8 e4m3fn
// and fp8 e5m2 operand tiles, both sides of one type, with an fp32 accumulator: the reference's
// operand_dtype branches (strassen_fused.py:474 _leaf_kernel, :533 _pipelined_kernel upcast
// each stored tile to fp32 before the signed sums).  72 instantiations: three types x two
// right-side layouts x tiles 64 and 128 x ring depths 1-4, and pair mode; and 24 of the
// batched launch's persistent kernel, three types x tiles 64 and 128 x ring depths 1-4.  The
// fp8 tiles travel by TMA as bytes and widen exactly through fp16 (cvt of e4m3 / e5m2 on
// sm_90); the product is the fp32 one of leaf_products.cu.
#include "leaf_products.cuh"

namespace {

KernelFn select(int l_dtype, int r_dtype, int acc, bool tri, bool pair, int tile, int stages) {
  if (acc != ACC_F32 || l_dtype != r_dtype) return nullptr;
  switch (l_dtype) {
    case F16: return by_layout<__half, __half, float>(tri, pair, tile, stages);
    case E4M3: return by_layout<__nv_fp8_e4m3, __nv_fp8_e4m3, float>(tri, pair, tile, stages);
    case E5M2: return by_layout<__nv_fp8_e5m2, __nv_fp8_e5m2, float>(tri, pair, tile, stages);
    default: return nullptr;
  }
}

BatchedFn select_batched(int dtype, int tile, int stages) {
  switch (dtype) {
    case F16: return batched_of<__half>(tile, stages);
    case E4M3: return batched_of<__nv_fp8_e4m3>(tile, stages);
    case E5M2: return batched_of<__nv_fp8_e5m2>(tile, stages);
    default: return nullptr;
  }
}

int ring_depth(int stages) { return stages; }

}  // namespace
