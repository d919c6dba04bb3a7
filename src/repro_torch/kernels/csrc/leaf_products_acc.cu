// leaf_products_acc.cu — the leaf program's kernel (leaf_products.cuh) with a bf16 or fp64
// accumulator: the reference's acc_dtype branches (strassen_fused.py:474 _leaf_kernel, :533
// _pipelined_kernel, whose VMEM accumulator is of acc_dtype and takes each step's fp32 dot
// rounded to it).  Both sides of one type, fp32, bf16, fp16, fp8 e4m3fn or e5m2.  The ring
// depth changes no bit, so one depth (STAGES) serves every request: 60 instantiations, two
// accumulators x five types x two right-side layouts x tiles 64 and 128, and pair mode.  Each
// K block's part is rounded into the accumulator at the K block's end; an op's first n_run
// slots keep their running sums in shared memory over its K blocks (leaf_products.cuh, PER_K),
// so that a kept destination is read and written once an op, the others once a K block.  At
// this depth the strassen gram's ring and sums (99.6 KB at tile 128) leave room for one fp64
// slot (128 KB) or every bf16 one (32 KB each).
#include "leaf_products.cuh"

namespace {

constexpr int STAGES = 2;

template <typename Acc>
KernelFn by_type(int dtype, bool tri, bool pair, int tile) {
  switch (dtype) {
    case F32: return by_layout<float, float, Acc, STAGES>(tri, pair, tile, STAGES);
    case BF16:
      return by_layout<__nv_bfloat16, __nv_bfloat16, Acc, STAGES>(tri, pair, tile, STAGES);
    case F16: return by_layout<__half, __half, Acc, STAGES>(tri, pair, tile, STAGES);
    case E4M3:
      return by_layout<__nv_fp8_e4m3, __nv_fp8_e4m3, Acc, STAGES>(tri, pair, tile, STAGES);
    case E5M2:
      return by_layout<__nv_fp8_e5m2, __nv_fp8_e5m2, Acc, STAGES>(tri, pair, tile, STAGES);
    default: return nullptr;
  }
}

KernelFn select(int l_dtype, int r_dtype, int acc, bool tri, bool pair, int tile, int stages) {
  if (l_dtype != r_dtype || stages < 1 || stages > 4) return nullptr;
  if (acc == ACC_BF16) return by_type<__nv_bfloat16>(l_dtype, tri, pair, tile);
  if (acc == ACC_F64) return by_type<double>(l_dtype, tri, pair, tile);
  return nullptr;
}

// The batched launch runs an fp32 accumulator only.
BatchedFn select_batched(int, int, int) { return nullptr; }

int ring_depth(int) { return STAGES; }

}  // namespace
