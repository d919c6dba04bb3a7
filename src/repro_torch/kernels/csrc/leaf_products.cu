// leaf_products.cu — the leaf program's kernel (leaf_products.cuh) over fp32 and bf16 operand
// tiles, either side, with an fp32 accumulator: the main path's library.  80 instantiations:
// four operand pairs x two right-side layouts x tiles 64 and 128 x ring depths 1-4, and pair
// mode for the two same-type pairs; and 16 of the batched launch's persistent kernel, fp32
// and bf16 x tiles 64 and 128 x ring depths 1-4.
#include "leaf_products.cuh"

namespace {

template <typename Tl>
KernelFn by_right(int r_dtype, bool tri, bool pair, int tile, int stages) {
  if (r_dtype == F32) return by_layout<Tl, float, float>(tri, pair, tile, stages);
  if (r_dtype == BF16) return by_layout<Tl, __nv_bfloat16, float>(tri, pair, tile, stages);
  return nullptr;
}

KernelFn select(int l_dtype, int r_dtype, int acc, bool tri, bool pair, int tile, int stages) {
  if (acc != ACC_F32) return nullptr;
  if (l_dtype == F32) return by_right<float>(r_dtype, tri, pair, tile, stages);
  if (l_dtype == BF16) return by_right<__nv_bfloat16>(r_dtype, tri, pair, tile, stages);
  return nullptr;
}

BatchedFn select_batched(int dtype, int tile, int stages) {
  if (dtype == F32) return batched_of<float>(tile, stages);
  if (dtype == BF16) return batched_of<__nv_bfloat16>(tile, stages);
  return nullptr;
}

int ring_depth(int stages) { return stages; }

}  // namespace
