// matmul.cu — the tiled matrix product of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:21 _matmul_kernel (launched by
// matmul_padded :37, pallas_call :54).  It computes what that kernel computes: for row-major
// A (M, K) and B (K, N) already padded to multiples of (bm, bk) and (bk, bn), C = A B, each
// (bm, bn) output tile summed over K into an fp32 accumulator and stored once in the output
// type.  A, B and C are each fp32, bf16 or fp16 (the TPU kernel's jnp.dot of 16-bit tiles with
// an fp32 accumulator: a 16-bit element widens to fp32 exactly).
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): 2 M K N flops on the
// fp32 CUDA cores at 67 TFLOP/s, against (M K + K N + M N) elements at 3.35 TB/s: a 2560^3
// leaf of the reference recursion takes 0.5 ms of flops and 0.02 ms of bytes, so it is bound
// by fp32 FMA, and by how many of the card's 132 SMs its blocks keep busy.  The design is the
// shared tile product of tile_product.cuh: one block per (output tile, TILE x TILE sub-tile),
// TILE 128 (8 x 8 outputs a thread, two blocks an SM) or 64, picked per launch by the host
// from the wave arithmetic (kernels/_launch.product_grid: a 2560^2 leaf at blocks of 256 is
// 400 blocks of 128, 1.52 waves at two an SM); B lands as it lies (K x j) by cp.async into
// a 4-slot ring, A (i x K) through registers, transposed as it is stored.  Blocks of one row
// of tiles read the same rows of A, which the 50 MB L2 serves.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include "tile_product.cuh"

namespace {

using namespace tile_product;

using Kernel = void (*)(const void*, const void*, void*, long long, long long, int, int);

template <int TILE, typename Ta, typename Tb, typename Tout>
__global__ void __launch_bounds__(THREADS, TILE == 128 ? 2 : 4)
    matmul_kernel(const void* a, const void* b, void* out, long long k, long long n, int bm,
                  int bn) {
  extern __shared__ __align__(16) float smem[];
  const long long n_tj = n / bn;
  const long long ti = blockIdx.x / n_tj, tj = blockIdx.x % n_tj;
  int i0, j0, i_lim, j_lim;
  sub_tile<TILE>(blockIdx.y, bm, bn, i0, j0, i_lim, j_lim);
  Side<TILE, Ta, false> left(static_cast<const Ta*>(a), k, ti * bm + i0, i_lim);
  Side<TILE, Tb, true> right(static_cast<const Tb*>(b), n, tj * bn + j0, j_lim);
  float acc[Geometry<TILE>::R][Geometry<TILE>::R];
  product(left, right, k, smem, acc);
  store_tile<TILE>(static_cast<Tout*>(out), ti * bm + i0, tj * bn + j0, n, i_lim, j_lim, acc);
}

template <int TILE, typename Ta, typename Tb>
Kernel by_out(int out_dtype) {
  if (out_dtype == F32) return matmul_kernel<TILE, Ta, Tb, float>;
  if (out_dtype == BF16) return matmul_kernel<TILE, Ta, Tb, __nv_bfloat16>;
  if (out_dtype == F16) return matmul_kernel<TILE, Ta, Tb, __half>;
  return nullptr;
}

template <int TILE, typename Ta>
Kernel by_b(int b_dtype, int out_dtype) {
  if (b_dtype == F32) return by_out<TILE, Ta, float>(out_dtype);
  if (b_dtype == BF16) return by_out<TILE, Ta, __nv_bfloat16>(out_dtype);
  if (b_dtype == F16) return by_out<TILE, Ta, __half>(out_dtype);
  return nullptr;
}

template <int TILE>
Kernel by_a(int a_dtype, int b_dtype, int out_dtype) {
  if (a_dtype == F32) return by_b<TILE, float>(b_dtype, out_dtype);
  if (a_dtype == BF16) return by_b<TILE, __nv_bfloat16>(b_dtype, out_dtype);
  if (a_dtype == F16) return by_b<TILE, __half>(b_dtype, out_dtype);
  return nullptr;
}

// The instantiation for these dtype codes and tile, or null.
Kernel pick(int a_dtype, int b_dtype, int out_dtype, int tile) {
  if (tile == 128) return by_a<128>(a_dtype, b_dtype, out_dtype);
  if (tile == 64) return by_a<64>(a_dtype, b_dtype, out_dtype);
  return nullptr;
}

}  // namespace

extern "C" {

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block at `tile`.
int matmul_smem_bytes(int tile) { return static_cast<int>(smem_bytes(tile)); }

// Blocks of the instantiation an SM holds at once, or -1 for unknown codes or a CUDA error.
int matmul_blocks_per_sm(int a_dtype, int b_dtype, int out_dtype, int tile) {
  return blocks_per_sm(pick(a_dtype, b_dtype, out_dtype, tile), tile);
}

// C = A B for row-major A (m, k), B (k, n), C (m, n), with m % bm == k % bk == n % bn == 0.
// bm, bk and bn: multiples of 8.  dtype codes: 0 fp32, 1 bf16, 2 fp16, each side and the
// output alone (3 x 3 x 3 types at each tile).  tile: the block's sub-tile edge, 128 or 64.
int matmul_launch(const void* a, const void* b, void* out, long long m, long long k,
                  long long n, int bm, int bk, int bn, int a_dtype, int b_dtype, int out_dtype,
                  int tile, void* stream) {
  if (m < 1 || k < 1 || n < 1 || bm < 8 || bk < 8 || bn < 8 || bm % 8 || bk % 8 || bn % 8 ||
      m % bm || k % bk || n % bn)
    return cudaErrorInvalidValue;
  const Kernel kernel = pick(a_dtype, b_dtype, out_dtype, tile);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if ((m / bm) * (n / bn) > 0x7fffffffLL || sub_tiles(bm, bn, tile) > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t err = prepare(kernel, tile);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m / bm) * (n / bn)),
                  static_cast<unsigned>(sub_tiles(bm, bn, tile)));
  kernel<<<grid, THREADS, smem_bytes(tile), static_cast<cudaStream_t>(stream)>>>(
      a, b, out, k, n, bm, bn);
  return cudaGetLastError();
}

}  // extern "C"
