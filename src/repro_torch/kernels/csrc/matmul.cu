// matmul.cu — the tiled matrix product of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:21 _matmul_kernel (launched by
// matmul_padded :37, pallas_call :54).  It computes what that kernel computes: for row-major
// A (M, K) and B (K, N) already padded to multiples of (bm, bk) and (bk, bn), C = A B, each
// (bm, bn) output tile summed over the K / bk blocks into an fp32 accumulator and stored once
// in the output type.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): 2 M K N flops on the
// fp32 CUDA cores at 67 TFLOP/s, against (M K + K N + M N) elements at 3.35 TB/s: a 2560^3
// leaf of the reference recursion takes 0.5 ms of flops and 0.02 ms of bytes, so it is bound
// by fp32 FMA.  The design is the shared tile product of tile_product.cuh: one block per
// (output tile, 64 x 64 sub-tile), A read as it lies (i x K), B as it lies (K x j), K staged
// in chunks of 16.  Blocks of one row of tiles read the same rows of A, which the 50 MB L2
// serves.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include "tile_product.cuh"

namespace {

using namespace tile_product;

template <typename Ta, typename Tb, typename Tout>
__global__ void __launch_bounds__(THREADS) matmul_kernel(const Ta* a, const Tb* b, Tout* out,
                                                         long long k, long long n, int bm,
                                                         int bk, int bn) {
  const long long n_tj = n / bn;
  const long long ti = blockIdx.x / n_tj, tj = blockIdx.x % n_tj;
  const int n_sub_j = (bn + TILE - 1) / TILE;
  const int i0 = (blockIdx.y / n_sub_j) * TILE, j0 = (blockIdx.y % n_sub_j) * TILE;
  const int i_lim = min(TILE, bm - i0), j_lim = min(TILE, bn - j0);
  const Side<Ta> left{a, k, ti * bm + i0, i_lim, false};
  const Side<Tb> right{b, n, tj * bn + j0, j_lim, true};
  float acc[4][4];
  product(left, right, static_cast<int>(k / bk), bk, acc);
  store_tile(out, ti * bm + i0, tj * bn + j0, n, i_lim, j_lim, acc);
}

template <typename Ta, typename Tb, typename Tout>
cudaError_t launch(const void* a, const void* b, void* out, long long m, long long k,
                   long long n, int bm, int bk, int bn, cudaStream_t stream) {
  const int n_sub_i = (bm + TILE - 1) / TILE, n_sub_j = (bn + TILE - 1) / TILE;
  const dim3 grid(static_cast<unsigned>((m / bm) * (n / bn)), n_sub_i * n_sub_j);
  matmul_kernel<Ta, Tb, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Ta*>(a), static_cast<const Tb*>(b), static_cast<Tout*>(out), k, n, bm,
      bk, bn);
  return cudaGetLastError();
}

template <typename Ta, typename Tb>
cudaError_t by_out(int out_dtype, const void* a, const void* b, void* out, long long m,
                   long long k, long long n, int bm, int bk, int bn, cudaStream_t s) {
  if (out_dtype == F32) return launch<Ta, Tb, float>(a, b, out, m, k, n, bm, bk, bn, s);
  if (out_dtype == BF16) return launch<Ta, Tb, __nv_bfloat16>(a, b, out, m, k, n, bm, bk, bn, s);
  return cudaErrorInvalidValue;
}

template <typename Ta>
cudaError_t by_b(int b_dtype, int out_dtype, const void* a, const void* b, void* out,
                 long long m, long long k, long long n, int bm, int bk, int bn, cudaStream_t s) {
  if (b_dtype == F32) return by_out<Ta, float>(out_dtype, a, b, out, m, k, n, bm, bk, bn, s);
  if (b_dtype == BF16)
    return by_out<Ta, __nv_bfloat16>(out_dtype, a, b, out, m, k, n, bm, bk, bn, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C = A B for row-major A (m, k), B (k, n), C (m, n), with m % bm == k % bk == n % bn == 0.
// bm, bk and bn: multiples of 8.  dtype codes: 0 fp32, 1 bf16.
int matmul_launch(const void* a, const void* b, void* out, long long m, long long k,
                  long long n, int bm, int bk, int bn, int a_dtype, int b_dtype, int out_dtype,
                  void* stream) {
  if (m < 1 || k < 1 || n < 1 || bm < 8 || bk < 8 || bn < 8 || bm % 8 || bk % 8 || bn % 8 ||
      m % bm || k % bk || n % bn)
    return cudaErrorInvalidValue;
  const long long n_sub = static_cast<long long>((bm + TILE - 1) / TILE) * ((bn + TILE - 1) / TILE);
  if ((m / bm) * (n / bn) > 0x7fffffffLL || n_sub > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == F32) return by_b<float>(b_dtype, out_dtype, a, b, out, m, k, n, bm, bk, bn, s);
  if (a_dtype == BF16)
    return by_b<__nv_bfloat16>(b_dtype, out_dtype, a, b, out, m, k, n, bm, bk, bn, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
