// syrk.cu — the packed lower-triangular A^t A of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/syrk.py:37 _syrk_kernel (launched by syrk_packed
// :54, pallas_call :82).  It computes what that kernel computes: for A (M, N) with
// M % bk == N % bn == 0 and T = N / bn, the stack of the T(T+1)/2 lower-triangular (bn, bn)
// tiles of A^t A in row-major triangular order, tile t = (i, j), i >= j, at stack rows
// [t*bn, (t+1)*bn): tile (i, j) = A[:, i-block]^t A[:, j-block], summed over the M / bk K
// blocks into an fp32 accumulator and stored once.  Diagonal tiles are stored whole, both
// halves, as the TPU kernel stores them; upper tiles are never computed.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): 2 * M * bn^2 flops a
// tile, M * N * (N + bn) in all, on the fp32 CUDA cores at 67 TFLOP/s, against (M N + the
// stack) bytes at 3.35 TB/s: at N = M = 10240 the flops take 16 ms and the bytes 0.2 ms.  So
// it is bound by fp32 FMA, and the design is the shared tile product of tile_product.cuh:
// one block per (packed tile, 64 x 64 sub-tile), both sides read K-major straight from A (the
// transposed left side is a swap of load strides, never a copy), K staged in chunks of 16.
// Neighbouring tiles read the same column blocks of A, which the 50 MB L2 serves.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include "tile_product.cuh"

namespace {

using namespace tile_product;

// Packed lower-triangular index -> (i, j), i >= j, row-major: a root estimate in double with
// the integer correction of syrk._tri_decode (exact for every t a grid can reach).
__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  long long r = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if ((r + 1) * (r + 2) / 2 <= t) ++r;
  if (r * (r + 1) / 2 > t) --r;
  i = static_cast<int>(r);
  j = static_cast<int>(t - r * (r + 1) / 2);
}

template <typename Ta, typename Tout>
__global__ void __launch_bounds__(THREADS) syrk_kernel(const Ta* a, Tout* out, long long m,
                                                       long long n, int bk, int bn) {
  int ti, tj;
  tri_decode(blockIdx.x, ti, tj);
  const int n_sub = (bn + TILE - 1) / TILE;
  const int i0 = (blockIdx.y / n_sub) * TILE, j0 = (blockIdx.y % n_sub) * TILE;
  const int i_lim = min(TILE, bn - i0), j_lim = min(TILE, bn - j0);
  const Side<Ta> left{a, n, static_cast<long long>(ti) * bn + i0, i_lim, true};
  const Side<Ta> right{a, n, static_cast<long long>(tj) * bn + j0, j_lim, true};
  float acc[4][4];
  product(left, right, static_cast<int>(m / bk), bk, acc);
  store_tile(out, static_cast<long long>(blockIdx.x) * bn + i0, j0, bn, i_lim, j_lim, acc);
}

template <typename Ta, typename Tout>
cudaError_t launch(const void* a, void* out, long long m, long long n, int bk, int bn,
                   cudaStream_t stream) {
  const long long t_blocks = n / bn;
  const int n_sub = (bn + TILE - 1) / TILE;
  const dim3 grid(static_cast<unsigned>(t_blocks * (t_blocks + 1) / 2), n_sub * n_sub);
  syrk_kernel<Ta, Tout><<<grid, THREADS, 0, stream>>>(static_cast<const Ta*>(a),
                                                       static_cast<Tout*>(out), m, n, bk, bn);
  return cudaGetLastError();
}

template <typename Ta>
cudaError_t by_out(int out_dtype, const void* a, void* out, long long m, long long n, int bk,
                   int bn, cudaStream_t s) {
  if (out_dtype == F32) return launch<Ta, float>(a, out, m, n, bk, bn, s);
  if (out_dtype == BF16) return launch<Ta, __nv_bfloat16>(a, out, m, n, bk, bn, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* syrk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The packed stack of A^t A for a row-major A (m, n), m % bk == n % bn == 0, into `out`
// ((T(T+1)/2) * bn, bn), T = n / bn.  bk and bn: multiples of 8.  dtype codes: 0 fp32,
// 1 bf16.
int syrk_launch(const void* a, void* out, long long m, long long n, int bk, int bn,
                int a_dtype, int out_dtype, void* stream) {
  if (m < 1 || n < 1 || bk < 8 || bn < 8 || bk % 8 || bn % 8 || m % bk || n % bn)
    return cudaErrorInvalidValue;
  const long long t_blocks = n / bn, n_sub = (bn + TILE - 1) / TILE;
  if (t_blocks * (t_blocks + 1) / 2 > 0x7fffffffLL || n_sub * n_sub > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == F32) return by_out<float>(out_dtype, a, out, m, n, bk, bn, s);
  if (a_dtype == BF16) return by_out<__nv_bfloat16>(out_dtype, a, out, m, n, bk, bn, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
