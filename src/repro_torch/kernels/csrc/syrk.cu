// syrk.cu — the packed lower-triangular A^t A of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/syrk.py:37 _syrk_kernel (launched by syrk_packed
// :54, pallas_call :82).  It computes what that kernel computes: for A (M, N) with
// M % bk == N % bn == 0 and T = N / bn, the stack of the T(T+1)/2 lower-triangular (bn, bn)
// tiles of A^t A in row-major triangular order, tile t = (i, j), i >= j, at stack rows
// [t*bn, (t+1)*bn): tile (i, j) = A[:, i-block]^t A[:, j-block], summed over M into an fp32
// accumulator and stored once.  A and the stack are each fp32, bf16 or fp16.  Diagonal tiles
// are stored whole, both halves, as the TPU kernel stores them (the sub-tiles above their
// diagonal are computed, not mirrored); upper tiles are never computed.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): 2 * M * bn^2 flops a
// tile, M * N * (N + bn) in all, on the fp32 CUDA cores at 67 TFLOP/s, against (M N + the
// stack) bytes at 3.35 TB/s: at N = M = 10240 the flops take 16 ms and the bytes 0.2 ms.  So
// it is bound by fp32 FMA, and at the recursion's 2560^2 leaf (55 tiles) by how many SMs its
// blocks keep busy.  The design is the shared tile product of tile_product.cuh: one block per
// (packed tile, TILE x TILE sub-tile), TILE 128 (8 x 8 outputs a thread, two blocks an SM) or
// 64, picked per launch by the host from the wave arithmetic (kernels/_launch.product_grid);
// both sides K-major straight from A (the transposed left side is a swap of load strides,
// never a copy), landing by cp.async in a 4-slot ring.  Neighbouring tiles read the same
// column blocks of A, which the 50 MB L2 serves.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include "tile_product.cuh"

namespace {

using namespace tile_product;

using Kernel = void (*)(const void*, void*, long long, long long, int);

// Packed lower-triangular index -> (i, j), i >= j, row-major: a root estimate in double with
// the integer correction of syrk._tri_decode (exact for every t a grid can reach).
__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  long long r = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if ((r + 1) * (r + 2) / 2 <= t) ++r;
  if (r * (r + 1) / 2 > t) --r;
  i = static_cast<int>(r);
  j = static_cast<int>(t - r * (r + 1) / 2);
}

template <int TILE, typename Ta, typename Tout>
__global__ void __launch_bounds__(THREADS, TILE == 128 ? 2 : 4)
    syrk_kernel(const void* a, void* out, long long m, long long n, int bn) {
  extern __shared__ __align__(16) float smem[];
  int ti, tj;
  tri_decode(blockIdx.x, ti, tj);
  int i0, j0, i_lim, j_lim;
  sub_tile<TILE>(blockIdx.y, bn, bn, i0, j0, i_lim, j_lim);
  const Ta* const base = static_cast<const Ta*>(a);
  Side<TILE, Ta, true> left(base, n, static_cast<long long>(ti) * bn + i0, i_lim);
  Side<TILE, Ta, true> right(base, n, static_cast<long long>(tj) * bn + j0, j_lim);
  float acc[Geometry<TILE>::R][Geometry<TILE>::R];
  product(left, right, m, smem, acc);
  store_tile<TILE>(static_cast<Tout*>(out), static_cast<long long>(blockIdx.x) * bn + i0, j0,
                   bn, i_lim, j_lim, acc);
}

template <int TILE, typename Ta>
Kernel by_out(int out_dtype) {
  if (out_dtype == F32) return syrk_kernel<TILE, Ta, float>;
  if (out_dtype == BF16) return syrk_kernel<TILE, Ta, __nv_bfloat16>;
  if (out_dtype == F16) return syrk_kernel<TILE, Ta, __half>;
  return nullptr;
}

template <int TILE>
Kernel by_a(int a_dtype, int out_dtype) {
  if (a_dtype == F32) return by_out<TILE, float>(out_dtype);
  if (a_dtype == BF16) return by_out<TILE, __nv_bfloat16>(out_dtype);
  if (a_dtype == F16) return by_out<TILE, __half>(out_dtype);
  return nullptr;
}

// The instantiation for these dtype codes and tile, or null.
Kernel pick(int a_dtype, int out_dtype, int tile) {
  if (tile == 128) return by_a<128>(a_dtype, out_dtype);
  if (tile == 64) return by_a<64>(a_dtype, out_dtype);
  return nullptr;
}

}  // namespace

extern "C" {

const char* syrk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block at `tile`.
int syrk_smem_bytes(int tile) { return static_cast<int>(smem_bytes(tile)); }

// Blocks of the instantiation an SM holds at once, or -1 for unknown codes or a CUDA error.
int syrk_blocks_per_sm(int a_dtype, int out_dtype, int tile) {
  return blocks_per_sm(pick(a_dtype, out_dtype, tile), tile);
}

// The packed stack of A^t A for a row-major A (m, n), m % bk == n % bn == 0, into `out`
// ((T(T+1)/2) * bn, bn), T = n / bn.  bk and bn: multiples of 8.  dtype codes: 0 fp32,
// 1 bf16, 2 fp16, A and the output alone.  tile: the block's sub-tile edge, 128 or 64.
int syrk_launch(const void* a, void* out, long long m, long long n, int bk, int bn,
                int a_dtype, int out_dtype, int tile, void* stream) {
  if (m < 1 || n < 1 || bk < 8 || bn < 8 || bk % 8 || bn % 8 || m % bk || n % bn)
    return cudaErrorInvalidValue;
  const Kernel kernel = pick(a_dtype, out_dtype, tile);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const long long t_blocks = n / bn;
  if (t_blocks * (t_blocks + 1) / 2 > 0x7fffffffLL || sub_tiles(bn, bn, tile) > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t err = prepare(kernel, tile);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(t_blocks * (t_blocks + 1) / 2),
                  static_cast<unsigned>(sub_tiles(bn, bn, tile)));
  kernel<<<grid, THREADS, smem_bytes(tile), static_cast<cudaStream_t>(stream)>>>(a, out, m, n,
                                                                                 bn);
  return cudaGetLastError();
}

}  // extern "C"
