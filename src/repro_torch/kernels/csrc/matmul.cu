// matmul.cu — the tiled matrix product of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:21 _matmul_kernel (launched by
// matmul_padded :37, pallas_call :54).  It computes what that kernel computes: for row-major
// A (M, K) and B (K, N) already padded to multiples of (bm, bk) and (bk, bn), C = A B, each
// (bm, bn) output tile summed over K into an fp32 accumulator and stored once in the output
// type.  A, B and C are each fp32, bf16 or fp16 (the TPU kernel's jnp.dot of 16-bit tiles with
// an fp32 accumulator: a product of 16-bit elements is exact in fp32).
//
// Two cores, chosen by the operand types alone (`core` below; kernels/_launch.product_core
// mirrors it), each one block per (output tile, TILE x TILE sub-tile), TILE 128 or 64 picked
// per launch by the host from the wave arithmetic (kernels/_launch.product_grid):
//   * A and B of one 16-bit type (bf16/bf16, fp16/fp16): the tensor-core core of
//     tile_product_tc.cuh.  What bounds it on an H100 SXM (data-sheet peaks at the 700 W
//     limit): 2 M K N flops at 989 TFLOP/s, and the L2 reads of 128 x 128 tiles (4 TILE bytes
//     a k step for 2 TILE^2 flops).  A (i x K) arrives K-major and B (K x j) N-major, each as
//     64 x 64 TMA boxes of the operand as it lies, through a 4-slot ring fed by one producer
//     warp; m64 n TILE k16 wgmma with fp32 accumulators in registers, two consumer warpgroups
//     at TILE 128, one at 64.  Its blocks run in a grouped order (grouped_sub_tile below), so
//     the blocks in flight share rows of A and columns of B in L2.  Refused or failed launches
//     raise: nothing falls back to the CUDA cores.
//   * every other pair (fp32, or types that differ): the fp32 CUDA-core core of
//     tile_product.cuh.  It is bound by fp32 FMA at 67 TFLOP/s (a 2560^3 leaf: 0.5 ms of
//     flops, 0.02 ms of bytes) and by how many of the 132 SMs its blocks keep busy (a 2560^2
//     leaf at blocks of 256 is 400 blocks of 128, 1.52 waves at two an SM).  B lands as it lies
//     (K x j) by cp.async into a 4-slot ring, A (i x K) through registers, transposed as it is
//     stored; a 16-bit side is widened to fp32 exactly.
// Blocks of one row of tiles read the same rows of A, which the 50 MB L2 serves.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include "tile_product.cuh"
#include "tile_product_tc.cuh"

namespace {

using namespace tile_product;
namespace tc = tile_product_tc;

using Kernel = void (*)(const void*, const void*, void*, long long, long long, int, int);
using TcKernel = void (*)(const CUtensorMap, const CUtensorMap, void*, long long, long long, int,
                          int);

// The core of a pair of operand codes: 1 the tensor cores (both bf16 or both fp16), 0 the fp32
// CUDA cores (any other pair of fp32, bf16 and fp16), -1 an unknown code.
int core(int a_dtype, int b_dtype) {
  const auto known = [](int d) { return d == F32 || d == BF16 || d == F16; };
  if (!known(a_dtype) || !known(b_dtype)) return -1;
  return a_dtype == b_dtype && a_dtype != F32 ? 1 : 0;
}

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
  if constexpr (std::is_same<Ta, Tb>::value && !std::is_same<Ta, float>::value) {
    return nullptr;     // the tensor-core core's pair: no CUDA-core instantiation
  } else {
    if (out_dtype == F32) return matmul_kernel<TILE, Ta, Tb, float>;
    if (out_dtype == BF16) return matmul_kernel<TILE, Ta, Tb, __nv_bfloat16>;
    if (out_dtype == F16) return matmul_kernel<TILE, Ta, Tb, __half>;
    return nullptr;
  }
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

// The CUDA-core instantiation for these dtype codes and tile, or null (also for a pair of the
// tensor-core core).
Kernel pick(int a_dtype, int b_dtype, int out_dtype, int tile) {
  if (tile == 128) return by_a<128>(a_dtype, b_dtype, out_dtype);
  if (tile == 64) return by_a<64>(a_dtype, b_dtype, out_dtype);
  return nullptr;
}

// Block `id` of a tensor-core launch (in launch order) -> its output tile (ti, tj) of the
// (n_ti, n_tj) grid and its sub-tile (origin, extent): the (n_ti ceil(bm / TILE)) x (n_tj
// ceil(bn / TILE)) grid of sub-tiles walked tc::RASTER rows at a time, column by column
// (kernels/_launch.grouped_sub_tile mirrors it).
template <int TILE>
__device__ __forceinline__ void grouped_sub_tile(long long id, long long n_ti, long long n_tj,
                                                 int bm, int bn, long long& ti, long long& tj,
                                                 int& i0, int& j0, int& i_lim, int& j_lim) {
  const int n_sub_i = (bm + TILE - 1) / TILE, n_sub_j = (bn + TILE - 1) / TILE;
  const long long rows = n_ti * n_sub_i, cols = n_tj * n_sub_j;
  const long long first = id / (tc::RASTER * cols) * tc::RASTER;
  const long long g_rows = min(static_cast<long long>(tc::RASTER), rows - first);
  const long long within = id - first * cols;
  const long long gi = first + within % g_rows, gj = within / g_rows;
  ti = gi / n_sub_i;
  tj = gj / n_sub_j;
  i0 = static_cast<int>(gi % n_sub_i) * TILE;
  j0 = static_cast<int>(gj % n_sub_j) * TILE;
  i_lim = min(TILE, bm - i0);
  j_lim = min(TILE, bn - j0);
}

// The tensor-core kernel: the sub-tile's rows of A (K-major) and columns of B (N-major) through
// their tensor maps, T their type.
template <int TILE, typename T, typename Tout>
__global__ void __launch_bounds__(tc::Geometry<TILE>::THREADS, tc::Geometry<TILE>::MIN_BLOCKS)
    matmul_tc_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap, void* out, long long k,
                     long long n, int bm, int bn) {
  extern __shared__ uint8_t smem_raw[];
  const long long n_tj = n / bn;
  long long ti, tj;
  int i0, j0, i_lim, j_lim;
  grouped_sub_tile<TILE>(blockIdx.x + static_cast<long long>(blockIdx.y) * gridDim.x,
                         gridDim.x / n_tj, n_tj, bm, bn, ti, tj, i0, j0, i_lim, j_lim);
  const long long row0 = ti * bm + i0, col0 = tj * bn + j0;
  float acc[TILE / 2];
  if (tc::product<TILE, T, true>(amap, static_cast<int>(row0), bmap, static_cast<int>(col0), k,
                                 smem_raw, acc))
    tc::store_tile<TILE>(static_cast<Tout*>(out), row0, col0, n, i_lim, j_lim, acc);
}

template <int TILE, typename T>
TcKernel tc_by_out(int out_dtype) {
  if (out_dtype == F32) return matmul_tc_kernel<TILE, T, float>;
  if (out_dtype == BF16) return matmul_tc_kernel<TILE, T, __nv_bfloat16>;
  if (out_dtype == F16) return matmul_tc_kernel<TILE, T, __half>;
  return nullptr;
}

// The tensor-core instantiation for operands of code `dtype` (bf16 or fp16), or null.
TcKernel pick_tc(int dtype, int out_dtype, int tile) {
  if (tile == 128 && dtype == BF16) return tc_by_out<128, __nv_bfloat16>(out_dtype);
  if (tile == 128 && dtype == F16) return tc_by_out<128, __half>(out_dtype);
  if (tile == 64 && dtype == BF16) return tc_by_out<64, __nv_bfloat16>(out_dtype);
  if (tile == 64 && dtype == F16) return tc_by_out<64, __half>(out_dtype);
  return nullptr;
}

cudaError_t launch_tc(const void* a, const void* b, void* out, long long m, long long k,
                      long long n, int bm, int bn, int dtype, int out_dtype, int tile,
                      cudaStream_t stream) {
  const TcKernel kernel = pick_tc(dtype, out_dtype, tile);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  const bool mapped = dtype == F16 ? tc::make_map<__half>(&amap, a, m, k) &&
                                         tc::make_map<__half>(&bmap, b, k, n)
                                   : tc::make_map<__nv_bfloat16>(&amap, a, m, k) &&
                                         tc::make_map<__nv_bfloat16>(&bmap, b, k, n);
  if (!mapped) return cudaErrorInvalidValue;
  const cudaError_t err = tc::prepare(kernel, tile);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m / bm) * (n / bn)),
                  static_cast<unsigned>(sub_tiles(bm, bn, tile)));
  kernel<<<grid, tc::threads(tile), tc::smem_bytes(tile), stream>>>(amap, bmap, out, k, n, bm,
                                                                    bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The core that runs a pair of operand codes: 1 the tensor cores, 0 the CUDA cores, -1 unknown.
int matmul_core(int a_dtype, int b_dtype) { return core(a_dtype, b_dtype); }

// Dynamic shared memory of one block of the pair's core at `tile` (0 for unknown codes or tile).
int matmul_smem_bytes(int a_dtype, int b_dtype, int tile) {
  if (tile != 128 && tile != 64) return 0;
  const int c = core(a_dtype, b_dtype);
  return c == 1 ? tc::smem_bytes(tile) : c == 0 ? static_cast<int>(smem_bytes(tile)) : 0;
}

// Blocks of the instantiation an SM holds at once, or -1 for unknown codes or a CUDA error.
int matmul_blocks_per_sm(int a_dtype, int b_dtype, int out_dtype, int tile) {
  if (core(a_dtype, b_dtype) == 1)
    return tc::blocks_per_sm(pick_tc(a_dtype, out_dtype, tile), tile);
  return blocks_per_sm(pick(a_dtype, b_dtype, out_dtype, tile), tile);
}

// C = A B for row-major A (m, k), B (k, n), C (m, n), with m % bm == k % bk == n % bn == 0.
// bm, bk and bn: multiples of 8.  dtype codes: 0 fp32, 1 bf16, 2 fp16, each side and the
// output alone; A and B of one 16-bit type run the tensor-core core (2 x 3 types at each
// tile), any other pair the CUDA-core core (7 x 3).  tile: the block's sub-tile edge, 128 or
// 64.
int matmul_launch(const void* a, const void* b, void* out, long long m, long long k,
                  long long n, int bm, int bk, int bn, int a_dtype, int b_dtype, int out_dtype,
                  int tile, void* stream) {
  if (m < 1 || k < 1 || n < 1 || bm < 8 || bk < 8 || bn < 8 || bm % 8 || bk % 8 || bn % 8 ||
      m % bm || k % bk || n % bn)
    return cudaErrorInvalidValue;
  if ((tile != 128 && tile != 64) || (m / bm) * (n / bn) > 0x7fffffffLL ||
      sub_tiles(bm, bn, tile) > 65535)
    return cudaErrorInvalidValue;
  const int c = core(a_dtype, b_dtype);
  if (c == 1) {
    // TMA coordinates are 32-bit
    if (m > 0x7fffffffLL || k > 0x7fffffffLL || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    return launch_tc(a, b, out, m, k, n, bm, bn, a_dtype, out_dtype, tile,
                     static_cast<cudaStream_t>(stream));
  }
  const Kernel kernel = pick(a_dtype, b_dtype, out_dtype, tile);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(kernel, tile);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m / bm) * (n / bn)),
                  static_cast<unsigned>(sub_tiles(bm, bn, tile)));
  kernel<<<grid, THREADS, smem_bytes(tile), static_cast<cudaStream_t>(stream)>>>(
      a, b, out, k, n, bm, bn);
  return cudaGetLastError();
}

}  // extern "C"
