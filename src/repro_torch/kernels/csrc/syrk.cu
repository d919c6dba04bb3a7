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
// Two cores, chosen by A's type alone (`core` below; kernels/_launch.product_core mirrors it),
// each one block per (packed tile, TILE x TILE sub-tile), TILE 128 or 64 picked per launch by
// the host from the wave arithmetic (kernels/_launch.product_grid).  Both sides are columns of
// A read as they lie, at two column origins: the transposed left side is never a copy.
//   * bf16 or fp16 A: the tensor-core core of tile_product_tc.cuh.  What bounds it on an H100
//     SXM (data-sheet peaks at the 700 W limit): 2 M bn^2 flops a tile, M N (N + bn) in all, at
//     989 TFLOP/s (at N = M = 10240, 1.1 ms), and the L2 reads of 128 x 128 tiles.  Both sides
//     arrive as 64 x 64 TMA boxes of A, M- and N-major (wgmma's transpose bits), through a
//     4-slot ring fed by one producer warp; m64 n TILE k16 wgmma with fp32 accumulators.  Its
//     blocks run in a grouped order (grouped_packed_tile below).  Refused or failed launches
//     raise: nothing falls back to the CUDA cores.
//   * fp32 A: the fp32 CUDA-core core of tile_product.cuh, bound by fp32 FMA at 67 TFLOP/s (at
//     N = M = 10240 the flops take 16 ms and the bytes 0.2 ms) and, at the recursion's 2560^2
//     leaf (55 tiles), by how many SMs its blocks keep busy; both sides land by cp.async in a
//     4-slot ring.
// Neighbouring tiles read the same column blocks of A, which the 50 MB L2 serves.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include "tile_product.cuh"
#include "tile_product_tc.cuh"

namespace {

using namespace tile_product;
namespace tc = tile_product_tc;

using Kernel = void (*)(const void*, void*, long long, long long, int);
using TcKernel = void (*)(const CUtensorMap, void*, long long, int, int);

// The core of A's dtype code: 1 the tensor cores (bf16, fp16), 0 the fp32 CUDA cores (fp32),
// -1 an unknown code.
int core(int a_dtype) {
  return a_dtype == BF16 || a_dtype == F16 ? 1 : a_dtype == F32 ? 0 : -1;
}

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

// The CUDA-core instantiation (fp32 A) for these dtype codes and tile, or null.
Kernel pick(int a_dtype, int out_dtype, int tile) {
  if (a_dtype != F32) return nullptr;
  if (tile == 128) return by_out<128, float>(out_dtype);
  if (tile == 64) return by_out<64, float>(out_dtype);
  return nullptr;
}

// Block `id` of a tensor-core launch (in launch order) over T = t_blocks tile rows -> its packed
// tile (ti, tj), ti >= tj, and the index of its sub-tile: the sub-tiles of a packed tile run
// together, and the packed tiles are walked G = max(1, tc::RASTER / ceil(bn / TILE)) tile rows
// at a time, column by column (kernels/syrk._grouped_packed_tile mirrors it).  A group of rows
// [first, first + rows) holds first * rows tiles left of its diagonal block, then columns of
// rows, rows - 1, ..., 1 tiles.
template <int TILE>
__device__ __forceinline__ void grouped_packed_tile(long long id, int t_blocks, int bn, int& ti,
                                                    int& tj, int& sub) {
  const int n_sub = (bn + TILE - 1) / TILE;
  const long long p = id / (n_sub * n_sub);
  sub = static_cast<int>(id % (n_sub * n_sub));
  const int g = max(1, tc::RASTER / n_sub);
  int row, col;
  tri_decode(p, row, col);
  const int first = row / g * g, rows = min(g, t_blocks - first);
  long long w = p - static_cast<long long>(first) * (first + 1) / 2;
  if (w < static_cast<long long>(first) * rows) {
    tj = static_cast<int>(w / rows);
    ti = first + static_cast<int>(w % rows);
  } else {
    w -= static_cast<long long>(first) * rows;
    int c = 0;
    while (w >= rows - c) {
      w -= rows - c;
      ++c;
    }
    tj = first + c;
    ti = tj + static_cast<int>(w);
  }
}

// The tensor-core kernel: both sides columns of A through one tensor map, T its type.
template <int TILE, typename T, typename Tout>
__global__ void __launch_bounds__(tc::Geometry<TILE>::THREADS, tc::Geometry<TILE>::MIN_BLOCKS)
    syrk_tc_kernel(const __grid_constant__ CUtensorMap amap, void* out, long long m, int t_blocks,
                   int bn) {
  extern __shared__ uint8_t smem_raw[];
  int ti, tj, sub;
  grouped_packed_tile<TILE>(blockIdx.x + static_cast<long long>(blockIdx.y) * gridDim.x,
                            t_blocks, bn, ti, tj, sub);
  int i0, j0, i_lim, j_lim;
  sub_tile<TILE>(sub, bn, bn, i0, j0, i_lim, j_lim);
  const long long t = static_cast<long long>(ti) * (ti + 1) / 2 + tj;   // its place in the stack
  float acc[TILE / 2];
  if (tc::product<TILE, T, false>(amap, ti * bn + i0, amap, tj * bn + j0, m, smem_raw, acc))
    tc::store_tile<TILE>(static_cast<Tout*>(out), t * bn + i0, j0, bn, i_lim, j_lim, acc);
}

template <int TILE, typename T>
TcKernel tc_by_out(int out_dtype) {
  if (out_dtype == F32) return syrk_tc_kernel<TILE, T, float>;
  if (out_dtype == BF16) return syrk_tc_kernel<TILE, T, __nv_bfloat16>;
  if (out_dtype == F16) return syrk_tc_kernel<TILE, T, __half>;
  return nullptr;
}

// The tensor-core instantiation for A of code `a_dtype` (bf16 or fp16), or null.
TcKernel pick_tc(int a_dtype, int out_dtype, int tile) {
  if (tile == 128 && a_dtype == BF16) return tc_by_out<128, __nv_bfloat16>(out_dtype);
  if (tile == 128 && a_dtype == F16) return tc_by_out<128, __half>(out_dtype);
  if (tile == 64 && a_dtype == BF16) return tc_by_out<64, __nv_bfloat16>(out_dtype);
  if (tile == 64 && a_dtype == F16) return tc_by_out<64, __half>(out_dtype);
  return nullptr;
}

cudaError_t launch_tc(const void* a, void* out, long long m, long long n, int bn, int a_dtype,
                      int out_dtype, int tile, cudaStream_t stream) {
  const TcKernel kernel = pick_tc(a_dtype, out_dtype, tile);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  CUtensorMap amap;
  const bool mapped = a_dtype == F16 ? tc::make_map<__half>(&amap, a, m, n)
                                     : tc::make_map<__nv_bfloat16>(&amap, a, m, n);
  if (!mapped) return cudaErrorInvalidValue;
  const cudaError_t err = tc::prepare(kernel, tile);
  if (err != cudaSuccess) return err;
  const long long t_blocks = n / bn;
  const dim3 grid(static_cast<unsigned>(t_blocks * (t_blocks + 1) / 2),
                  static_cast<unsigned>(sub_tiles(bn, bn, tile)));
  kernel<<<grid, tc::threads(tile), tc::smem_bytes(tile), stream>>>(
      amap, out, m, static_cast<int>(t_blocks), bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* syrk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The core that runs A of this dtype code: 1 the tensor cores, 0 the CUDA cores, -1 unknown.
int syrk_core(int a_dtype) { return core(a_dtype); }

// Dynamic shared memory of one block of A's core at `tile` (0 for an unknown code or tile).
int syrk_smem_bytes(int a_dtype, int tile) {
  if (tile != 128 && tile != 64) return 0;
  const int c = core(a_dtype);
  return c == 1 ? tc::smem_bytes(tile) : c == 0 ? static_cast<int>(smem_bytes(tile)) : 0;
}

// Blocks of the instantiation an SM holds at once, or -1 for unknown codes or a CUDA error.
int syrk_blocks_per_sm(int a_dtype, int out_dtype, int tile) {
  if (core(a_dtype) == 1) return tc::blocks_per_sm(pick_tc(a_dtype, out_dtype, tile), tile);
  return blocks_per_sm(pick(a_dtype, out_dtype, tile), tile);
}

// The packed stack of A^t A for a row-major A (m, n), m % bk == n % bn == 0, into `out`
// ((T(T+1)/2) * bn, bn), T = n / bn.  bk and bn: multiples of 8.  dtype codes: 0 fp32,
// 1 bf16, 2 fp16, A and the output alone; bf16 and fp16 A run the tensor-core core, fp32 A
// the CUDA-core core (each 3 output types at each tile).  tile: the block's sub-tile edge,
// 128 or 64.
int syrk_launch(const void* a, void* out, long long m, long long n, int bk, int bn,
                int a_dtype, int out_dtype, int tile, void* stream) {
  if (m < 1 || n < 1 || bk < 8 || bn < 8 || bk % 8 || bn % 8 || m % bk || n % bn ||
      (tile != 128 && tile != 64))
    return cudaErrorInvalidValue;
  const long long t_blocks = n / bn;
  if (t_blocks * (t_blocks + 1) / 2 > 0x7fffffffLL || sub_tiles(bn, bn, tile) > 65535)
    return cudaErrorInvalidValue;
  if (core(a_dtype) == 1) {
    // TMA coordinates are 32-bit
    if (m > 0x7fffffffLL || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    return launch_tc(a, out, m, n, bn, a_dtype, out_dtype, tile,
                     static_cast<cudaStream_t>(stream));
  }
  const Kernel kernel = pick(a_dtype, out_dtype, tile);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(kernel, tile);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(t_blocks * (t_blocks + 1) / 2),
                  static_cast<unsigned>(sub_tiles(bn, bn, tile)));
  kernel<<<grid, THREADS, smem_bytes(tile), static_cast<cudaStream_t>(stream)>>>(a, out, m, n,
                                                                                 bn);
  return cudaGetLastError();
}

}  // extern "C"
