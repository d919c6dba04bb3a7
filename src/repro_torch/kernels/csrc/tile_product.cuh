// tile_product.cuh — the shared-memory-tiled fp32 product behind the port's syrk and matmul
// kernels (csrc/syrk.cu, csrc/matmul.cu).
//
// One thread block computes one 64 x 64 sub-tile of an output tile: for the thread's 4 x 4
// outputs (x, y),
//   acc[x][y] = sum over K blocks kb of ( sum over k in block kb of L(x, k) * R(k, y) ),
// each K block's partial sum added to acc once, as the TPU kernels add one jnp.dot per K grid
// step to their fp32 accumulator.  A side is read as it lies in memory: "k-major" (stored
// K x TILE, element (x, k) at base[k * ld + x0 + x]: A[:, i] of syrk, B of matmul) or
// "x-major" (stored TILE x K, element at base[(x0 + x) * ld + k]: A of matmul).  Only the load
// strides differ; every chunk lands in shared memory as [k][x] in fp32, so the multiply loop
// is one code path for both.
//
// What bounds it: fp32 FMA on the CUDA cores (no tensor cores, no TF32), 67 TFLOP/s on an
// H100 SXM at 700 W; each output element needs 2K flops against 8K bytes of operands, and the
// 64 x 64 sub-tile reuses each staged element 64 times.  The design: 256 threads, 4 x 4
// outputs each; K staged in chunks of KC = 16, double-buffered through registers (the next
// chunk's global loads are in flight while the current one is multiplied), one barrier per
// chunk.  Larger register tiles, cp.async or TMA rings and wgmma are later work.
//
// Shape contract (checked by the C entries and the Python wrappers): the tile edges and the
// K block are multiples of 8, so every 4-element vector lies wholly inside or outside a tile,
// and the row strides are multiples of 8, so vectors are 16-byte (fp32) or 8-byte (bf16)
// aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_product {

constexpr int TILE = 64;           // sub-tile edge along x (rows) and y (columns)
constexpr int KC = 16;             // contraction depth of one staged chunk
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDS = TILE + 4;      // shared row length: keeps float4 alignment

// dtype codes of the C interfaces
enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One side of the product, cut to one sub-tile.
template <typename T>
struct Side {
  const T* base;
  long long ld;     // row stride, in elements
  long long x0;     // first x (row of the output sub-tile, or column) this sub-tile reads
  int x_lim;        // valid x of the sub-tile: the tile's edge past x0, at most TILE
  bool k_major;     // stored K x TILE (else TILE x K)
};

// The 4 elements one thread stages from a KC x TILE chunk starting at depth k0, of which the
// first k_lim rows are valid; zero where masked.  Returns them with the [k][x] slot of the
// first one: k-major, 4 consecutive x at one k; x-major, 4 consecutive k at one x.
template <typename T>
__device__ __forceinline__ float4 fetch(const Side<T>& s, long long k0, int k_lim, int& k,
                                        int& x) {
  const int tid = threadIdx.x;
  if (s.k_major) {
    k = tid / (TILE / 4);
    x = (tid % (TILE / 4)) * 4;
  } else {
    x = tid / (KC / 4);
    k = (tid % (KC / 4)) * 4;
  }
  if (k >= k_lim || x >= s.x_lim) return make_float4(0.f, 0.f, 0.f, 0.f);
  return s.k_major ? load4(s.base + (k0 + k) * s.ld + s.x0 + x)
                   : load4(s.base + (s.x0 + x) * s.ld + k0 + k);
}

__device__ __forceinline__ void stage(float (*dst)[LDS], bool k_major, float4 v, int k, int x) {
  if (k_major) {
    *reinterpret_cast<float4*>(&dst[k][x]) = v;
  } else {
    dst[k][x] = v.x;
    dst[k + 1][x] = v.y;
    dst[k + 2][x] = v.z;
    dst[k + 3][x] = v.w;
  }
}

// acc = sum over n_kb K blocks of bk of L(x, k) R(k, y) for this thread's 4 x 4 outputs
// (rows ty*4.., columns tx*4.. of the sub-tile).  Every thread of the block must call it.
template <typename Tl, typename Tr>
__device__ void product(const Side<Tl>& L, const Side<Tr>& R, int n_kb, int bk,
                        float (&acc)[4][4]) {
  __shared__ __align__(16) float ls[2][KC][LDS];
  __shared__ __align__(16) float rs[2][KC][LDS];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_kc = (bk + KC - 1) / KC;
  const int n_steps = n_kb * n_kc;
  float part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  // step s: K block s / n_kc, chunk (s % n_kc) * KC of it
  auto fetch_step = [&](int s, float4& lv, int& lk, int& lx, float4& rv, int& rk, int& rx) {
    const int kc = (s % n_kc) * KC;
    const long long k0 = static_cast<long long>(s / n_kc) * bk + kc;
    lv = fetch(L, k0, bk - kc, lk, lx);
    rv = fetch(R, k0, bk - kc, rk, rx);
  };
  float4 lv, rv;
  int lk, lx, rk, rx;
  if (n_steps > 0) {
    fetch_step(0, lv, lk, lx, rv, rk, rx);
    stage(ls[0], L.k_major, lv, lk, lx);
    stage(rs[0], R.k_major, rv, rk, rx);
  }
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    // The next chunk's loads go out before this chunk's multiplies; its buffer was last
    // read in step s - 1, which the barrier that ended that step retired.
    const bool more = s + 1 < n_steps;
    if (more) fetch_step(s + 1, lv, lk, lx, rv, rk, rx);
    const int b = s & 1;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&ls[b][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&rs[b][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(ar[i], br[j], part[i][j]);
    }
    if (s % n_kc == n_kc - 1) {  // end of a K block: one add into the accumulator
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
          part[i][j] = 0.f;
        }
    }
    if (more) {
      stage(ls[b ^ 1], L.k_major, lv, lk, lx);
      stage(rs[b ^ 1], R.k_major, rv, rk, rx);
    }
    __syncthreads();
  }
}

// Store this thread's 4 x 4 outputs of the sub-tile at (row0 + x, col0 + y) of a row-major
// output with row stride ldo, where x < x_lim and y < y_lim.
template <typename Tout>
__device__ __forceinline__ void store_tile(Tout* out, long long row0, long long col0,
                                           long long ldo, int x_lim, int y_lim,
                                           const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = ty * 4 + i;
    if (x >= x_lim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = tx * 4 + j;
      if (y < y_lim) store(out + (row0 + x) * ldo + col0 + y, acc[i][j]);
    }
  }
}

}  // namespace tile_product
