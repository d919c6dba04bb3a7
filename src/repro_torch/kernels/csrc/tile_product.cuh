// tile_product.cuh — the shared-memory-tiled fp32 product behind the port's syrk and matmul
// kernels (csrc/syrk.cu, csrc/matmul.cu), which replace the TPU kernels
// src/repro/kernels/syrk.py:37 _syrk_kernel and src/repro/kernels/matmul.py:21 _matmul_kernel.
// It runs fp32 operands and mixed pairs (fp32 with a 16-bit type, fp16 with bf16); two operands
// of one 16-bit type run on the tensor cores instead (tile_product_tc.cuh).  The type alone
// picks the core (kernels/_launch.product_core), never a failed launch.
//
// One thread block of 256 computes one TILE x TILE sub-tile of an output tile, TILE 128 or 64
// (a template parameter; the host picks it per launch, kernels/_launch.product_grid):
//   acc[x][y] = sum over k of L(x, k) * R(k, y),
// one fp32 accumulator per output over the whole K range, by fmaf in k order.  The TPU kernels
// carry their accumulator across a sequential K grid axis; here a loop inside the block takes
// that axis's place, and the order of an fp32 sum is no part of C = A B.  Each element's sum
// runs k = 0, 1, ... whatever the tile (the masked depth past K adds exact zeros), so tiles 64
// and 128 give the same bits.  A side is read as it lies in memory: "k-major" (stored K x TILE,
// element (x, k) at base[k * ld + x0 + x]: both sides of syrk, B of matmul) or "x-major"
// (stored TILE x K, element at base[(x0 + x) * ld + k]: A of matmul).  Every chunk lands in
// shared memory as [k][x] in fp32, so the multiply loop is one code path for both.  A side is
// fp32, bf16 or fp16; a 16-bit element widens to fp32 exactly, so each product is that of the
// TPU kernel's jnp.dot of 16-bit tiles with an fp32 accumulator.
//
// What bounds it: fp32 FMA on the CUDA cores (no tensor cores: TF32 would miss the 1e-5 bar an
// fp32 product is held to), 67 TFLOP/s on an H100 SXM at 700 W; each output needs 2K flops
// against 8K bytes of operands.  An SM's shared
// memory delivers 32 words a clock against its 128 FMA lanes, so a k step must load at most one
// word for 4 FMAs, and the copies of later chunks must be in flight while one is multiplied.
// The design:
//   * 8 x 8 outputs a thread at TILE 128 (4 x 4 at 64): rows 64 g + 4 ty + i, columns
//     64 h + 4 tx + j (tx, ty in 0..15), so a k step is 4 float4 loads (LDS.128) for 64 FFMAs,
//     and a warp's loads of a staged row are contiguous (tx) or broadcast (ty): no conflicts;
//   * K staged in chunks of KC = 16 through a ring of STAGES = 4 slots a side.  A k-major fp32
//     side lands by 16-byte cp.async (zero-filled where masked), three chunks ahead, one
//     commit group a chunk; one barrier a chunk.  A side that needs a change on the way in
//     goes through registers one chunk ahead, under the ring: matmul's x-major left side is
//     transposed as it is stored (each float4 along k becomes 4 scalar stores down a column of
//     the [k][x] slot; a float4 read down that column each k step would cost 8 LDS.128 where
//     the [k][x] row costs 2), and a bf16 or fp16 side is widened to fp32 where it is stored,
//     so the multiply loop never converts.  KC 16 rather than 32 keeps a chunk's masked tail short
//     for K a multiple of 8, and 4 slots keep three chunks in flight;
//   * 67,584 B of shared memory a block at TILE 128 (34,816 B at 64) and at most 128
//     registers a thread at TILE 128 (64 at 64): __launch_bounds__(256, 2) (4 at 64), so two
//     blocks share an SM at TILE 128 and one block's barrier waits hide under the other's
//     FMAs.
// A mixed pair widened here runs at this fp32 rate, ~7 % of what the tensor cores give a pair
// of one 16-bit type.  3xTF32 split products are untried (PERF.md section 7).
//
// Shape contract (checked by the C entries and the Python wrappers): the tile edges and the
// K block are multiples of 8, so every 4-element vector lies wholly inside or outside a tile
// and K, and the row strides are multiples of 8, so vectors are 16-byte (fp32) or 8-byte
// (bf16, fp16) aligned.  Masked rows and columns of a sub-tile are zero-filled when staged and
// never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile_product {

constexpr int KC = 16;             // contraction depth of one staged chunk
constexpr int STAGES = 4;          // ring slots a side
constexpr int THREADS = 256;       // 16 x 16 threads

// dtype codes of the C interfaces
enum DType { F32 = 0, BF16 = 1, F16 = 2 };

template <int TILE>
struct Geometry {
  static constexpr int LDS = TILE + 4;                      // padded row of a staged chunk
  static constexpr int SLOT = KC * LDS;                     // floats of one side's chunk
  static constexpr int R = TILE / 16;                       // outputs a thread along each axis
  static constexpr int VECS = KC * TILE / 4 / THREADS;      // 4-vectors a thread stages a chunk
};

// Dynamic shared memory of one block: the ring of both sides.
inline size_t smem_bytes(int tile) {
  return static_cast<size_t>(STAGES) * 2 * KC * (tile + 4) * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four elements of type T, as loaded (a float4, or 8 bytes of bf16 or fp16), widened to fp32:
// exact for both 16-bit types.
template <typename T>
__device__ __forceinline__ float4 widen(float4 v) { return v; }
template <typename T>
__device__ __forceinline__ float4 widen(uint2 raw) {
  float2 lo, hi;
  if constexpr (std::is_same<T, __half>::value) {
    lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  } else {
    lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  }
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, const float* v) {
  __half2 lo = __floats2half2_rn(v[0], v[1]);
  __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// One side of the product, cut to one sub-tile, and how it is staged.  A k-major fp32 side
// lands by cp.async; any other goes through `held`, one chunk ahead.  A thread's vector v of a
// chunk sits at (k_of(v), x_of(v)) of the [k][x] slot: k-major, 4 consecutive x at one k, the
// block's threads covering ROWS rows of the chunk a vector; x-major, 4 consecutive k at one x,
// 64 x a vector.  The side keeps one pointer, to its vector 0 of the next chunk, and steps it
// a chunk at a time, so the addresses cost few registers beside the 8 x 8 accumulators.
template <int TILE, typename T, bool K_MAJOR>
struct Side {
  using G = Geometry<TILE>;
  static constexpr bool ASYNC = K_MAJOR && std::is_same<T, float>::value;
  using Raw = typename std::conditional<std::is_same<T, float>::value, float4, uint2>::type;
  static constexpr int ROWS = THREADS / (TILE / 4);             // k-major: chunk rows a vector
  static constexpr int STRIDE = K_MAJOR ? ROWS : THREADS / (KC / 4);  // memory rows a vector

  __device__ static __forceinline__ int k_of(int v) {
    return K_MAJOR ? static_cast<int>(threadIdx.x) / (TILE / 4) + v * ROWS
                   : (static_cast<int>(threadIdx.x) % (KC / 4)) * 4;
  }
  __device__ static __forceinline__ int x_of(int v) {
    return K_MAJOR ? (static_cast<int>(threadIdx.x) % (TILE / 4)) * 4
                   : static_cast<int>(threadIdx.x) / (KC / 4) + v * STRIDE;
  }

  const T* p;        // this thread's vector 0 of the next chunk to fetch
  long long ld;      // row stride, in elements
  unsigned x_in;     // bit v: vector v lies inside the sub-tile
  Raw held[G::VECS];

  // base: the operand; x0: the first x (row of the output sub-tile, or column) this sub-tile
  // reads; x_lim: its valid x, the tile's edge past x0, at most TILE.
  __device__ __forceinline__ Side(const T* base, long long ld_, long long x0, int x_lim)
      : p(K_MAJOR ? base + k_of(0) * ld_ + x0 + x_of(0) : base + (x0 + x_of(0)) * ld_ + k_of(0)),
        ld(ld_),
        x_in(0) {
#pragma unroll
    for (int v = 0; v < G::VECS; ++v)
      if (x_of(v) < x_lim) x_in |= 1u << v;
  }

  // Start the copies of the next chunk, of which the first k_left rows of depth lie inside K:
  // straight into `slot` (ASYNC), else into held; zeros where masked.
  __device__ __forceinline__ void fetch(float* slot, long long k_left) {
#pragma unroll
    for (int v = 0; v < G::VECS; ++v) {
      const bool in = (x_in >> v & 1u) && k_of(v) < k_left;
      const T* src = p + v * STRIDE * ld;
      if constexpr (ASYNC) {
        cp_async16(slot + k_of(v) * G::LDS + x_of(v), src, in);
      } else {
        held[v] = in ? *reinterpret_cast<const Raw*>(src) : Raw{};
      }
    }
    p += K_MAJOR ? KC * ld : KC;
  }

  // Store held into `slot` as [k][x] fp32 (nothing to do for an ASYNC side).
  __device__ __forceinline__ void land(float* slot) const {
    if constexpr (!ASYNC) {
#pragma unroll
      for (int v = 0; v < G::VECS; ++v) {
        float* const at = slot + k_of(v) * G::LDS + x_of(v);
        const float4 w = widen<T>(held[v]);
        if (K_MAJOR) {
          *reinterpret_cast<float4*>(at) = w;
        } else {
          at[0] = w.x;
          at[G::LDS] = w.y;
          at[2 * G::LDS] = w.z;
          at[3 * G::LDS] = w.w;
        }
      }
    }
  }
};

// acc = L R over the whole K range for this thread's NR x NR outputs (rows 64 g + 4 ty + i,
// columns 64 h + 4 tx + j of the sub-tile).  `smem` holds the ring (smem_bytes(TILE)).
// Every thread of the block must call it.
template <int TILE, typename Tl, bool LK, typename Tr, bool RK>
__device__ __forceinline__ void product(Side<TILE, Tl, LK>& L, Side<TILE, Tr, RK>& R,
                                        long long k_len, float* smem,
                                        float (&acc)[Geometry<TILE>::R][Geometry<TILE>::R]) {
  using G = Geometry<TILE>;
  constexpr int NR = G::R;
  constexpr bool LA = Side<TILE, Tl, LK>::ASYNC, RA = Side<TILE, Tr, RK>::ASYNC;
  float* const ls = smem;                        // [STAGES][KC][LDS]
  float* const rs = smem + STAGES * G::SLOT;     // [STAGES][KC][LDS]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_chunks = static_cast<int>((k_len + KC - 1) / KC);
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;

  // The ring: the async sides' first STAGES - 1 chunks, one commit group each (empty groups
  // past the end keep the count), and the register sides' first chunk.
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) {
      const long long k_left = k_len - static_cast<long long>(c) * KC;
      if (LA) L.fetch(ls + c * G::SLOT, k_left);
      if (RA) R.fetch(rs + c * G::SLOT, k_left);
    }
    cp_async_commit();
  }
  if (n_chunks > 0) {
    if (!LA) {
      L.fetch(nullptr, k_len);
      L.land(ls);
    }
    if (!RA) {
      R.fetch(nullptr, k_len);
      R.land(rs);
    }
  }

  for (int s = 0; s < n_chunks; ++s) {
    // Chunk s is in: this thread's group of it has landed, and the barrier makes every
    // thread's copies and stores visible.  It also retires step s - 1's reads of its slot,
    // which the async copies of chunk s + STAGES - 1 reuse.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = s + STAGES - 1;
    if (next < n_chunks) {
      const long long k_left = k_len - static_cast<long long>(next) * KC;
      if (LA) L.fetch(ls + (next % STAGES) * G::SLOT, k_left);
      if (RA) R.fetch(rs + (next % STAGES) * G::SLOT, k_left);
    }
    cp_async_commit();
    const bool more = s + 1 < n_chunks;
    if (more) {
      const long long k_left = k_len - static_cast<long long>(s + 1) * KC;
      if (!LA) L.fetch(nullptr, k_left);
      if (!RA) R.fetch(nullptr, k_left);
    }
    const float* lc = ls + (s % STAGES) * G::SLOT;
    const float* rc = rs + (s % STAGES) * G::SLOT;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[NR], b[NR];
#pragma unroll
      for (int g = 0; g < NR / 4; ++g) {
        const float4 av = *reinterpret_cast<const float4*>(lc + kk * G::LDS + g * 64 + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(rc + kk * G::LDS + g * 64 + tx * 4);
        a[4 * g] = av.x; a[4 * g + 1] = av.y; a[4 * g + 2] = av.z; a[4 * g + 3] = av.w;
        b[4 * g] = bv.x; b[4 * g + 1] = bv.y; b[4 * g + 2] = bv.z; b[4 * g + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // The register sides' chunk s + 1 goes to its slot, last read in step s + 1 - STAGES.
    if (more) {
      if (!LA) L.land(ls + ((s + 1) % STAGES) * G::SLOT);
      if (!RA) R.land(rs + ((s + 1) % STAGES) * G::SLOT);
    }
  }
  cp_async_wait<0>();
}

// Store this thread's outputs of the sub-tile at (row0 + x, col0 + y) of a row-major output
// with row stride ldo, where x < x_lim and y < y_lim (multiples of 8: a thread's 4 columns are
// all in or all out), each rounded once to the output type.
template <int TILE, typename Tout>
__device__ __forceinline__ void store_tile(Tout* out, long long row0, long long col0,
                                           long long ldo, int x_lim, int y_lim,
                                           const float (&acc)[Geometry<TILE>::R]
                                                             [Geometry<TILE>::R]) {
  constexpr int NR = Geometry<TILE>::R;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int x = (i / 4) * 64 + ty * 4 + i % 4;
    if (x >= x_lim) continue;
#pragma unroll
    for (int h = 0; h < NR / 4; ++h) {
      const int y = h * 64 + tx * 4;
      if (y < y_lim) store4(out + (row0 + x) * ldo + col0 + y, &acc[i][4 * h]);
    }
  }
}

// The sub-tile `sub` of a (bm, bn) output tile, row-major over ceil(bn / TILE) columns of
// sub-tiles: its origin (i0, j0) and valid extent (i_lim, j_lim) (kernels/_launch.sub_tile).
template <int TILE>
__device__ __forceinline__ void sub_tile(int sub, int bm, int bn, int& i0, int& j0, int& i_lim,
                                         int& j_lim) {
  const int n_sub_j = (bn + TILE - 1) / TILE;
  i0 = (sub / n_sub_j) * TILE;
  j0 = (sub % n_sub_j) * TILE;
  i_lim = min(TILE, bm - i0);
  j_lim = min(TILE, bn - j0);
}

// Sub-tiles of a (bm, bn) output tile at `tile`.
inline long long sub_tiles(int bm, int bn, int tile) {
  return static_cast<long long>((bm + tile - 1) / tile) * ((bn + tile - 1) / tile);
}

// Allow a kernel of the product the ring's dynamic shared memory at `tile`.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int tile) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(tile)));
}

// Blocks of `kernel` an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// -1 on an error.
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, int tile) {
  int blocks = 0;
  if (kernel == nullptr || prepare(kernel, tile) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    smem_bytes(tile)) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace tile_product
