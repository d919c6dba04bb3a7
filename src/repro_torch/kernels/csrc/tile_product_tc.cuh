// tile_product_tc.cuh — the tensor-core product behind the port's syrk and matmul kernels
// (csrc/syrk.cu, csrc/matmul.cu) when both operands have one 16-bit type (bf16 or fp16); every
// other pair runs the fp32 CUDA-core core of tile_product.cuh.  They replace the TPU kernels
// src/repro/kernels/syrk.py:37 _syrk_kernel and src/repro/kernels/matmul.py:21 _matmul_kernel,
// which compute jnp.dot of the stored 16-bit tiles with preferred_element_type=float32: a
// product of two 16-bit values is exact in fp32, so wgmma with an fp32 accumulator computes
// the same function, in another summation order.
//
// One block computes one TILE x TILE sub-tile of an output tile, TILE 128 or 64 (picked per
// launch by the host, kernels/_launch.product_grid):
//   acc[x][y] = sum over k of L(x, k) * R(k, y),
// one fp32 accumulator per output in registers over the whole K range, rounded once to the
// output type (fp32, bf16 or fp16) when stored.  Every output's sum runs over the same k16
// steps in the same order whatever the tile (chunk 0, 1, ..., and k16 steps 0-3 of a chunk;
// the zeros past K add nothing), so tiles 64 and 128 give the same bits.
//
// What bounds it: 2 K flops an output on the fp16/bf16 tensor cores, 989 TFLOP/s dense on an
// H100 SXM at 700 W, against 4 K bytes of operands; a TILE x TILE block moves 4 TILE bytes from
// L2 a k step for 2 TILE^2 flops, so at TILE 128 the SMs together want ~15 TB/s of L2 reads at
// the tensor-core peak, more than L2 gives: the design keeps the loads in flight and off the
// consumers' path, and larger tiles or multicast clusters (later work) would halve the bytes.
// The design, as flash_attention.cu's tensor-core kernel:
//   * Warp roles.  One producer warp, after the consumers (warps 4 C .. 4 C + 3 are consumer
//     warpgroup C, so each is warpgroup-aligned), whose first thread issues every TMA copy into
//     a ring of STAGES = 4 slots.  A slot holds one K chunk of KC = 64
//     elements of each side: 128 bytes a row, the 128-byte swizzle's width.  Each slot has a
//     full mbarrier (the copies' bytes) and an empty one (every consumer thread's arrival).
//   * Consumers.  TILE / 64 warpgroups, each owning 64 rows of the sub-tile and all TILE
//     columns: wgmma.mma_async m64 n TILE k16, .f32 accumulators (TILE / 2 registers a
//     thread), 4 a chunk, one commit group a chunk.  A consumer hands a slot back once
//     wgmma.wait_group 1 has retired the previous chunk's reads of it, so one chunk's products
//     run while the next chunk's wait ends.
//   * Operands as they lie.  Every read is a 64 x 64 TMA box of the operand in memory through
//     a 2-D tensor map; nothing is transposed in device memory.  matmul's A (i x K) is K-major
//     (wgmma A, no transpose); matmul's B (K x j) and both sides of syrk (columns of A, K x i
//     and K x j, two origins of one map) are M- or N-major (the transpose bit, which wgmma
//     allows for 16-bit types).
//   * Edges.  Each map covers the padded operand, so TMA zero-fills K past its end and
//     sub-tile rows and columns past the operand.  Columns past a tile's edge but inside the
//     operand land in accumulators that are never stored; the store is masked at the tile's
//     edge (a multiple of 8: a thread's pair of columns is wholly in or out).
//   * Epilogue: each fragment pair stored as it lies, rounded once.
//   * Launch order: the blocks that run at once (one an SM at TILE 128) take a compact patch
//     of sub-tiles, RASTER = 8 sub-tile rows walked column by column, so they share their
//     operands' rows and columns in L2 and few reads go to HBM (PERF.md, section 6).
//   * 132,160 B of shared memory a block at TILE 128 (one block an SM: at 10240^3 four slots
//     and one block ran faster than three slots and two blocks) and 66,624 B at 64 (three an
//     SM).
// Later work: the epilogue staged through shared memory, persistent blocks, clusters with
// multicast loads and 128 x 256 tiles.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_product.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace tile_product_tc {

using namespace tma;
using namespace wgmma;

constexpr int KC = 64;                       // K elements of a staged chunk: 128 bytes
constexpr int BOX = 64;                      // M or N elements of a TMA box (one slab)
constexpr int BOX_BYTES = KC * BOX * 2;      // 8 KB
constexpr int ROW_BYTES = 128;
// Launch order: blocks are walked RASTER sub-tile rows at a time, column by column (matmul.cu's
// grouped_sub_tile, syrk.cu's grouped_packed_tile), so the blocks that run at once read few
// operand rows and columns, which L2 then serves to all of them.
constexpr int RASTER = 8;

template <int TILE>
struct Geometry {
  static_assert(TILE == 64 || TILE == 128, "tile 64 or 128");
  static constexpr int CONSUMERS = TILE / 64;            // warpgroups of 64 rows
  static constexpr int THREADS = 128 * CONSUMERS + 32;   // and the producer warp
  static constexpr int STAGES = 4;
  static constexpr int MIN_BLOCKS = TILE == 128 ? 1 : 3; // blocks an SM the launch bounds ask
  static constexpr int BOXES = TILE / BOX;               // boxes a side a chunk
  static constexpr int SIDE_BYTES = BOXES * BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * SIDE_BYTES;
  // the ring, a full and an empty mbarrier a slot, and the slack that aligns the ring to 1024
  static constexpr int BYTES = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
};

inline int smem_bytes(int tile) {
  return tile == 128 ? Geometry<128>::BYTES : tile == 64 ? Geometry<64>::BYTES : 0;
}
inline int threads(int tile) {
  return tile == 128 ? Geometry<128>::THREADS : tile == 64 ? Geometry<64>::THREADS : 0;
}

// The chunk at depth k0 of one side: its BOXES boxes of 64 x (the side's M or N axis, from x0)
// by 64 k, into consecutive 8 KB slabs at dst.  K_MAJOR: stored (x, k), k contiguous; else
// stored (k, x), x contiguous.
template <int BOXES, bool K_MAJOR>
__device__ __forceinline__ void load_side(uint8_t* dst, const CUtensorMap* map, int x0, int k0,
                                          uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < BOXES; ++b) {
    if (K_MAJOR) tma_load(dst + b * BOX_BYTES, map, k0, x0 + b * BOX, bar);
    else tma_load(dst + b * BOX_BYTES, map, x0 + b * BOX, k0, bar);
  }
}

// acc = L R over k < k_len for the sub-tile whose rows start at x = lx0 of L's map and whose
// columns start at x = rx0 of R's map (R is stored (k, x)); L_KMAJOR says how L lies.  Every
// thread of the block calls it; it returns true in a consumer thread, whose acc then holds
// its warpgroup's 64 rows (threadIdx.x / 128) in wgmma's fragment layout, and false in the
// producer warp.  `smem`: the dynamic shared memory (Geometry<TILE>::BYTES).
template <int TILE, typename T, bool L_KMAJOR>
__device__ __forceinline__ bool product(const CUtensorMap& lmap, int lx0, const CUtensorMap& rmap,
                                        int rx0, long long k_len, uint8_t* smem,
                                        float (&acc)[TILE / 2]) {
  using G = Geometry<TILE>;
  constexpr int STAGES = G::STAGES;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int n_chunks = static_cast<int>((k_len + KC - 1) / KC);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], 128 * G::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * G::CONSUMERS) {
    // the producer warp: chunk s waits for the consumers to hand back chunk s - STAGES's slot
    if (threadIdx.x == 128 * G::CONSUMERS) {
      for (int s = 0; s < n_chunks; ++s) {
        const int st = s % STAGES;
        mbar_wait(&empty[st], ((s / STAGES) & 1) ^ 1);
        mbar_expect(&full[st], G::STAGE_BYTES);
        uint8_t* slot = ring + st * G::STAGE_BYTES;
        load_side<G::BOXES, L_KMAJOR>(slot, &lmap, lx0, s * KC, &full[st]);
        load_side<G::BOXES, false>(slot + G::SIDE_BYTES, &rmap, rx0, s * KC, &full[st]);
      }
    }
    return false;
  }

  // a consumer warpgroup: its 64 rows are L's box c; R's TILE columns are all its boxes
  const int c = threadIdx.x / 128;
  const unsigned l_base = smem_addr(ring) + c * BOX_BYTES;
  const unsigned r_base = smem_addr(ring) + G::SIDE_BYTES;
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_chunks; ++s) {
    const int st = s % STAGES;
    mbar_wait(&full[st], (s / STAGES) & 1);
    const unsigned l = l_base + st * G::STAGE_BYTES, r = r_base + st * G::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // k16 step kk: 32 bytes along a K-major row, or 16 rows of 128 bytes down an MN-major slab
      const uint64_t da = L_KMAJOR ? descriptor(l + kk * 32, 16)
                                   : descriptor(l + kk * 16 * ROW_BYTES, BOX_BYTES);
      wgmma_ss<T, TILE, L_KMAJOR ? 0 : 1, 1>(acc, da,
                                             descriptor(r + kk * 16 * ROW_BYTES, BOX_BYTES), 1);
    }
    wgmma_commit();
    // chunk s - 1's products are done: its slot goes back
    wgmma_wait<1>();
    if (s > 0) mbar_arrive(&empty[(s - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  return true;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Store a consumer thread's outputs of the sub-tile at (row0 + x, col0 + y) of a row-major
// output with row stride ldo, where x < x_lim and y < y_lim (multiples of 8), each rounded
// once to the output type.  acc[4 j + e] is row 64 c + 16 w + l / 4 + 8 (e / 2), column
// 8 j + 2 (l % 4) + e % 2 (warpgroup c, its warp w, lane l).
template <int TILE, typename Tout>
__device__ __forceinline__ void store_tile(Tout* out, long long row0, long long col0,
                                           long long ldo, int x_lim, int y_lim,
                                           const float (&acc)[TILE / 2]) {
  const int t = threadIdx.x % 128;
  const int r = 64 * (threadIdx.x / 128) + 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int x = r + 8 * hh;
    if (x >= x_lim) continue;
    Tout* dst = out + (row0 + x) * ldo + col0;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int y = 8 * j + cq;
      if (y < y_lim) store2(dst + y, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// The 2-D map of a row-major (rows, cols) operand of 16-bit type T, read in 64 x 64 boxes
// under the 128-byte swizzle; reads past its edges give zeros.
template <typename T>
bool make_map(CUtensorMap* map, const void* base, long long rows, long long cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BOX, KC};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type =
      IS_F16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allow a kernel of the core its dynamic shared memory at `tile`.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int tile) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(tile));
}

// Blocks of `kernel` an SM holds at once, or -1 on an error.
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, int tile) {
  int blocks = 0;
  if (kernel == nullptr || prepare(kernel, tile) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads(tile),
                                                    smem_bytes(tile)) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace tile_product_tc
