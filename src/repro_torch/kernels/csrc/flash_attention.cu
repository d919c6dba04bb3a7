// flash_attention.cu — online-softmax GQA attention of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:27 _flash_kernel (launched by
// flash_attention :82, pallas_call :100).  It computes what that kernel computes: for q
// (B, H, Sq, D) and k, v (B, Hkv, Skv, D) with H % Hkv == 0, each query row i attends to the
// kv columns j of kv head (h mod H) / (H / Hkv), positions aligned at the top left (row i at
// position i, column j at position j, also when Skv > Sq):
//
//   s = (q_i . k_j) * scale;  s = softcap * tanh(s / softcap) if softcap > 0;
//   s = -1e30 where j > i (causal) or i - j >= window (window > 0);
//   online softmax over kv tiles: m, l and the accumulator in fp32,
//   p = exp(s - m_new) summed into l in fp32 and cast to v's type before P V;
//   out = acc / max(l, 1e-30) in q's type.
//
// The mask value is the TPU kernel's finite -1e30, not -inf.  A row whose first worked kv
// tile is wholly masked (under a sliding window: the tile skip below tests only the q tile's
// first row) takes p = exp(0) = 1 there; its first real score then wipes that through
// corr = exp(-1e30 - m) = 0.  With -inf the same row would give inf - inf = NaN.  Both
// kernels skip causal kv tiles past the q tile's last row and kv tiles wholly below the
// window of its first row; at any tile size that changes no result, as the mask is finite.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): at the serving
// prefill (1 x 16 heads x 2048 queries over a 2048-slot cache, 2 kv heads, D 128, bf16,
// causal) the unmasked (q, k) pairs need 4 D flops each, 17.2 GFLOP, which take 0.017 ms on
// the bf16 tensor cores at 989 TFLOP/s; q, k, v and o once are 18.9 MB, 0.0056 ms at
// 3.35 TB/s.  So it is bound by the tensor cores' operations.
//
// bf16, the serving path, and fp16: a kernel for the tensor cores (flash_tc_kernel below), one
// instantiation a type; fp16 runs the same wgmma forms with .f16 operands, an fp16 tensor map and
// p packed to fp16 (v's type) before P V.
//   * Both products are wgmma.mma_async m64 x N x k16 with fp32 accumulators in registers
//     (the forms and descriptors: csrc/wgmma.cuh, shared with csrc/tile_product_tc.cuh).
//     S = Q K^T reads Q and K from shared memory, both K-major (head_dim contiguous), so K
//     needs no transpose.  O += P V takes P from registers: the fp32 S fragment, after the
//     softmax and a cast to v's type, is already the A fragment of the next wgmma (the two
//     layouts match), and V is read N-major from shared memory with the transpose bit.
//   * The online softmax runs on the accumulator fragments: a thread holds 2 rows, a row's
//     max and sum reduce over the quad of threads that share it (__shfl_xor_sync 1, 2).  It
//     works in whole-tile passes (scale; softcap; the mask, only on tiles that cross an
//     edge; max; exp and sum), each branch taken once a tile, so that the 64 elements'
//     chains of a thread interleave, and 2^x is one SFU instruction (ex2.approx.ftz).
//   * Copies are TMA (cp.async.bulk.tensor) through 3-D tensor maps (D, S, B * heads), so a
//     ragged Sq or Skv reads zeros past its edge, never the next head's rows.  Q is loaded
//     once a block; K and V flow through a 2-stage ring, each with a full and an empty
//     mbarrier a stage: K is released once its S is done, V once its P V is.
//   * Warp specialisation: 384 threads.  Warpgroup 0 is the producer: one thread issues
//     every copy, and setmaxnreg drops the group to 24 registers so that the two consumer
//     warpgroups can take 240 each.  Consumer warpgroup c owns q rows 64 c .. 64 c + 63 of
//     the block's BQ = 128 rows.
//   * Inside a consumer, iteration i issues tile i's S and tile i - 1's P V back to back and
//     runs tile i's softmax while that P V is in flight (S, O and P live at once: 64 + 64 +
//     32 registers at D 128).  The two consumers take turns to issue (two named barriers),
//     so one's softmax runs under the other's products.
//   * Tiles: BK = 128 kv rows at D <= 128 (Q 32 KB + 2 stages x (K 32 + V 32) KB = 160 KB
//     of shared memory at D 128), 64 at D 256 (64 KB + 2 x 64 KB = 192 KB).  Every tile lies
//     in slabs of 64 16-bit columns, 128 bytes a row, in the 128-byte swizzle that the TMA box
//     and the wgmma descriptors both name; slabs are 1024-byte aligned, so the swizzle phase
//     of a row is its index mod 8.
//   * Head dims 16 and 32 run the D 64 instantiation and 80 the D 128 one: TMA fills the
//     columns past D with zeros, which add 0 to S and give output columns that are not
//     stored.  That wastes 75 %, 50 % and 37.5 % of the products at 16, 32 and 80.
//   * Blocks run longest first: blockIdx.x is the (batch, head) and blockIdx.y counts q tiles
//     from the last, so under causal masking the blocks with the most kv tiles start first.
//   What it leaves: persistent blocks (one a SM, walking tiles, so that one tile's epilogue
//   and the next one's Q load overlap), packing the H / Hkv q heads of a kv head into one
//   block or a cluster with multicast loads (each K and V tile is now read from L2 by each
//   of them), and a TMA store of O.
//
// fp32: the CUDA-core body (flash_kernel below), no TF32: the fp32 bar (1e-5 of max|out|)
// rules it out.  At the serving prefill (q 16 x 2048 x 128, causal) the 17.2 GFLOP take
// 0.257 ms at the fp32 FMA peak of 67 TFLOP/s, so the FMAs bound it; an SM's shared memory
// delivers 128 bytes a clock against its 128 FMA lanes, so each FMA's operands must come from
// registers and each loaded word feed several FMAs.  The design:
//   * One block of 256 threads per (b * h, tile of BQ = 128 query rows), walking kv tiles of
//     64; 64 rows (4 a thread) at head dim 256, and where 128-row blocks would not give every
//     SM one (the prefill's first 512 or 1024 rows: 64 or 128 blocks on 132 SMs).  Head dims
//     16, 32 and 80 run the 64 and 128 instantiations with zero columns (as the tensor-core
//     kernel does).  Blocks run longest first.
//   * Register-blocked thread tiles: a thread owns 8 q rows (4 rg + i % 4 + 64 (i / 4), rg its
//     row group) by 4 S columns (cg + 16 j) and by 8 O columns (4 cg + 64 v + 0..3), so S is
//     8 + 4 float4 loads a step of 4 along d for 128 FMAs, and P V 2 + 2 float4 loads a kv row
//     for 64.  A warp holds two row groups and all 16 column groups: its Q and P^t loads are
//     broadcasts of two float4s, its K and V loads 16 consecutive (or 132-float-strided)
//     float4s, two wavefronts each.
//   * S stays in registers: scale, softcap and mask (branches once a tile, the mask only on
//     tiles that cross an edge), the row max by shuffles over the 16 lanes that share a row,
//     p = exp(s - m) and a per-thread share of l, summed over the row's lanes once at the end.
//     P goes to shared memory once, transposed (four rows of a column as one float4), for the
//     P V product, whose threads need whole rows of P.
//   * K and V land by 16-byte cp.async into one buffer each, zero-filled past Skv and past the
//     head dim: a tile's K is fetched while the previous tile's softmax and P V run, its V
//     while its S runs, so one block an SM (168 KB of shared memory at head dim 128: Q 66 KB,
//     K 33, V 32, P^t 33) keeps its 8 warps on FMAs.
//   * K and V are read once per 128 q rows of a head: per tile 64 KB against 2.1 M FMAs.
// The q heads of a kv head in one block were not needed: a block's 128 rows reuse each K and V
// tile as often as eight heads of 16 rows would.

// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace tma;
using namespace wgmma;

constexpr float NEG_INF = -1e30f;
constexpr int F32 = 0, BF16 = 1, F16 = 2;

// ---- fp32: the CUDA-core body ---------------------------------------------------------------

namespace cuda_core {

constexpr int BK = 64;        // kv rows a tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups, two row groups a warp

// The tiles of the instantiation for head dims up to DP (64, 128 or 256: a smaller head dim
// runs the next one with zero columns) and Q_ROWS query rows a block: 128, or 64 (4 rows a
// thread; at DP 256 always, whose 16 accumulator columns a thread would leave no registers for
// 8 rows).  Row strides in floats: Q, K and P^t padded by 4 so that the two row groups of a
// warp (Q, P^t) and its 16 column groups (K) land in other banks; V unpadded (a warp reads 16
// consecutive float4s of a row).
template <int DP, int Q_ROWS>
struct Tiles {
  static_assert(Q_ROWS == 64 || (Q_ROWS == 128 && DP <= 128), "no registers for 8 rows");
  static constexpr int BQ = Q_ROWS;
  static constexpr int RQ = BQ / 16;          // q rows a thread: 4 rg + i % 4 + 64 (i / 4)
  static constexpr int NV = DP / 64;          // its float4 columns of O: 4 cg + 64 v
  static constexpr int QS = DP + 4, KS = DP + 4, VS = DP, PS = BQ + 4;
  static constexpr int BYTES = (BQ * QS + BK * KS + BK * VS + BK * PS) * 4;
};

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

// Starts the copy of `rows` valid rows of a (rows_total, d) row-major fp32 operand, from
// `src`, into ROWS rows of DP columns at stride `stride` in shared memory: 16-byte cp.async,
// zeros past `rows` and past column d.
template <int DP, int ROWS>
__device__ __forceinline__ void load_async(float* dst, int stride, const float* src, int rows,
                                           int d) {
  constexpr int CH = DP / 4;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    const bool in = r < rows && col < d;
    cp_async16(dst + r * stride + col, in ? src + static_cast<long long>(r) * d + col : src, in);
  }
}

// The larger q tile a head dim runs: 128 rows, 64 at DP 256.
template <int DP>
constexpr int max_q_rows() {
  return DP == 256 ? 64 : 128;
}

template <int DP, int Q_ROWS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_kernel(const float* q, const float* k, const float* v, float* out, int heads,
                 int kv_heads, int sq, int skv, int d, float scale, float softcap, int causal,
                 int window) {
  using T = Tiles<DP, Q_ROWS>;
  constexpr int BQ = T::BQ, RQ = T::RQ, NV = T::NV;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* ks = qs + BQ * T::QS;                  // [BK][KS]
  float* vs = ks + BK * T::KS;                  // [BK][VS]
  float* ps = vs + BK * T::VS;                  // [BK][PS]: P transposed

  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = 2 * (tid >> 5) + (lane >> 4), cg = lane & 15;
  // longest first: blockIdx.x is the (batch, head), blockIdx.y counts q tiles from the last
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int hkv = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qb = q + ((static_cast<long long>(b) * heads + h) * sq + q0) * d;
  const float* kb = k + (static_cast<long long>(b) * kv_heads + hkv) * skv * d;
  const float* vb = v + (static_cast<long long>(b) * kv_heads + hkv) * skv * d;

  const int q_last = min(q0 + BQ, sq) - 1;
  int n_tiles = (skv + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);
  // below the window of the q tile's first row: no row of the tile needs them
  int t = 0;
  if (window > 0)
    while (t < n_tiles && q0 - (t * BK + BK - 1) >= window) ++t;

  // commit groups in order: Q, K of the first tile, V of the first tile; then each tile's K
  // after its S, and V after its P V (empty past the last tile, so the count stays uniform)
  load_async<DP, BQ>(qs, T::QS, qb, min(BQ, sq - q0), d);
  cp_async_commit();
  if (t < n_tiles) {
    load_async<DP, BK>(ks, T::KS, kb + static_cast<long long>(t) * BK * d,
                       min(BK, skv - t * BK), d);
    cp_async_commit();
    load_async<DP, BK>(vs, T::VS, vb + static_cast<long long>(t) * BK * d,
                       min(BK, skv - t * BK), d);
    cp_async_commit();
  }

  // This thread: q rows r(i) = 4 rg + i % 4 + 64 (i / 4), S columns cg + 16 j, O columns
  // 4 cg + 64 v + (0..3).  A row's S lies in the 16 lanes of one half-warp.
  float m_run[RQ], l_run[RQ], o[RQ][NV][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int w = 0; w < NV; ++w)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[i][w][u] = 0.f;
  }
  auto row_of = [](int i, int g) { return 4 * g + (i & 3) + 64 * (i >> 2); };

  for (; t < n_tiles; ++t) {
    const int k0 = t * BK, kv_rows = min(BK, skv - k0);
    cp_async_wait<1>();  // Q and this tile's K (its V may still be in flight)
    __syncthreads();

    // S = Q K^T: 8 (4) float4s of Q and 4 of K a step of 4 along d, for 128 (64) FMAs
    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qv[RQ], kv[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + row_of(i, rg) * T::QS + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * T::KS + dd);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread is done with K
    if (t + 1 < n_tiles)
      load_async<DP, BK>(ks, T::KS, kb + static_cast<long long>(k0 + BK) * d,
                         min(BK, skv - k0 - BK), d);
    cp_async_commit();

    // scale after the dot, softcap before the mask, as the TPU kernel; each branch once a tile
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] *= scale;
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = softcap * tanhf(s[i][j] / softcap);
    }
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qp = q0 + row_of(i, rg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j, kp = k0 + c;
          bool valid = c < kv_rows;
          if (causal) valid = valid && qp >= kp;
          if (window > 0) valid = valid && (qp - kp) < window;
          if (!valid) s[i][j] = NEG_INF;
        }
      }
    }

    // the online softmax in registers: a row's max over its half-warp by shuffles; l summed
    // per thread, over the half-warp once at the end
    float corr[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float m = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int x = 1; x < 16; x <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
      const float m_new = fmaxf(m_run[i], m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      corr[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr[i] + sum;
      m_run[i] = m_new;
    }
    // P^t: four rows of a column as one float4 (the last P V read P^t before this tile's
    // first barrier)
#pragma unroll
    for (int g = 0; g < RQ / 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(ps + (cg + 16 * j) * T::PS + 4 * rg + 64 * g) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j], s[4 * g + 3][j]);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int w = 0; w < NV; ++w)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[i][w][u] *= corr[i];
    cp_async_wait<1>();  // this tile's V (the next K may still be in flight)
    __syncthreads();

    // O += P V: 2 (1) float4s of P^t and 2 (4, 1) of V a kv row, for 64 FMAs
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float4 pv[RQ / 4], vv[NV];
#pragma unroll
      for (int g = 0; g < RQ / 4; ++g)
        pv[g] = *reinterpret_cast<const float4*>(ps + c * T::PS + 4 * rg + 64 * g);
#pragma unroll
      for (int w = 0; w < NV; ++w)
        vv[w] = *reinterpret_cast<const float4*>(vs + c * T::VS + 4 * cg + 64 * w);
#pragma unroll
      for (int g = 0; g < RQ / 4; ++g) {
        const float p4[4] = {pv[g].x, pv[g].y, pv[g].z, pv[g].w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int w = 0; w < NV; ++w) {
            const int i = 4 * g + ii;
            o[i][w][0] = fmaf(p4[ii], vv[w].x, o[i][w][0]);
            o[i][w][1] = fmaf(p4[ii], vv[w].y, o[i][w][1]);
            o[i][w][2] = fmaf(p4[ii], vv[w].z, o[i][w][2]);
            o[i][w][3] = fmaf(p4[ii], vv[w].w, o[i][w][3]);
          }
      }
    }
    __syncthreads();  // every thread is done with V and P^t
    if (t + 1 < n_tiles)
      load_async<DP, BK>(vs, T::VS, vb + static_cast<long long>(k0 + BK) * d,
                         min(BK, skv - k0 - BK), d);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int x = 1; x < 16; x <<= 1) l += __shfl_xor_sync(0xffffffffu, l, x);
    const int r = row_of(i, rg);
    if (q0 + r >= sq) continue;
    l = fmaxf(l, 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * heads + h) * sq + q0 + r) * d;
#pragma unroll
    for (int w = 0; w < NV; ++w) {
      const int col = 4 * cg + 64 * w;
      if (col < d)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[i][w][0] / l, o[i][w][1] / l, o[i][w][2] / l, o[i][w][3] / l);
    }
  }
}

template <int DP, int Q_ROWS>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* out, int batch,
                        int heads, int kv_heads, int sq, int skv, int d, float scale,
                        float softcap, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = Tiles<DP, Q_ROWS>::BYTES;
  // above 48 KB only after this attribute; set on every launch, so every card has it
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DP, Q_ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (sq + Q_ROWS - 1) / Q_ROWS);
  flash_kernel<DP, Q_ROWS><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), heads, kv_heads, sq, skv, d, scale, softcap, causal, window);
  return cudaGetLastError();
}

// 128-row blocks where they fill every SM at least once; else 64-row ones, twice as many
// (at the serving prefill's first 512 rows 64 blocks of 128 rows would leave half the SMs
// idle).
template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch,
                   int heads, int kv_heads, int sq, int skv, int d, float scale, float softcap,
                   int causal, int window, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks128 = static_cast<long long>(batch) * heads * ((sq + 127) / 128);
  if constexpr (max_q_rows<DP>() == 128)
    if (blocks128 >= sms)
      return launch_rows<DP, 128>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale,
                                  softcap, causal, window, stream);
  return launch_rows<DP, 64>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale, softcap,
                             causal, window, stream);
}

}  // namespace cuda_core

// ---- bf16 and fp16: the tensor-core kernel ---------------------------------------------------

namespace tc {

constexpr int BQ = 128;                 // query rows per block: two consumer warpgroups of 64
constexpr int STAGES = 2;               // depth of the K / V ring
constexpr int THREADS = 384;            // the producer warpgroup and two consumers
constexpr int SLAB = 64;                // 16-bit columns of a 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
constexpr int kv_tile() { return DP == 256 ? 64 : 128; }

// Shared memory of a launch: Q, the ring's K and V tiles, the mbarriers, and the slack that
// aligns the tiles to 1024 bytes.
template <int DP>
struct Layout {
  static constexpr int BK = kv_tile<DP>();
  static constexpr int SLABS = DP / SLAB;
  static constexpr int Q_SLAB = BQ * ROW_BYTES;
  static constexpr int KV_SLAB = BK * ROW_BYTES;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;
  static constexpr int BARRIERS = 1 + 4 * STAGES;   // q full; k and v full and empty a stage
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS + 1024;
};

// 2^x by the SFU alone: results below 2^-126 flush to 0 (p there is below any bf16 or fp16
// output's last place), and 2^-1.4e30, a masked score's, is 0.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to T (bf16 or fp16) and packed into one register, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (IS_F16<T>) {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  } else {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
}

// The named barriers by which the two consumer warpgroups take turns to issue their products
// (0 is __syncthreads'): warpgroup c waits on TURN + c, and hands over on the other's.
constexpr int TURN = 1;
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// What a consumer thread knows of its rows: the warpgroup's first row, the thread's rows r and
// r + 8, its column pair cq, cq + 1 in each 8-column group, and the masking.
struct Rows {
  int row0, r, cq, skv, causal, window;
  float scale, softcap;
};

// S = Q K^T of the warpgroup's 64 rows over one kv tile, issued and committed (not waited):
// DP / 16 steps of 16 columns, 4 steps a 64-column slab, 32 bytes each.
template <typename T, int DP>
__device__ __forceinline__ void issue_scores(float (&s)[Layout<DP>::BK / 2], unsigned q_addr,
                                             unsigned k_addr) {
  using L = Layout<DP>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<T, L::BK>(s, descriptor(q_addr + (kk / 4) * L::Q_SLAB + (kk % 4) * 32, 16),
                    descriptor(k_addr + (kk / 4) * L::KV_SLAB + (kk % 4) * 32, 16), kk > 0);
  wgmma_commit();
}

// O += P V over one kv tile, issued and committed: BK / 16 steps of 16 kv rows (2048 bytes).
template <typename T, int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&p)[Layout<DP>::BK / 16][4],
                                         unsigned v_addr) {
  using L = Layout<DP>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk)
    wgmma_rs<T, DP>(o, p[kk], descriptor(v_addr + kk * 16 * ROW_BYTES, L::KV_SLAB));
  wgmma_commit();
}

// The online softmax of one kv tile at column k0 on the S fragment: scale after the dot,
// softcap before the mask, as the TPU kernel; the row max and sum over the quad.  Leaves
// p = exp(s - m_new) in s, adds its unrounded row sums into l (after l *= corr) and returns
// corr = exp(m_old - m_new) for the accumulator.  s[4 j + e] is row r + 8 (e / 2), column
// k0 + 8 j + cq + e % 2.
template <int BK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], int k0, const Rows& w, float (&m)[2],
                                        float (&l)[2], float (&corr)[2]) {
  // whole-tile passes, each branch taken once a tile, so that the 64 elements' chains interleave
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] *= w.scale;
  if (w.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = w.softcap * tanhf(s[i] / w.softcap);
  }
  if (k0 + BK > w.skv || (w.causal && k0 + BK - 1 > w.row0) ||
      (w.window > 0 && w.row0 + 63 - k0 >= w.window)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = w.r + 8 * (e / 2), kp = k0 + 8 * j + w.cq + e % 2;
        const bool valid = kp < w.skv && (!w.causal || qp >= kp) &&
                           (w.window == 0 || qp - kp < w.window);
        s[4 * j + e] = valid ? s[4 * j + e] : NEG_INF;
      }
  }
  float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    mx[h] = fmaxf(m[h], mx[h]);                 // m_new
    corr[h] = exp2_sfu((m[h] - mx[h]) * LOG2E);
    m[h] = mx[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = exp2_sfu((s[i] - m[(i / 2) % 2]) * LOG2E);
    sum[(i / 2) % 2] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * corr[h] + sum[h];
  }
}

// The accumulator's rows scaled by corr: o[4 j + e] is row r + 8 (e / 2).
template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e / 2];
  fence_regs(o);
}

// p rounded to T (v's type, bf16 or fp16) as the A fragments of P V: k-step kk is columns
// 16 kk .. 16 kk + 15, which are s[8 kk .. 8 kk + 7] in the order the fragment wants.  In fp16 a
// p below 2^-24 rounds to 0 where bf16 keeps it; the plain version rounds p to v's type alike.
template <typename T, int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) p[kk][a] = pack2<T>(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1]);
}

// One block: q rows q0 .. q0 + 127 of head blockIdx.x, over kv tiles [t_lo, t_hi).  DP is
// the instantiation's head_dim (d <= DP; columns past d arrive as zeros).
template <int DP, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, T* out, int heads,
                    int kv_heads, int sq, int skv, int d, float scale, float softcap,
                    int causal, int window) {
  using L = Layout<DP>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + L::Q_BYTES;
  uint8_t* vs = ks + STAGES * L::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * L::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int bkv = b * kv_heads + h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;      // the longest tiles first
  const int q_last = min(q0 + BQ, sq) - 1;
  int t_hi = (skv + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, q_last / BK + 1);
  // tiles wholly below the window of the q tile's first row: no row of the tile needs them
  int t_lo = 0;
  if (window > 0 && q0 - window - BK + 1 >= 0) t_lo = (q0 - window - BK + 1) / BK + 1;
  const int n = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s]);
      mbar_init(&v_full[s]);
      mbar_init(&k_empty[s], THREADS - 128);
      mbar_init(&v_empty[s], THREADS - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread issues every copy; tile i's K waits for the
    // consumers to release tile i - STAGES's K (after its S), its V for that tile's V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect(q_full, L::Q_BYTES);
      for (int s = 0; s < L::SLABS; ++s)
        tma_load(qs + s * L::Q_SLAB, &qmap, s * SLAB, q0, bh, q_full);
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, k0 = (t_lo + i) * BK;
        const unsigned parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(&k_empty[st], parity);
        mbar_expect(&k_full[st], L::KV_BYTES);
        for (int s = 0; s < L::SLABS; ++s)
          tma_load(ks + st * L::KV_BYTES + s * L::KV_SLAB, &kmap, s * SLAB, k0, bkv, &k_full[st]);
        mbar_wait(&v_empty[st], parity);
        mbar_expect(&v_full[st], L::KV_BYTES);
        for (int s = 0; s < L::SLABS; ++s)
          tma_load(vs + st * L::KV_BYTES + s * L::KV_SLAB, &vmap, s * SLAB, k0, bkv, &v_full[st]);
      }
    }
  } else {
    // a consumer warpgroup: q rows 64 c .. 64 c + 63 of the tile.  Iteration i issues tile
    // i's S and then tile i - 1's P V, hands the turn to the other warpgroup, and runs tile
    // i's softmax while its P V is in flight; the last tile's P V follows the loop.  Each
    // warpgroup waits for its turn n times and the other hands it over n times.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    Rows w;
    w.row0 = q0 + 64 * c;
    w.r = w.row0 + 16 * (t / 32) + (t % 32) / 4;
    w.cq = 2 * (t % 4);
    w.skv = skv, w.causal = causal, w.window = window, w.scale = scale, w.softcap = softcap;
    const unsigned q_addr = smem_addr(qs) + 64 * c * ROW_BYTES;
    const unsigned k_base = smem_addr(ks), v_base = smem_addr(vs);

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t p[BK / 16][4];

    mbar_wait(q_full, 0);
    if (n > 0) {
      float s[BK / 2];
      mbar_wait(&k_full[0], 0);
      issue_scores<T, DP>(s, q_addr, k_base);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[0]);
      softmax<BK>(s, t_lo * BK, w, m, l, corr);   // o is 0: corr has nothing to scale
      pack_p<T, BK>(s, p);
      if (c == 1) turn_pass(TURN);                // warpgroup 0 issues first
    }
    for (int i = 1; i < n; ++i) {
      const int st = i % STAGES, pst = (i - 1) % STAGES;
      float s[BK / 2];
      rescale<DP>(o, corr);                      // before any wgmma of the turn is issued
      turn_wait(TURN + c);
      mbar_wait(&k_full[st], (i / STAGES) & 1);
      issue_scores<T, DP>(s, q_addr, k_base + st * L::KV_BYTES);
      mbar_wait(&v_full[pst], ((i - 1) / STAGES) & 1);
      issue_pv<T, DP>(o, p, v_base + pst * L::KV_BYTES);
      turn_pass(TURN + 1 - c);
      wgmma_wait<1>();
      fence_regs(s);
      mbar_arrive(&k_empty[st]);
      softmax<BK>(s, (t_lo + i) * BK, w, m, l, corr);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[pst]);
      pack_p<T, BK>(s, p);
    }
    if (n > 0) {
      // the last tile's P V
      const int pst = (n - 1) % STAGES;
      rescale<DP>(o, corr);
      turn_wait(TURN + c);
      mbar_wait(&v_full[pst], ((n - 1) / STAGES) & 1);
      issue_pv<T, DP>(o, p, v_base + pst * L::KV_BYTES);
      if (c == 0) turn_pass(TURN + 1);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[pst]);
    }

    // out = acc / max(l, 1e-30) in T; o[4 j + e] is row r + 8 (e / 2), column 8 j + cq + e % 2
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = w.r + 8 * hh;
      if (row >= sq) continue;
      const float lq = fmaxf(l[hh], 1e-30f);
      T* dst = out + (static_cast<long long>(bh) * sq + row) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + w.cq;
        if (col < d)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack2<T>(o[4 * j + 2 * hh] / lq, o[4 * j + 2 * hh + 1] / lq);
      }
    }
  }
}

// The 3-D map (d, s, planes) of a contiguous (planes, s, d) operand of type T (bf16 or fp16),
// read in boxes of 64 columns x box_rows rows under the 128-byte swizzle; reads past its edges
// give zeros.
template <typename T>
bool make_map(CUtensorMap* map, const void* base, int d, int s, int planes, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {SLAB, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      IS_F16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch,
                   int heads, int kv_heads, int sq, int skv, int d, float scale, float softcap,
                   int causal, int window, cudaStream_t stream) {
  using L = Layout<DP>;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<T>(&qmap, q, d, sq, batch * heads, BQ) ||
      !make_map<T>(&kmap, k, d, skv, batch * kv_heads, L::BK) ||
      !make_map<T>(&vmap, v, d, skv, batch * kv_heads, L::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (sq + BQ - 1) / BQ);
  flash_tc_kernel<DP, T><<<grid, THREADS, L::BYTES, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(out), heads, kv_heads, sq, skv, d, scale, softcap,
      causal, window);
  return cudaGetLastError();
}

// The instantiation that runs head_dim d: the next larger of 64, 128, 256.
constexpr int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace tc

bool supported(int d) {
  return d == 16 || d == 32 || d == 64 || d == 80 || d == 128 || d == 256;
}

// The fp32 CUDA-core body at head_dim d: the instantiation of the next larger of 64, 128, 256.
cudaError_t launch_f32(int d, const void* q, const void* k, const void* v, void* out,
                       int batch, int heads, int kv_heads, int sq, int skv, float scale,
                       float softcap, int causal, int window, cudaStream_t s) {
  switch (tc::padded_dim(d)) {
    case 64:
      return cuda_core::launch<64>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale,
                                   softcap, causal, window, s);
    case 128:
      return cuda_core::launch<128>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale,
                                    softcap, causal, window, s);
    default:
      return cuda_core::launch<256>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale,
                                    softcap, causal, window, s);
  }
}

// The tensor-core kernel on bf16 or fp16 (T) operands.
template <typename T>
cudaError_t launch_tc(int d, const void* q, const void* k, const void* v, void* out, int batch,
                      int heads, int kv_heads, int sq, int skv, float scale, float softcap,
                      int causal, int window, cudaStream_t s) {
  switch (tc::padded_dim(d)) {
    case 64:
      return tc::launch<64, T>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale, softcap,
                               causal, window, s);
    case 128:
      return tc::launch<128, T>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale,
                                softcap, causal, window, s);
    default:
      return tc::launch<256, T>(q, k, v, out, batch, heads, kv_heads, sq, skv, d, scale,
                                softcap, causal, window, s);
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory a launch at head_dim d and dtype (0 fp32, 1 bf16, 2 fp16) takes, in bytes (0
// for an unsupported d or dtype; fp32: at its larger q tile).
int flash_attention_smem_bytes(int d, int dtype) {
  if (!supported(d)) return 0;
  if (dtype == BF16 || dtype == F16) {
    switch (tc::padded_dim(d)) {
      case 64: return tc::Layout<64>::BYTES;
      case 128: return tc::Layout<128>::BYTES;
      default: return tc::Layout<256>::BYTES;
    }
  }
  if (dtype != F32) return 0;
  switch (tc::padded_dim(d)) {  // the larger q tile's
    case 64: return cuda_core::Tiles<64, 128>::BYTES;
    case 128: return cuda_core::Tiles<128, 128>::BYTES;
    default: return cuda_core::Tiles<256, 64>::BYTES;
  }
}

// out (B, H, Sq, D) = attention of q (B, H, Sq, D) over k, v (B, Hkv, Skv, D), all contiguous,
// 16-byte aligned and of one dtype (0 fp32, 1 bf16, 2 fp16).  d in {16, 32, 64, 80, 128, 256};
// heads % kv_heads == 0; window 0 means none, softcap 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int batch,
                           int heads, int kv_heads, int sq, int skv, int d, float scale,
                           float softcap, int causal, int window, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || sq < 1 || skv < 1 ||
      window < 0 || static_cast<long long>(batch) * heads > 65535 || !supported(d))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_f32(d, q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap, causal,
                      window, s);
  if (dtype == BF16)
    return launch_tc<__nv_bfloat16>(d, q, k, v, out, batch, heads, kv_heads, sq, skv, scale,
                                    softcap, causal, window, s);
  if (dtype == F16)
    return launch_tc<__half>(d, q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                             causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
