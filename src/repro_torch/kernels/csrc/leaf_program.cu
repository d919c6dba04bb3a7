// leaf_program.cu — the fused leaf-program kernel of the PyTorch port, ata kind.
//
// Replaces, for the ata program kind, both TPU kernels of the JAX package:
//   src/repro/kernels/strassen_fused.py:_leaf_kernel       (pipeline_depth 1)
//   src/repro/kernels/strassen_fused.py:_pipelined_kernel  (pipeline_depth >= 2)
// It computes what they compute: for every packed lower-triangular output
// tile t of C = tril(A^t A),
//   acc = sum over contributions c, K blocks k of
//           sign[ld, c] * (sum_p lsgn[ld,c,p] L_p)^t (sum_q rsgn[ld,c,q] R_q)
// with the signed sums formed in fp32 after upcasting the operand, and the
// tile stored once.  The eight tables are the host's lowering of the leaf
// program (strassen_fused._program_tables); rtrn is not read by this kind.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): the
// non-null (tile, contribution, K) steps do 2*bn*bn*bk flops each on the
// fp32 CUDA cores (67 TFLOP/s), against ata_traffic_model's tile fetches
// (each step reads 2*tmax operand tiles) at 3.35 TB/s.  At the main path
// (10000^2 fp32, levels 2, bk = bn = 256) both come out near 1.4e12 flops
// and 69 GB: the kernel sits at the balance point if every fetch went to
// HBM.  The design keeps most re-reads out of HBM and leaves the kernel
// bound by fp32 FMA:
//   * blocks of one output tile (16 sub-tiles of 64 x 64) and of
//     neighbouring tiles read the same rows of A, which the 50 MB L2 serves;
//   * null contributions (sign 0) and null terms (coefficient 0) fetch
//     nothing, where the TPU kernel fetches and discards them;
//   * a STAGES-deep cp.async ring streams the next steps' raw chunks while
//     the current one is summed and multiplied.
// Tensor cores (wgmma), TMA and warp specialisation are later work.
//
// Grid: x = packed tile t, y = 64 x 64 sub-tile of the bn x bn tile.  256
// threads, 4 x 4 fp32 outputs each.  Inside a block the loop runs
// contributions outermost, then K blocks, then KC-row chunks of the K
// block: the TPU walk's order (k fastest).  The arithmetic does not depend
// on STAGES, so every depth gives the same bits.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;           // sub-tile edge along i and along j
constexpr int KC = 16;             // contraction rows per chunk
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_CONTRIB = 128;   // contribution slots a block can list

template <typename T> struct VecElems;          // elements per 16-byte copy
template <> struct VecElems<float> { static constexpr int n = 4; };
template <> struct VecElems<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16-byte async copy; src_bytes 0 zero-fills the destination (masked edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Packed lower-triangular index -> (i, j), i >= j, row-major; a root
// estimate with the integer correction of syrk._tri_decode.
__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  long long r = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if ((r + 1) * (r + 2) / 2 <= t) ++r;
  if (r * (r + 1) / 2 > t) --r;
  i = static_cast<int>(r);
  j = static_cast<int>(t - r * (r + 1) / 2);
}

size_t smem_bytes(int tmax, int in_bytes, int stages) {
  return static_cast<size_t>(stages) * 2 * tmax * KC * TILE * in_bytes  // raw ring
         + 2 * KC * TILE * sizeof(float)                                // signed sums
         + MAX_CONTRIB * sizeof(int);                                   // live contributions
}

template <typename Tin, typename Tout, int STAGES>
__global__ void __launch_bounds__(THREADS)
leaf_program_ata_kernel(const Tin* __restrict__ a, Tout* __restrict__ out,
                        const float* __restrict__ sign,
                        const int* __restrict__ lrow, const int* __restrict__ lcol,
                        const float* __restrict__ lsgn,
                        const int* __restrict__ rrow, const int* __restrict__ rcol,
                        const float* __restrict__ rsgn,
                        long long lda, int n_c, int n_k, int tmax, int q, int bn, int bk) {
  constexpr int CHUNK = KC * TILE;
  constexpr int V = VecElems<Tin>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* ring = reinterpret_cast<Tin*>(smem);
  float* lsum = reinterpret_cast<float*>(smem + static_cast<size_t>(STAGES) * 2 * tmax * CHUNK * sizeof(Tin));
  float* rsum = lsum + CHUNK;
  int* live = reinterpret_cast<int*>(rsum + CHUNK);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int gi, gj;
  tri_decode(blockIdx.x, gi, gj);
  const int n_sub = (bn + TILE - 1) / TILE;
  const int i0 = (blockIdx.y / n_sub) * TILE;
  const int j0 = (blockIdx.y % n_sub) * TILE;
  const int di = gi / q, dj = gj / q;
  const int ld = di * (di + 1) / 2 + dj;
  const int iq = gi % q, jq = gj % q;

  // The live contributions of this tile's leaf destination, in slot order.
  if (tid == 0) {
    int cnt = 0;
    for (int c = 0; c < n_c; ++c)
      if (sign[ld * n_c + c] != 0.f) live[cnt++] = c;
    live[MAX_CONTRIB - 1] = cnt;
  }
  __syncthreads();
  const int n_live = live[MAX_CONTRIB - 1];
  const int n_kc = (bk + KC - 1) / KC;
  const int steps_per_c = n_k * n_kc;
  const int n_steps = n_live * steps_per_c;

  // Start the copies of step s into ring slot s % STAGES: one KC x TILE
  // chunk of A per live term and side.  Left term p covers A rows
  // (lrow*n_k + k)*bk + kc.., cols (lcol*q + iq)*bn + i0..; right term q
  // the same with (rrow, rcol, jq, j0).  Both are rows of A: coalesced.
  auto start_copies = [&](int s) {
    const int c = live[s / steps_per_c];
    const int rem = s % steps_per_c;
    const int k = rem / n_kc;
    const int kc = (rem % n_kc) * KC;
    const int tab = (ld * n_c + c) * tmax;
    Tin* slot = ring + static_cast<size_t>(s % STAGES) * 2 * tmax * CHUNK;
    for (int side = 0; side < 2; ++side) {
      const int* rows = side ? rrow : lrow;
      const int* cols = side ? rcol : lcol;
      const float* coef = side ? rsgn : lsgn;
      const int off = side ? j0 : i0;
      const int qq = side ? jq : iq;
      for (int p = 0; p < tmax; ++p) {
        if (coef[tab + p] == 0.f) continue;
        const long long row0 = (static_cast<long long>(rows[tab + p]) * n_k + k) * bk + kc;
        const long long col0 = (static_cast<long long>(cols[tab + p]) * q + qq) * bn + off;
        Tin* dst = slot + (side * tmax + p) * CHUNK;
        for (int v = tid; v < CHUNK / V; v += THREADS) {
          const int rr = v / (TILE / V);
          const int cc = (v % (TILE / V)) * V;
          // bn % 8 == 0, so a vector lies wholly inside or outside the tile
          const bool valid = (kc + rr < bk) && (off + cc < bn);
          const Tin* src = valid ? a + (row0 + rr) * lda + col0 + cc : a;
          cp_async16(dst + rr * TILE + cc, src, valid);
        }
      }
    }
  };

  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  // Prologue: STAGES - 1 steps in flight.  Every thread commits one group
  // per step, empty or not, so wait_group counts steps.
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) start_copies(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    // Slot (s + STAGES - 1) % STAGES last held step s - 1, retired at the
    // barrier that ended the previous iteration.  At STAGES == 1 this
    // loads step s itself and waits for it: load, then compute.
    if (s + STAGES - 1 < n_steps) start_copies(s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const int c = live[s / steps_per_c];
    const int tab = (ld * n_c + c) * tmax;
    const Tin* slot = ring + static_cast<size_t>(s % STAGES) * 2 * tmax * CHUNK;
    // Signed sums in fp32, terms in table order; no FMA contraction, so the
    // sums round as term = coef * x; sum += term do.
    for (int e = tid; e < CHUNK; e += THREADS) {
      float l = 0.f, r = 0.f;
      for (int p = 0; p < tmax; ++p) {
        const float cl = lsgn[tab + p];
        if (cl != 0.f) l = __fadd_rn(l, __fmul_rn(cl, to_f32(slot[p * CHUNK + e])));
        const float cr = rsgn[tab + p];
        if (cr != 0.f) r = __fadd_rn(r, __fmul_rn(cr, to_f32(slot[(tmax + p) * CHUNK + e])));
      }
      lsum[e] = l;
      rsum[e] = r;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(lsum + kk * TILE + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(rsum + kk * TILE + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(ar[i], br[j], part[i][j]);
    }
    // End of one (contribution, K block) step: acc += sign * product, as
    // the TPU kernel adds sign * dot once per grid step.
    if (s % n_kc == n_kc - 1) {
      const float sg = sign[ld * n_c + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(sg, part[i][j]));
          part[i][j] = 0.f;
        }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // One store per output element: the packed stack row t*bn + i, col j.
  const long long row_base = static_cast<long long>(blockIdx.x) * bn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oi = i0 + ty * 4 + i;
    if (oi >= bn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = j0 + tx * 4 + j;
      if (oj < bn) store(out + (row_base + oi) * bn + oj, acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout, int STAGES>
cudaError_t launch(const void* a, void* out, const void* sign, const void* lrow,
                   const void* lcol, const void* lsgn, const void* rrow, const void* rcol,
                   const void* rsgn, long long lda, int n_tri, int n_c, int n_k, int tmax,
                   int q, int bn, int bk, cudaStream_t stream) {
  auto kernel = leaf_program_ata_kernel<Tin, Tout, STAGES>;
  const size_t smem = smem_bytes(tmax, sizeof(Tin), STAGES);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_sub = (bn + TILE - 1) / TILE;
  const dim3 grid(n_tri, n_sub * n_sub);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(a), static_cast<Tout*>(out), static_cast<const float*>(sign),
      static_cast<const int*>(lrow), static_cast<const int*>(lcol),
      static_cast<const float*>(lsgn), static_cast<const int*>(rrow),
      static_cast<const int*>(rcol), static_cast<const float*>(rsgn), lda, n_c, n_k, tmax, q,
      bn, bk);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_stages(int stages, const void* a, void* out, const void* sign,
                          const void* lrow, const void* lcol, const void* lsgn,
                          const void* rrow, const void* rcol, const void* rsgn, long long lda,
                          int n_tri, int n_c, int n_k, int tmax, int q, int bn, int bk,
                          cudaStream_t stream) {
#define LEAF_PROGRAM_LAUNCH(S)                                                                 \
  return launch<Tin, Tout, S>(a, out, sign, lrow, lcol, lsgn, rrow, rcol, rsgn, lda, n_tri, n_c, \
                              n_k, tmax, q, bn, bk, stream)
  switch (stages) {
    case 1: LEAF_PROGRAM_LAUNCH(1);
    case 2: LEAF_PROGRAM_LAUNCH(2);
    case 3: LEAF_PROGRAM_LAUNCH(3);
    case 4: LEAF_PROGRAM_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef LEAF_PROGRAM_LAUNCH
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the wrapper refuses > 227 KB).
size_t leaf_program_smem_bytes(int tmax, int in_bytes, int stages) {
  return smem_bytes(tmax, in_bytes, stages);
}

int leaf_program_max_contributions() { return MAX_CONTRIB - 1; }

const char* leaf_program_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype codes: 0 = float32, 1 = bfloat16.  `a` is the padded (M, lda)
// operand, `out` the (n_tri*bn, bn) packed stack.
int leaf_program_ata(const void* a, void* out, const void* sign, const void* lrow,
                     const void* lcol, const void* lsgn, const void* rrow, const void* rcol,
                     const void* rsgn, long long lda, int n_tri, int n_c, int n_k, int tmax,
                     int q, int bn, int bk, int in_dtype, int out_dtype, int stages,
                     void* stream) {
  if (n_c > MAX_CONTRIB - 1 || bn % 8 != 0 || bn < 8 || bk < 1 || tmax < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_stages<float, float>(stages, a, out, sign, lrow, lcol, lsgn, rrow, rcol, rsgn,
                                       lda, n_tri, n_c, n_k, tmax, q, bn, bk, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_stages<float, __nv_bfloat16>(stages, a, out, sign, lrow, lcol, lsgn, rrow,
                                               rcol, rsgn, lda, n_tri, n_c, n_k, tmax, q, bn,
                                               bk, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_stages<__nv_bfloat16, float>(stages, a, out, sign, lrow, lcol, lsgn, rrow,
                                               rcol, rsgn, lda, n_tri, n_c, n_k, tmax, q, bn,
                                               bk, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_stages<__nv_bfloat16, __nv_bfloat16>(stages, a, out, sign, lrow, lcol, lsgn,
                                                       rrow, rcol, rsgn, lda, n_tri, n_c, n_k,
                                                       tmax, q, bn, bk, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
