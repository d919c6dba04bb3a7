// leaf_program.cu — the fused leaf-program kernel of the PyTorch port: ata and symm kinds.
//
// Replaces, for the ata and symm program kinds, both TPU kernels of the JAX package:
//   src/repro/kernels/strassen_fused.py:_leaf_kernel       (pipeline_depth 1)
//   src/repro/kernels/strassen_fused.py:_pipelined_kernel  (pipeline_depth >= 2)
// It computes what they compute: for every output tile,
//   acc = sum over contributions c, K blocks k of
//           sign[ld, c] * (sum_p lsgn[ld,c,p] L_p) (sum_q rsgn[ld,c,q] R_q)
// with the signed sums formed in fp32 after upcasting the operands, and the
// tile stored once.  The eight tables are the host's lowering of the leaf
// program (strassen_fused._program_tables).
//   * ata:  C = tril(A^t A).  Both sides are tiles of one operand A, the left
//     one transposed; the output is the packed lower-triangular tile stack.
//   * symm: D = X @ Sym, Sym given only as the packed lower-triangular stack of
//     S; with diag_sym, Sym = S + S^t (the backward of ata, dA = A (S + S^t)).
//     The left side is X, not transposed; a right term reads the stored tile
//     (max(gr, gc), min(gr, gc)) of its conceptual coordinates and mirrors it
//     when rtrn says so or gr < gc; a diagonal tile under diag_sym contributes
//     tile + tile^t.  The output is the dense (M, T*bs) grid.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): the
// non-null (tile, contribution, K) steps do 2*bi*bj*bc flops each on the fp32
// CUDA cores (67 TFLOP/s).  Each step reads tmax tiles a side, which the 50 MB
// L2 serves for neighbouring blocks; the function itself needs its inputs and
// outputs once (about 0.6-0.8 GB at n = 10000), far below the flops.  So the
// design keeps the re-reads out of HBM and leaves the kernel bound by fp32 FMA:
//   * blocks of one output tile (its 64 x 64 sub-tiles) and of neighbouring
//     tiles read the same rows, which L2 serves;
//   * null contributions (sign 0) and null terms (coefficient 0) fetch
//     nothing, where the TPU kernel fetches and discards them;
//   * a STAGES-deep cp.async ring streams the next steps' raw chunks while
//     the current one is summed and multiplied.
// Tensor cores (wgmma), TMA and warp specialisation are later work.
//
// Grid: x = output tile t, y = 64 x 64 sub-tile of the bi x bj tile.  256
// threads, 4 x 4 fp32 outputs each.  Inside a block the loop runs
// contributions outermost, then K blocks, then KC-deep chunks of the K
// block: the TPU walk's order (k fastest).  Every raw chunk is copied as it
// lies in memory; orientation is decided in the sum phase, which reads each
// element anyway and writes the signed sums as lsum[kk * TILE + i] and
// rsum[kk * TILE + j].  The arithmetic does not depend on STAGES, so every
// depth gives the same bits.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;           // sub-tile edge along i and along j
constexpr int KC = 16;             // contraction depth per chunk
constexpr int CHUNK = KC * TILE;   // elements of one raw chunk
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int EPT = CHUNK / THREADS;
constexpr int MAX_CONTRIB = 128;   // contribution slots a block can list

enum Kind { ATA = 0, SYMM = 1 };

// Raw chunks each right term holds in a ring slot: a symm term on a diagonal
// tile under diag_sym reads the stored chunk and its mirror.
__host__ __device__ constexpr int right_chunks(int kind) { return kind == SYMM ? 2 : 1; }

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

// Start the copy of a ROWS x COLS chunk at (row0, col0) of a row-major
// operand with row stride ld into dst, row-major.  Rows at or past row_lim
// and columns at or past col_lim (relative to the chunk) are zero-filled;
// the operand's tile edges are multiples of 8, so a 16-byte vector lies
// wholly inside or outside.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void copy_chunk(T* dst, const T* base, long long row0, long long col0,
                                           long long ld, int row_lim, int col_lim) {
  constexpr int V = VecElems<T>::n;
  constexpr int VPR = COLS / V;
  for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
    const int rr = v / VPR;
    const int cc = (v % VPR) * V;
    const bool valid = rr < row_lim && cc < col_lim;
    const T* src = valid ? base + (row0 + rr) * ld + col0 + cc : base;
    cp_async16(dst + rr * COLS + cc, src, valid);
  }
}

// Packed lower-triangular index -> (i, j), i >= j, row-major; a root
// estimate with the integer correction of syrk._tri_decode.
__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  long long r = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if ((r + 1) * (r + 2) / 2 <= t) ++r;
  if (r * (r + 1) / 2 > t) --r;
  i = static_cast<int>(r);
  j = static_cast<int>(t - r * (r + 1) / 2);
}

// One bound program: operands, tables and geometry (strassen_fused._Spec).
struct Program {
  const void* left;     // ata: the padded A; symm: the padded X
  const void* right;    // ata: A again; symm: the packed stack of S
  void* out;
  const float* sign;
  const int* lrow;
  const int* lcol;
  const float* lsgn;
  const int* rrow;
  const int* rcol;
  const float* rsgn;
  const int* rtrn;      // symm only
  long long ldl;        // row stride of the left operand, in elements
  int n_c, n_k, tmax;
  int q_i, q_j;         // output tiles per leaf block along i and j
  int n_tj, blocks_j;   // symm: output tiles and leaf blocks along j
  int bi, bj, bc;       // output tile edges, contraction tile edge
  int diag_sym;
};

// A tri-stored right term at K block k, as _tri_term_coords decides it: the
// stored tile (max, min) of the conceptual coordinates (gr, gc), mirrored
// when the term is mirrored or gr < gc, doubled into tile + tile^t when it
// lies on the diagonal under diag_sym.
struct TriTerm {
  long long row;        // first stack row of the stored tile
  bool mirrored, diag;
};

__device__ __forceinline__ TriTerm tri_term(const Program& P, int tab, int p, int k, int jq) {
  const bool trn = P.rtrn[tab + p] != 0;
  const long long gr = static_cast<long long>(P.rrow[tab + p]) * P.q_j + (trn ? jq : k);
  const long long gc = static_cast<long long>(P.rcol[tab + p]) * P.q_j + (trn ? k : jq);
  const long long fr = gr > gc ? gr : gc;
  const long long fc = gr > gc ? gc : gr;
  return {(fr * (fr + 1) / 2 + fc) * P.bj, trn || gr < gc, P.diag_sym != 0 && gr == gc};
}

size_t smem_bytes(int kind, int tmax, int left_bytes, int right_bytes, int stages) {
  return static_cast<size_t>(stages) * tmax * CHUNK *
             (left_bytes + right_chunks(kind) * right_bytes)  // raw rings
         + 2 * CHUNK * sizeof(float)                          // signed sums
         + MAX_CONTRIB * sizeof(int);                         // live contributions
}

template <int KIND, typename Tl, typename Tr, typename Tout, int STAGES>
__global__ void __launch_bounds__(THREADS) leaf_program_kernel(const Program P) {
  constexpr int RC = right_chunks(KIND);
  extern __shared__ __align__(16) unsigned char smem[];
  Tl* lring = reinterpret_cast<Tl*>(smem);
  const size_t lring_bytes = static_cast<size_t>(STAGES) * P.tmax * CHUNK * sizeof(Tl);
  Tr* rring = reinterpret_cast<Tr*>(smem + lring_bytes);
  float* lsum = reinterpret_cast<float*>(
      smem + lring_bytes + static_cast<size_t>(STAGES) * P.tmax * RC * CHUNK * sizeof(Tr));
  float* rsum = lsum + CHUNK;
  int* live = reinterpret_cast<int*>(rsum + CHUNK);
  const Tl* left = static_cast<const Tl*>(P.left);
  const Tr* right = static_cast<const Tr*>(P.right);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int gi, gj, ld;
  if constexpr (KIND == ATA) {
    tri_decode(blockIdx.x, gi, gj);
    const int di = gi / P.q_i, dj = gj / P.q_j;
    ld = di * (di + 1) / 2 + dj;
  } else {
    gi = blockIdx.x / P.n_tj;
    gj = blockIdx.x % P.n_tj;
    ld = (gi / P.q_i) * P.blocks_j + gj / P.q_j;
  }
  const int n_sub_j = (P.bj + TILE - 1) / TILE;
  const int i0 = (blockIdx.y / n_sub_j) * TILE;
  const int j0 = (blockIdx.y % n_sub_j) * TILE;
  const int iq = gi % P.q_i, jq = gj % P.q_j;
  const int n_c = P.n_c, tmax = P.tmax;

  // The live contributions of this tile's leaf destination, in slot order.
  if (tid == 0) {
    int cnt = 0;
    for (int c = 0; c < n_c; ++c)
      if (P.sign[ld * n_c + c] != 0.f) live[cnt++] = c;
    live[MAX_CONTRIB - 1] = cnt;
  }
  __syncthreads();
  const int n_live = live[MAX_CONTRIB - 1];
  const int n_kc = (P.bc + KC - 1) / KC;
  const int steps_per_c = P.n_k * n_kc;
  const int n_steps = n_live * steps_per_c;

  // Start the copies of step s into ring slot s % STAGES, one raw chunk per
  // live term (two for a diagonal symm term under diag_sym).
  auto start_copies = [&](int s) {
    const int c = live[s / steps_per_c];
    const int rem = s % steps_per_c;
    const int k = rem / n_kc;
    const int kc = (rem % n_kc) * KC;
    const int tab = (ld * n_c + c) * tmax;
    Tl* lslot = lring + static_cast<size_t>(s % STAGES) * tmax * CHUNK;
    Tr* rslot = rring + static_cast<size_t>(s % STAGES) * tmax * RC * CHUNK;
    for (int p = 0; p < tmax; ++p) {
      if (P.lsgn[tab + p] == 0.f) continue;
      if constexpr (KIND == ATA)  // rows (lrow*n_k + k)*bk + kc.., cols (lcol*q + iq)*bn + i0..
        copy_chunk<Tl, KC, TILE>(lslot + p * CHUNK, left,
                                 (static_cast<long long>(P.lrow[tab + p]) * P.n_k + k) * P.bc + kc,
                                 (static_cast<long long>(P.lcol[tab + p]) * P.q_i + iq) * P.bi + i0,
                                 P.ldl, P.bc - kc, P.bi - i0);
      else  // X rows (lrow*q_i + iq)*bi + i0.., cols (lcol*n_k + k)*bc + kc..
        copy_chunk<Tl, TILE, KC>(lslot + p * CHUNK, left,
                                 (static_cast<long long>(P.lrow[tab + p]) * P.q_i + iq) * P.bi + i0,
                                 (static_cast<long long>(P.lcol[tab + p]) * P.n_k + k) * P.bc + kc,
                                 P.ldl, P.bi - i0, P.bc - kc);
    }
    for (int p = 0; p < tmax; ++p) {
      if (P.rsgn[tab + p] == 0.f) continue;
      Tr* dst = rslot + p * RC * CHUNK;
      if constexpr (KIND == ATA) {
        copy_chunk<Tr, KC, TILE>(dst, right,
                                 (static_cast<long long>(P.rrow[tab + p]) * P.n_k + k) * P.bc + kc,
                                 (static_cast<long long>(P.rcol[tab + p]) * P.q_j + jq) * P.bj + j0,
                                 P.ldl, P.bc - kc, P.bj - j0);
      } else {
        const TriTerm t = tri_term(P, tab, p, k, jq);
        if (!t.mirrored || t.diag)  // stored rows kc.., cols j0..
          copy_chunk<Tr, KC, TILE>(dst, right, t.row + kc, j0, P.bj, P.bc - kc, P.bj - j0);
        if (t.mirrored || t.diag)   // stored rows j0.., cols kc..
          copy_chunk<Tr, TILE, KC>(dst + CHUNK, right, t.row + j0, kc, P.bj, P.bj - j0,
                                   P.bc - kc);
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
    const Tl* lslot = lring + static_cast<size_t>(s % STAGES) * tmax * CHUNK;
    const Tr* rslot = rring + static_cast<size_t>(s % STAGES) * tmax * RC * CHUNK;
    // Signed sums in fp32, terms in table order; no FMA contraction, so the
    // sums round as term = coef * x; sum += term do.
    if constexpr (KIND == ATA) {
      for (int e = tid; e < CHUNK; e += THREADS) {
        float l = 0.f, r = 0.f;
        for (int p = 0; p < tmax; ++p) {
          const float cl = P.lsgn[tab + p];
          if (cl != 0.f) l = __fadd_rn(l, __fmul_rn(cl, to_f32(lslot[p * CHUNK + e])));
          const float cr = P.rsgn[tab + p];
          if (cr != 0.f) r = __fadd_rn(r, __fmul_rn(cr, to_f32(rslot[p * CHUNK + e])));
        }
        lsum[e] = l;
        rsum[e] = r;
      }
    } else {
      const int k = (s % steps_per_c) / n_kc;
      // Each thread owns EPT elements (kk, j) of the KC x TILE sums, laid
      // out so that a warp's 32 lanes hit 32 banks both where a chunk is
      // read as stored ([kk][j], j = lane + 32 * (u & 1)) and where it is
      // read mirrored ([j][kk], kk skewed by lane / 2).  Ownership is fixed
      // for the whole step, so each element still sums its terms in order.
      const int lane = tid % 32, warp = tid / 32;
      int at[EPT], mirror_at[EPT];
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const int j = lane + 32 * (u & 1);
        const int kk = (warp * 2 + (u >> 1) + (lane >> 1)) % KC;
        at[u] = kk * TILE + j;
        mirror_at[u] = j * KC + kk;
      }
      float l[EPT], r[EPT];
#pragma unroll
      for (int u = 0; u < EPT; ++u) l[u] = r[u] = 0.f;
      // X chunks are TILE x KC as stored: element (kk, i) sits at [i][kk].
      for (int p = 0; p < tmax; ++p) {
        const float cl = P.lsgn[tab + p];
        if (cl == 0.f) continue;
        const Tl* src = lslot + p * CHUNK;
#pragma unroll
        for (int u = 0; u < EPT; ++u)
          l[u] = __fadd_rn(l[u], __fmul_rn(cl, to_f32(src[mirror_at[u]])));
      }
      // Right element (kk, j): stored[kk][j] in the stored chunk,
      // stored[j][kk] in the mirrored one.
      for (int p = 0; p < tmax; ++p) {
        const float cr = P.rsgn[tab + p];
        if (cr == 0.f) continue;
        const TriTerm t = tri_term(P, tab, p, k, jq);
        const Tr* st = rslot + p * RC * CHUNK;
        const Tr* mi = st + CHUNK;
#pragma unroll
        for (int u = 0; u < EPT; ++u) {
          const float sv = (!t.mirrored || t.diag) ? to_f32(st[at[u]]) : 0.f;
          const float mv = (t.mirrored || t.diag) ? to_f32(mi[mirror_at[u]]) : 0.f;
          float v = t.mirrored ? mv : sv;
          if (t.diag) v = t.mirrored ? __fadd_rn(mv, sv) : __fadd_rn(sv, mv);  // tile + tile^t
          r[u] = __fadd_rn(r[u], __fmul_rn(cr, v));
        }
      }
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        lsum[at[u]] = l[u];
        rsum[at[u]] = r[u];
      }
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
      const float sg = P.sign[ld * n_c + c];
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

  // One store per output element: ata writes the packed stack row t*bn + i,
  // col j; symm the dense grid row gi*bi + i, col gj*bj + j.
  Tout* out = static_cast<Tout*>(P.out);
  const long long row_base = KIND == ATA ? static_cast<long long>(blockIdx.x) * P.bi
                                         : static_cast<long long>(gi) * P.bi;
  const long long col_base = KIND == ATA ? 0 : static_cast<long long>(gj) * P.bj;
  const long long ldo = KIND == ATA ? P.bj : static_cast<long long>(P.n_tj) * P.bj;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oi = i0 + ty * 4 + i;
    if (oi >= P.bi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = j0 + tx * 4 + j;
      if (oj < P.bj) store(out + (row_base + oi) * ldo + col_base + oj, acc[i][j]);
    }
  }
}

template <int KIND, typename Tl, typename Tr, typename Tout, int S>
cudaError_t launch(const Program& P, int n_out, cudaStream_t stream) {
  auto kernel = leaf_program_kernel<KIND, Tl, Tr, Tout, S>;
  const size_t smem = smem_bytes(KIND, P.tmax, sizeof(Tl), sizeof(Tr), S);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_sub_i = (P.bi + TILE - 1) / TILE, n_sub_j = (P.bj + TILE - 1) / TILE;
  const dim3 grid(n_out, n_sub_i * n_sub_j);
  kernel<<<grid, THREADS, smem, stream>>>(P);
  return cudaGetLastError();
}

template <int KIND, typename Tl, typename Tr, typename Tout>
cudaError_t by_stages(int stages, const Program& P, int n_out, cudaStream_t s) {
  switch (stages) {
    case 1: return launch<KIND, Tl, Tr, Tout, 1>(P, n_out, s);
    case 2: return launch<KIND, Tl, Tr, Tout, 2>(P, n_out, s);
    case 3: return launch<KIND, Tl, Tr, Tout, 3>(P, n_out, s);
    case 4: return launch<KIND, Tl, Tr, Tout, 4>(P, n_out, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <int KIND, typename Tl, typename Tr>
cudaError_t by_out(int out_dtype, int stages, const Program& P, int n_out, cudaStream_t s) {
  if (out_dtype == 0) return by_stages<KIND, Tl, Tr, float>(stages, P, n_out, s);
  if (out_dtype == 1) return by_stages<KIND, Tl, Tr, __nv_bfloat16>(stages, P, n_out, s);
  return cudaErrorInvalidValue;
}

template <typename Tl>
cudaError_t symm_by_right(int r_dtype, int out_dtype, int stages, const Program& P, int n_out,
                          cudaStream_t s) {
  if (r_dtype == 0) return by_out<SYMM, Tl, float>(out_dtype, stages, P, n_out, s);
  if (r_dtype == 1) return by_out<SYMM, Tl, __nv_bfloat16>(out_dtype, stages, P, n_out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the wrapper refuses > 227 KB).
// kind: 0 = ata, 1 = symm; left_bytes / right_bytes: operand element sizes.
size_t leaf_program_smem_bytes(int kind, int tmax, int left_bytes, int right_bytes, int stages) {
  return smem_bytes(kind, tmax, left_bytes, right_bytes, stages);
}

int leaf_program_max_contributions() { return MAX_CONTRIB - 1; }

const char* leaf_program_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The ata kind.  `a` is the padded (M, lda) operand, `out` the (n_tri*bn, bn)
// packed stack.
int leaf_program_ata(const void* a, void* out, const void* sign, const void* lrow,
                     const void* lcol, const void* lsgn, const void* rrow, const void* rcol,
                     const void* rsgn, long long lda, int n_tri, int n_c, int n_k, int tmax,
                     int q, int bn, int bk, int in_dtype, int out_dtype, int stages,
                     void* stream) {
  if (n_c > MAX_CONTRIB - 1 || bn % 8 != 0 || bn < 8 || bk < 1 || tmax < 1)
    return cudaErrorInvalidValue;
  Program P{a, a, out,
            static_cast<const float*>(sign), static_cast<const int*>(lrow),
            static_cast<const int*>(lcol), static_cast<const float*>(lsgn),
            static_cast<const int*>(rrow), static_cast<const int*>(rcol),
            static_cast<const float*>(rsgn), nullptr,
            lda, n_c, n_k, tmax, q, q, 0, 0, bn, bn, bk, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return by_out<ATA, float, float>(out_dtype, stages, P, n_tri, s);
  if (in_dtype == 1)
    return by_out<ATA, __nv_bfloat16, __nv_bfloat16>(out_dtype, stages, P, n_tri, s);
  return cudaErrorInvalidValue;
}

// The symm kind.  `x` is the padded (M, ldx) left operand, `s` the packed
// (T(T+1)/2 * bj, bj) stack, `out` the dense ((n_out / n_tj) * bi, n_tj * bj)
// grid.  bc must equal bj (the stack's tile edge).
int leaf_program_symm(const void* x, const void* s_packed, void* out, const void* sign,
                      const void* lrow, const void* lcol, const void* lsgn, const void* rrow,
                      const void* rcol, const void* rsgn, const void* rtrn, long long ldx,
                      int n_out, int n_c, int n_k, int tmax, int q_i, int q_j, int n_tj,
                      int blocks_j, int bi, int bj, int bc, int diag_sym, int l_dtype,
                      int r_dtype, int out_dtype, int stages, void* stream) {
  if (n_c > MAX_CONTRIB - 1 || bj % 8 != 0 || bj < 8 || bc != bj || bi < 1 || tmax < 1 ||
      n_tj < 1)
    return cudaErrorInvalidValue;
  Program P{x, s_packed, out,
            static_cast<const float*>(sign), static_cast<const int*>(lrow),
            static_cast<const int*>(lcol), static_cast<const float*>(lsgn),
            static_cast<const int*>(rrow), static_cast<const int*>(rcol),
            static_cast<const float*>(rsgn), static_cast<const int*>(rtrn),
            ldx, n_c, n_k, tmax, q_i, q_j, n_tj, blocks_j, bi, bj, bc, diag_sym};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l_dtype == 0) return symm_by_right<float>(r_dtype, out_dtype, stages, P, n_out, st);
  if (l_dtype == 1)
    return symm_by_right<__nv_bfloat16>(r_dtype, out_dtype, stages, P, n_out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
