// leaf_program.cu — the fused leaf-program kernel of the PyTorch port, for the gram programs
// with transposed destinations (the dps gram).
//
// Replaces both TPU kernels of the JAX package, for the ata, aat and rank_k kinds of the dps
// gram:
//   src/repro/kernels/strassen_fused.py:474 _leaf_kernel       (pipeline_depth 1)
//   src/repro/kernels/strassen_fused.py:533 _pipelined_kernel  (pipeline_depth >= 2)
// Every other program, symm, matmul and the gram kinds of the strassen gram among them, runs
// csrc/leaf_products.cu, which computes each leaf product once; a transposed destination
// (72 of the dps gram's 184 contributions at levels 2) is a leaf product added transposed,
// which its op walk does not express.  This kernel computes what the TPU kernels compute:
// for every output tile,
//   acc = seed + sum over contributions c, K blocks k of
//           sign[ld, c] * op_L(sum_p lsgn[ld,c,p] L_p) op_R(sum_q rsgn[ld,c,q] R_q)
// with the signed sums formed in fp32 after upcasting the operands, and the
// tile stored once.  The eight tables are the host's lowering of the leaf
// program (strassen_fused._program_tables), where a transposed destination
// is already the straight contribution with its sides swapped.  The kinds
// differ only in how each side's tiles lie in memory and whether a seed
// starts the sum (the JAX _Spec's left_trans, right_trans, accumulate), and
// the kernel takes those per side:
//
//   kind    left tile as stored   right tile as stored          seed
//   ata     K x i (A, read A^t)   K x j (A)                     -
//   aat     i x K (A)             j x K (A again, read A^t)     -
//   rank_k  K x i                 K x j                         incoming stack
//
// The output is the packed lower-triangular tile stack (tile t decoded to
// (i, j), i >= j).  The rank_k seed is the incoming packed stack: each block
// reads its own sub-tile before the contribution loop and writes it after, so
// the seed may be the output (the in-place update of
// ops.rank_k_update(donate=True)).
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): the
// non-null (tile, contribution, K) steps do 2*bi*bj*bc flops each on the fp32
// CUDA cores (67 TFLOP/s).  Each step reads tmax tiles a side, which the 50 MB
// L2 serves for neighbouring blocks; the functions themselves need their
// inputs and outputs once (0.4-1.2 GB at n = 10000), far below the flops: at
// n = 10000 the least flops take 14.9 ms (ata, aat) and the bytes 0.1-0.4 ms.
// So every kind is bound by fp32 FMA, and the design keeps the re-reads out of
// HBM:
//   * blocks of one output tile (its 64 x 64 sub-tiles) and of neighbouring
//     tiles read the same rows, which L2 serves;
//   * null contributions (sign 0) and null terms (coefficient 0) fetch
//     nothing, where the TPU kernel fetches and discards them;
//   * a STAGES-deep cp.async ring streams the next steps' raw chunks while
//     the current one is summed and multiplied;
//   * the kernel is held to 80 registers, 3 blocks an SM, so more warps hide
//     the sum phase's shared-memory latency.
// It recomputes a leaf product for every destination it feeds (184
// contributions at levels 2 for the dps gram); tensor cores (wgmma), TMA and
// warp specialisation are later work.
//
// Grid: x = output tile t, y = 64 x 64 sub-tile of the bi x bj tile.  256
// threads, 4 x 4 fp32 outputs each.  Inside a block the loop runs
// contributions outermost, then K blocks, then KC-deep chunks of the K
// block: the TPU walk's order (k fastest).  Every raw chunk is copied as it
// lies in memory (KC x TILE or TILE x KC); orientation is decided in the sum
// phase, which reads each element anyway, with swapped strides where a chunk
// lies TILE x KC, and writes the signed sums as lsum[kk * TILE + i] and
// rsum[kk * TILE + j].  The arithmetic does not depend on STAGES, so every
// depth gives the same bits.
//
// Orientation is a field of the launch, not a template parameter: only an
// element type and the ring depth are templated, 32 instantiations in all.
//
// Interface: plain C, loaded with ctypes.  The launcher returns
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

// How the right side's tiles lie: dense K x j or dense j x K.  The C entry
// refuses RIGHT_TRI, the packed stack of the symm kind (leaf_products.cu).
enum RightLayout { RIGHT_KJ = 0, RIGHT_JK = 1, RIGHT_TRI = 2 };

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
// a chunk's column edge and the row stride are multiples of 8, so a 16-byte
// vector lies wholly inside or outside.
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

// One bound program: operands, tables, geometry and orientation
// (strassen_fused._Spec).
struct Program {
  const void* left;
  const void* right;
  const void* seed;     // rank_k: the incoming packed stack (may equal out); else null
  void* out;
  const float* sign;
  const int* lrow;
  const int* lcol;
  const float* lsgn;
  const int* rrow;
  const int* rcol;
  const float* rsgn;
  long long ldl, ldr;   // row strides of the operands, in elements
  int n_c, n_k, tmax;
  int q_i, q_j;         // output tiles per leaf block along i and j
  int bi, bj, bc;       // output tile edges, contraction tile edge
  int left_trans;       // left tiles stored K x i (else i x K)
  int right_jk;         // right tiles stored j x K (else K x j)
  int seed_bf16;        // the seed's element type (else fp32)
};

size_t smem_bytes(int tmax, int left_bytes, int right_bytes, int stages) {
  return static_cast<size_t>(stages) * tmax * CHUNK * (left_bytes + right_bytes)  // raw rings
         + 2 * CHUNK * sizeof(float)                                             // signed sums
         + MAX_CONTRIB * sizeof(int);                          // live contributions
}

// Registers bound the kernel: left to itself the compiler takes 121-128 a
// thread, 2 blocks an SM.  Capped at 3 blocks an SM (80 registers, a few
// hundred bytes of spills) it ran 6-8 % faster on the H100.
template <typename Tl, typename Tr, typename Tout, int STAGES>
__global__ void __launch_bounds__(THREADS, 3) leaf_program_kernel(const Program P) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tl* lring = reinterpret_cast<Tl*>(smem);
  const size_t lring_bytes = static_cast<size_t>(STAGES) * P.tmax * CHUNK * sizeof(Tl);
  Tr* rring = reinterpret_cast<Tr*>(smem + lring_bytes);
  float* lsum = reinterpret_cast<float*>(
      smem + lring_bytes + static_cast<size_t>(STAGES) * P.tmax * CHUNK * sizeof(Tr));
  float* rsum = lsum + CHUNK;
  int* live = reinterpret_cast<int*>(rsum + CHUNK);
  const Tl* left = static_cast<const Tl*>(P.left);
  const Tr* right = static_cast<const Tr*>(P.right);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int gi, gj;
  tri_decode(blockIdx.x, gi, gj);
  const int di = gi / P.q_i, dj = gj / P.q_j;
  const int ld = di * (di + 1) / 2 + dj;
  const int n_sub_j = (P.bj + TILE - 1) / TILE;
  const int i0 = (blockIdx.y / n_sub_j) * TILE;
  const int j0 = (blockIdx.y % n_sub_j) * TILE;
  const int iq = gi % P.q_i, jq = gj % P.q_j;
  const int n_c = P.n_c, tmax = P.tmax;
  const bool right_jk = P.right_jk != 0;

  // Where this thread's outputs lie: tile t at stack rows t*bi...
  const long long row_base = static_cast<long long>(blockIdx.x) * P.bi;
  const long long ldo = P.bj;

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
  // live term.
  auto start_copies = [&](int s) {
    const int c = live[s / steps_per_c];
    const int rem = s % steps_per_c;
    const int k = rem / n_kc;
    const int kc = (rem % n_kc) * KC;
    const int tab = (ld * n_c + c) * tmax;
    Tl* lslot = lring + static_cast<size_t>(s % STAGES) * tmax * CHUNK;
    Tr* rslot = rring + static_cast<size_t>(s % STAGES) * tmax * CHUNK;
    for (int p = 0; p < tmax; ++p) {
      if (P.lsgn[tab + p] == 0.f) continue;
      const long long lr = P.lrow[tab + p], lc = P.lcol[tab + p];
      if (P.left_trans)  // K x i: rows (lrow*n_k + k)*bc + kc.., cols (lcol*q_i + iq)*bi + i0..
        copy_chunk<Tl, KC, TILE>(lslot + p * CHUNK, left, (lr * P.n_k + k) * P.bc + kc,
                                 (lc * P.q_i + iq) * P.bi + i0, P.ldl, P.bc - kc, P.bi - i0);
      else  // i x K: rows (lrow*q_i + iq)*bi + i0.., cols (lcol*n_k + k)*bc + kc..
        copy_chunk<Tl, TILE, KC>(lslot + p * CHUNK, left, (lr * P.q_i + iq) * P.bi + i0,
                                 (lc * P.n_k + k) * P.bc + kc, P.ldl, P.bi - i0, P.bc - kc);
    }
    for (int p = 0; p < tmax; ++p) {
      if (P.rsgn[tab + p] == 0.f) continue;
      Tr* dst = rslot + p * CHUNK;
      const long long rr = P.rrow[tab + p], rc = P.rcol[tab + p];
      if (right_jk)  // j x K: rows (rrow*q_j + jq)*bj + j0.., cols (rcol*n_k + k)*bc + kc..
        copy_chunk<Tr, TILE, KC>(dst, right, (rr * P.q_j + jq) * P.bj + j0,
                                 (rc * P.n_k + k) * P.bc + kc, P.ldr, P.bj - j0, P.bc - kc);
      else  // K x j: rows (rrow*n_k + k)*bc + kc.., cols (rcol*q_j + jq)*bj + j0..
        copy_chunk<Tr, KC, TILE>(dst, right, (rr * P.n_k + k) * P.bc + kc,
                                 (rc * P.q_j + jq) * P.bj + j0, P.ldr, P.bc - kc, P.bj - j0);
    }
  };

  // Each thread owns EPT elements (kk, x) of the KC x TILE sums, laid out so
  // that a warp's 32 lanes hit 32 banks both where a chunk is read as it lies
  // KC x TILE ([kk][x], x = lane + 32 * (u & 1)) and where it lies TILE x KC
  // ([x][kk], kk skewed by lane / 2).  Ownership is fixed for the whole
  // kernel, so each element sums its terms in table order.
  int at[EPT], mirror_at[EPT], lat[EPT], rat[EPT];
  {
    const int lane = tid % 32, warp = tid / 32;
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int x = lane + 32 * (u & 1);
      const int kk = (warp * 2 + (u >> 1) + (lane >> 1)) % KC;
      at[u] = kk * TILE + x;
      mirror_at[u] = x * KC + kk;
      lat[u] = P.left_trans ? at[u] : mirror_at[u];
      rat[u] = right_jk ? mirror_at[u] : at[u];
    }
  }

  // The seed: this thread's outputs of the incoming tile, upcast to fp32.
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = part[i][j] = 0.f;
      const int oi = i0 + ty * 4 + i, oj = j0 + tx * 4 + j;
      if (P.seed != nullptr && oi < P.bi && oj < P.bj) {
        const long long at_out = (row_base + oi) * ldo + oj;
        acc[i][j] = P.seed_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(P.seed)[at_out])
                                : static_cast<const float*>(P.seed)[at_out];
      }
    }

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
    const Tr* rslot = rring + static_cast<size_t>(s % STAGES) * tmax * CHUNK;
    // Signed sums in fp32, terms in table order; no FMA contraction, so the
    // sums round as term = coef * x; sum += term do.
    float l[EPT], r[EPT];
#pragma unroll
    for (int u = 0; u < EPT; ++u) l[u] = r[u] = 0.f;
    for (int p = 0; p < tmax; ++p) {
      const float cl = P.lsgn[tab + p];
      if (cl == 0.f) continue;
      const Tl* src = lslot + p * CHUNK;
#pragma unroll
      for (int u = 0; u < EPT; ++u) l[u] = __fadd_rn(l[u], __fmul_rn(cl, to_f32(src[lat[u]])));
    }
    for (int p = 0; p < tmax; ++p) {
      const float cr = P.rsgn[tab + p];
      if (cr == 0.f) continue;
      const Tr* src = rslot + p * CHUNK;
#pragma unroll
      for (int u = 0; u < EPT; ++u) r[u] = __fadd_rn(r[u], __fmul_rn(cr, to_f32(src[rat[u]])));
    }
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      lsum[at[u]] = l[u];
      rsum[at[u]] = r[u];
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

  // One store per output element, where its seed was read.
  Tout* out = static_cast<Tout*>(P.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oi = i0 + ty * 4 + i;
    if (oi >= P.bi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oj = j0 + tx * 4 + j;
      if (oj < P.bj) store(out + (row_base + oi) * ldo + oj, acc[i][j]);
    }
  }
}

template <typename Tl, typename Tr, typename Tout, int S>
cudaError_t launch(const Program& P, int n_out, cudaStream_t stream) {
  auto kernel = leaf_program_kernel<Tl, Tr, Tout, S>;
  const size_t smem = smem_bytes(P.tmax, sizeof(Tl), sizeof(Tr), S);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_sub_i = (P.bi + TILE - 1) / TILE, n_sub_j = (P.bj + TILE - 1) / TILE;
  const dim3 grid(n_out, n_sub_i * n_sub_j);
  kernel<<<grid, THREADS, smem, stream>>>(P);
  return cudaGetLastError();
}

template <typename Tl, typename Tr, typename Tout>
cudaError_t by_stages(int stages, const Program& P, int n_out, cudaStream_t s) {
  switch (stages) {
    case 1: return launch<Tl, Tr, Tout, 1>(P, n_out, s);
    case 2: return launch<Tl, Tr, Tout, 2>(P, n_out, s);
    case 3: return launch<Tl, Tr, Tout, 3>(P, n_out, s);
    case 4: return launch<Tl, Tr, Tout, 4>(P, n_out, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <typename Tl, typename Tr>
cudaError_t by_out(int out_dtype, int stages, const Program& P, int n_out, cudaStream_t s) {
  if (out_dtype == 0) return by_stages<Tl, Tr, float>(stages, P, n_out, s);
  if (out_dtype == 1) return by_stages<Tl, Tr, __nv_bfloat16>(stages, P, n_out, s);
  return cudaErrorInvalidValue;
}

template <typename Tl>
cudaError_t by_right(int r_dtype, int out_dtype, int stages, const Program& P, int n_out,
                     cudaStream_t s) {
  if (r_dtype == 0) return by_out<Tl, float>(out_dtype, stages, P, n_out, s);
  if (r_dtype == 1) return by_out<Tl, __nv_bfloat16>(out_dtype, stages, P, n_out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the wrapper refuses > 227 KB).
// left_bytes / right_bytes: operand element sizes.
size_t leaf_program_smem_bytes(int tmax, int left_bytes, int right_bytes, int stages) {
  return smem_bytes(tmax, left_bytes, right_bytes, stages);
}

int leaf_program_max_contributions() { return MAX_CONTRIB - 1; }

const char* leaf_program_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One bound program of a gram kind.  `left` / `right` are the padded operands
// (row strides ldl / ldr), `seed` the incoming packed stack or null, `out` the
// packed (n_out*bi, bj) stack.  left_trans: left tiles stored K x i.
// right_layout: 0 K x j, 1 j x K.  The packed tri right side (2) and a dense
// output (out_tri 0) are the symm and matmul kinds', which leaf_products.cu
// runs (as it runs every gram program without a transposed destination):
// both are refused, and rtrn, n_tj, blocks_j and diag_sym are ignored.
// dtype codes: 0 fp32, 1 bf16.  A chunk's column edge (bi or bc on the left,
// bj or bc on the right) must be a multiple of 8.
int leaf_program_launch(const void* left, const void* right, const void* seed, void* out,
                        const void* sign, const void* lrow, const void* lcol, const void* lsgn,
                        const void* rrow, const void* rcol, const void* rsgn, const void* rtrn,
                        long long ldl, long long ldr, int n_out, int n_c, int n_k, int tmax,
                        int q_i, int q_j, int n_tj, int blocks_j, int bi, int bj, int bc,
                        int left_trans, int right_layout, int out_tri, int diag_sym,
                        int l_dtype, int r_dtype, int seed_dtype, int out_dtype, int stages,
                        void* stream) {
  const int l_cols = left_trans ? bi : bc;
  const int r_cols = right_layout == RIGHT_JK ? bc : bj;
  if (n_c > MAX_CONTRIB - 1 || tmax < 1 || n_out < 1 || bi < 8 || bj < 8 || bc < 8 ||
      l_cols % 8 != 0 || r_cols % 8 != 0 || right_layout < RIGHT_KJ ||
      right_layout >= RIGHT_TRI || !out_tri ||
      (seed != nullptr && seed_dtype != 0 && seed_dtype != 1))
    return cudaErrorInvalidValue;
  (void)rtrn, (void)n_tj, (void)blocks_j, (void)diag_sym;
  Program P{left, right, seed, out,
            static_cast<const float*>(sign), static_cast<const int*>(lrow),
            static_cast<const int*>(lcol), static_cast<const float*>(lsgn),
            static_cast<const int*>(rrow), static_cast<const int*>(rcol),
            static_cast<const float*>(rsgn),
            ldl, ldr, n_c, n_k, tmax, q_i, q_j, bi, bj, bc,
            left_trans, right_layout == RIGHT_JK, seed_dtype == 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l_dtype == 0) return by_right<float>(r_dtype, out_dtype, stages, P, n_out, s);
  if (l_dtype == 1) return by_right<__nv_bfloat16>(r_dtype, out_dtype, stages, P, n_out, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
