// leaf_products.cu — the fused leaf program, each leaf product computed once: every kind
// (ata, aat, rank_k of every gram, symm, matmul).
//
// Replaces both TPU kernels of the JAX package:
//   src/repro/kernels/strassen_fused.py:474 _leaf_kernel       (pipeline_depth 1)
//   src/repro/kernels/strassen_fused.py:533 _pipelined_kernel  (pipeline_depth >= 2)
// It computes what they compute: every destination block D of the output is
//   D = seed + sum over the leaf ops o that feed D, in op order, of sign[o, D] * P_o (or P_o^t),
//   P_o = sum over K blocks k of op_L(sum_p lsgn[o,p] L_p)_k op_R(sum_q rsgn[o,q] R_q)_k,
// with the signed operand sums formed in fp32 after upcasting, and the seed the incoming
// packed stack of rank_k (0 otherwise).  The TPU kernel walks output tiles and recomputes P_o
// for every destination it feeds (144 products for 49 ops at levels 2 for symm and matmul, 48
// for 38 for the strassen gram, 184 for 31 for the dps gram); this kernel walks the ops and
// computes each P_o once per output position.
//
// The tables are the host's op-indexed lowering of the leaf program
// (strassen_fused._op_tables): per op its left terms (row, col, coef), right terms (row, col,
// coef, mirror), destinations (leaf index, sign, flags: the slot is the first or the last to
// feed that destination, in the order of an element on or below its leaf block's diagonal and,
// two bits up, of one above it; transposed: the destination takes P_o^t) and whether every
// destination is a straight one on a diagonal leaf block of a packed output.  How each side
// lies in memory is a field of the launch:
//
//   kind    left tile as stored          right tile as stored
//   matmul  K x i if trans_a, else i x K  j x K if trans_b, else K x j
//   symm    i x K (X)                     packed lower-triangular stack of S: the stored tile
//                                         (max(gr, gc), min(gr, gc)) of a term's conceptual
//                                         coordinates, mirrored when the term says so or
//                                         gr < gc; a diagonal tile under diag_sym is tile +
//                                         tile^t
//   ata     K x i (A, read A^t)           K x j (A)
//   rank_k  K x i                         K x j, seeded by the incoming stack
//   aat     i x K (A)                     j x K (A again, read A^t)
//
// The gram kinds write the packed lower-triangular tile stack (out_tri): position (iq, jq) of
// leaf destination (di, dj) is global tile (gi, gj) = (di q + iq, dj q + jq), stored at rows
// (gi (gi + 1) / 2 + gj) bi of the (n_out bi, bj) stack.  A position with iq < jq holds no tile
// of a diagonal leaf block: it writes nothing there and skips every op that feeds only
// diagonal blocks, straight (the 16 syrk ops of 38 at levels 2 of the strassen gram).  A
// diagonal tile (iq == jq of a diagonal leaf block) is computed and stored whole, as the TPU
// kernel stores it.  The rank_k seed is read where a slot first feeds an element, by the
// thread that then writes that element, so the seed may be the output (the in-place update of
// ops.rank_k_update(donate=True)).
//
// A transposed destination (the dps gram's: 72 of its 184 at levels 2) takes at position
// (iq, jq) the transpose of the op's product at the mirror position (jq, iq): both sides of a
// gram kind read the same A the same way.  Where the tables have one, the launch runs in pair
// mode: a block owns a TILE x TILE sub-tile S on or below the diagonal of the leaf blocks (in
// their coordinates) and its mirror S^t, in every destination.  It walks each op once at S and
// once at S^t; P(S) goes straight into S and transposed into S^t, P(S^t) straight into S^t
// and transposed into S.  An element on or below the diagonal so takes an op's straight slots
// first, one above it the transposed ones first: the order strassen_fused._op_tables fixes
// and _leaf_products_plain follows.  A sub-tile that is its own mirror (on the diagonal) is
// walked once and written in two passes, one barrier apart, since the partner of an element
// is held by another thread.  Transposed writes are per element (a thread's 4-wide row is a
// column there); staging them through shared memory is later work.  Pair mode does not split
// the ragged last wave into quarters.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): the leaf products, each
// computed once, on the fp32 CUDA cores.  At n = 10000 (padded 10240, levels 2, 49 products
// of 2560^3) that is 1.644e12 flops for symm and matmul, 24.540 ms at 67 TFLOP/s; 3080 tile
// products of 256^2 x 2560, 1.0335e12 flops, for the strassen gram's ata and aat, and 3100,
// 1.0402e12 flops, for the dps gram's; the inputs and the output once are 0.4-1.3 GB, 0.1-0.4
// ms at 3.35 TB/s.  What the design does about it:
//   * a block owns one output position (a mirror pair in pair mode), (iq, jq) inside a leaf
//     block plus a TILE x TILE sub-tile of that output tile, at every leaf destination; it runs
//     each op's whole K range once and adds sign * P_o into each destination of the op.  Only
//     this block touches those elements, so the read-modify-write in global memory needs no
//     atomics and is deterministic; a slot's first contribution to an element stores (onto the
//     seed, if any), its last rounds into the output type (a bf16 output accumulates in an fp32
//     workspace until then);
//   * the sum phase costs KC x TILE elements a term, the product KC x TILE^2 FMAs, so a
//     larger TILE amortises it: TILE is a template parameter, 64 (4 x 4 outputs a thread) or
//     128 (8 x 8 a thread), 256 threads either way;
//   * the raw chunks travel by TMA (cp.async.bulk.tensor), one box a term and chunk, into a
//     STAGES-deep ring of shared-memory slots, each with an mbarrier that counts its bytes.
//     A slot holds the widest op's terms a side; in pair mode GROUP, and a chunk of an op with
//     more takes several slots in turn, summed into the same buffer, so that a slot does not
//     cost every op the widest one's memory (the dps gram's 8 terms at levels 2, which 7 of its
//     31 ops have).  Warp 0 issues a step's boxes, one lane a term;
//   * the signed sums go to a padded ([KC][TILE + 4]), double-buffered shared buffer, so one
//     barrier a step separates summing step s from multiplying step s - 1, and warps 0-3 sum
//     first while warps 4-7 multiply first, so the FMAs of one warp issue while its neighbour
//     on the same scheduler waits on shared memory;
//   * null terms (coefficient 0) fetch nothing; no register cap.
// The packed output, the seed and the skipped ops are fields of the launch, not template
// parameters.  Pair mode is one (16 instantiations: one operand type, a dense right side), so
// that the one-position walk, which issues about as many instructions as the card can (the
// product is 1024 FFMAs a step a thread), carries none of its per-step work.  Tensor cores
// (3xTF32, wgmma) are later work: no TF32 on this fp32 path.
//
// Arithmetic, the same at every STAGES, every TILE and in either mode: each element's signed
// sum runs in term order as sum = sum + coef * x (no FMA contraction), carried from one ring
// slot of a chunk to the next through the sum buffer, and depth past the K block sums to 0;
// the product of a K block accumulates by fmaf over its depth into one fp32 part, added into
// P_o once per K block (the TPU kernel's one dot per grid step); then D = D + sign * P_o,
// each rounded, D starting from the seed or from the first contribution.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int KC = 16;             // contraction depth per chunk
constexpr int THREADS = 256;       // 16 x 16 threads
constexpr int MAX_TERMS = 8;       // terms a side: strassen_fused.MAX_OPERAND_TERMS
constexpr int GROUP = 4;           // terms a side a ring slot holds
constexpr int FIRST = 1;           // destination flags of the tables (shifted by UPPER for an
constexpr int LAST = 2;            // element above its leaf block's diagonal)
constexpr int UPPER = 2;

// What a block walks: one position, a mirror pair of positions, or a position that is its own
// mirror (the last two in pair mode).
enum Mode { SINGLE = 0, PAIR = 1, SELF = 2 };

// How the right side's tiles lie: dense K x j, dense j x K, or the packed tri stack of symm.
enum RightLayout { RIGHT_KJ = 0, RIGHT_JK = 1, RIGHT_TRI = 2 };

template <int TILE>
struct Geometry {
  static constexpr int CHUNK = KC * TILE;        // elements of one raw chunk
  static constexpr int LDS = TILE + 4;           // padded row of a summed chunk
  static constexpr int SUM = KC * LDS;           // floats of one summed chunk
  static constexpr int R = TILE / 16;            // outputs a thread owns along each axis
  static constexpr int XQ = TILE / 32;           // x groups of a thread's summed elements
};

// Raw chunks each right term holds in a ring slot: a tri term on a diagonal tile under
// diag_sym reads the stored chunk and its mirror.
__host__ __device__ constexpr int right_chunks(bool tri) { return tri ? 2 : 1; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A chunk of the walk: item u (op u / 2 at the block's position, or at its mirror where u is
// odd), K block k, chunk c of the K block.  A step is one ring slot g of the chunk's ng.
struct Chunk {
  int u, k, c;
};
struct Step : Chunk {
  int g, ng;
};

// What the sum phase needs of a step, left in shared memory with the step's ring slot by the
// warp that starts its copies: each side's live terms, their coefficients and, for a tri
// right side, whether each term reads its tile mirrored and whether it is a diagonal tile;
// whether the step is its chunk's first ring slot and its last.
struct StepTerms {
  float lc[MAX_TERMS], rc[MAX_TERMS];
  int mirrored[MAX_TERMS], diag[MAX_TERMS];
  int n_l, n_r;
  int first, last;
};

// One bound op-indexed program (strassen_fused._Spec and _op_tables); the operands are the
// launch's tensor maps.
struct Ops {
  float* ws;            // fp32 accumulator of the output (the output itself when it is fp32)
  void* out;
  const void* seed;     // rank_k: the incoming packed stack (may be out); else null
  const int* lrow;      // [n_ops, tmax]
  const int* lcol;
  const float* lsgn;
  const int* rrow;      // [n_ops, tmax]
  const int* rcol;
  const float* rsgn;
  const int* rtrn;      // tri right side: the per-term mirror
  const int* dest;      // [n_ops, max_dests]: leaf destination index
  const float* dsgn;    //   its sign (0: an empty slot)
  const int* dflag;     //   FIRST | LAST, on or below the diagonal; << UPPER, above it
  const int* dtrn;      //   the destination takes the product transposed
  const int* odiag;     // [n_ops]: every destination of the op is a straight one on a diagonal
                        //   leaf block
  int n_ops, tmax, max_dests, n_k;
  int q_i, q_j;         // output tiles per leaf block along i and j
  int blocks_j;         // leaf blocks of the output along j
  int bi, bj, bc;       // output tile edges, contraction tile edge
  int left_trans;       // left tiles stored K x i (else i x K)
  int right_jk;         // dense right tiles stored j x K (else K x j)
  int diag_sym;
  int out_tri;          // the output is the packed lower-triangular tile stack
  int group;            // terms a side a ring slot holds: slot_terms(tmax, pair mode)
  int seed_bf16;        // the seed's element type (else fp32)
  int out_bf16;         // the output's element type (else fp32)
  int n_big;            // blocks that walk a whole position; the rest walk quarters
};

// Packed lower-triangular index -> (i, j), i >= j, row-major; a root estimate with the
// integer correction of syrk._tri_decode.
__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  long long r = static_cast<long long>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if ((r + 1) * (r + 2) / 2 <= t) ++r;
  if (r * (r + 1) / 2 > t) --r;
  i = static_cast<int>(r);
  j = static_cast<int>(t - r * (r + 1) / 2);
}

// The output tile (iq, jq) of a leaf block at cell c of a launch.  A dense output walks the
// cells row-major.  A packed one walks the q (q + 1) / 2 cells with iq >= jq first, in packed
// order, then the q (q - 1) / 2 others, (iq, jq) = (j, i + 1) for the packed (i, j) of q - 1
// rows: the light cells, which skip the ops that feed only diagonal leaf blocks, fill the
// last waves.
__device__ __forceinline__ void cell_of(const Ops& P, int c, int& iq, int& jq) {
  if (!P.out_tri) {
    iq = c / P.q_j;
    jq = c % P.q_j;
    return;
  }
  const int heavy = P.q_i * (P.q_i + 1) / 2;
  if (c < heavy) {
    tri_decode(c, iq, jq);
    return;
  }
  int i, j;
  tri_decode(c - heavy, i, j);
  iq = j;
  jq = i + 1;
}

__device__ __forceinline__ float4 load4(const void* base, long long at, bool bf16) {
  if (!bf16) return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + at);
  const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + at);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A tri-stored right term at K block k, as _tri_term_coords decides it: the stored tile
// (max, min) of the conceptual coordinates (gr, gc), mirrored when the term is mirrored or
// gr < gc, doubled into tile + tile^t when it lies on the diagonal under diag_sym.
struct TriTerm {
  long long row;        // first stack row of the stored tile
  bool mirrored, diag;
};

__device__ __forceinline__ TriTerm tri_term(const Ops& P, int rrow, int rcol, bool trn, int k,
                                            int jq) {
  const long long gr = static_cast<long long>(rrow) * P.q_j + (trn ? jq : k);
  const long long gc = static_cast<long long>(rcol) * P.q_j + (trn ? k : jq);
  const long long fr = gr > gc ? gr : gc;
  const long long fc = gr > gc ? gc : gr;
  return {(fr * (fr + 1) / 2 + fc) * P.bj, trn || gr < gc, P.diag_sym != 0 && gr == gc};
}

// Terms a side a ring slot holds.
constexpr int slot_terms(int tmax, bool pair) { return pair && tmax > GROUP ? GROUP : tmax; }

size_t smem_bytes(bool right_tri, int tmax, int tile, int left_bytes, int right_bytes,
                  int stages, bool pair) {
  const size_t chunk = static_cast<size_t>(KC) * tile;
  return static_cast<size_t>(stages) * slot_terms(tmax, pair) * chunk *
             (left_bytes + right_chunks(right_tri) * right_bytes)  // raw rings
         + 2 * 2 * static_cast<size_t>(KC) * (tile + 4) * sizeof(float)  // summed, 2 buffers
         + static_cast<size_t>(stages) * (sizeof(StepTerms) + sizeof(uint64_t));  // per slot
}

__device__ __forceinline__ float load1(const void* base, long long at, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[at])
              : static_cast<const float*>(base)[at];
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// One block's walk of every op at one position: output tile (iq, jq) of a leaf block,
// TILE x TILE sub-tile (i0, j0) of it; in PAIR mode also at its mirror, tile (jq, iq),
// sub-tile (j0, i0).  The three operand maps are the left side's, the right side's and, for a
// tri right side, the mirrored read of the same stack (boxes TILE x KC where the stored box is
// KC x TILE).  PAIRS: the pair-mode instantiation, whose ring slots hold GROUP terms a side
// (a chunk of an op with more takes several slots in turn); elsewhere a slot holds tmax.
template <typename Tl, typename Tr, bool TRI, int TILE, int STAGES, bool PAIRS>
__device__ __forceinline__ void walk(const Ops& P, const CUtensorMap& lmap,
                                     const CUtensorMap& rmap, const CUtensorMap& mmap, int iq,
                                     int jq, int i0, int j0, int mode) {
  using G = Geometry<TILE>;
  constexpr int RC = right_chunks(TRI);
  constexpr int R = G::R, XQ = G::XQ, LDS = G::LDS, CHUNK = G::CHUNK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tmax = P.tmax, gw = P.group;
  Tl* lring = reinterpret_cast<Tl*>(smem);
  const size_t lring_bytes = static_cast<size_t>(STAGES) * gw * CHUNK * sizeof(Tl);
  Tr* rring = reinterpret_cast<Tr*>(smem + lring_bytes);
  float* sum_base = reinterpret_cast<float*>(
      smem + lring_bytes + static_cast<size_t>(STAGES) * gw * RC * CHUNK * sizeof(Tr));
  StepTerms* terms = reinterpret_cast<StepTerms*>(sum_base + 2 * 2 * G::SUM);  // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + STAGES);                 // [STAGES]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int n_kc = (P.bc + KC - 1) / KC;
  // The items walked, u = 2 o + m: op o at the block's position (m = 0) or at its mirror
  // (m = 1, PAIR mode).  A position above the diagonal of a leaf block (iq < jq of a packed
  // output) holds no tile of a diagonal leaf block: there the ops that feed only diagonal
  // blocks, straight, are skipped.
  const int end = 2 * P.n_ops;
  auto live_item = [&](int u) {
    for (; u < end; ++u) {
      const bool mirror = u & 1;
      if (mirror && mode != PAIR) continue;
      const bool light = P.out_tri && (mirror ? jq < iq : iq < jq);
      if (!(light && P.odiag[u >> 1])) break;
    }
    return u;
  };
  const Chunk first = {live_item(0), 0, 0};
  if (first.u == end) return;

  // Warp 0 starts the copies of step t into ring slot `slot`, lane p the left term g gw + p
  // and lane MAX_TERMS + p the right one: one TMA box a live term (two for a diagonal tri term
  // under diag_sym), all counted on the slot's mbarrier, and leaves the step's terms with the
  // slot.  A box is KC x TILE or TILE x KC as the side lies in memory; rows or columns past
  // the edge of the output tile are other tiles' data and reach only outputs that are never
  // stored, and depth past the K block is masked in the sum phase.
  const bool right_side = lane >= MAX_TERMS;
  const int p = lane % MAX_TERMS;
  // The ring slots one chunk of item u takes, found by warp 0's lanes together: its op's
  // wider side over the slot's terms (a side's live terms come first).
  auto groups_of = [&](int u) {
    const bool live = u < end && lane < 2 * MAX_TERMS && p < tmax &&
                      (right_side ? P.rsgn : P.lsgn)[(u >> 1) * tmax + p] != 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    const int n = max(__popc(bits & ((1u << MAX_TERMS) - 1)), __popc(bits >> MAX_TERMS));
    return (n + gw - 1) / gw;
  };
  int term_key = -1, term_row = 0, term_col = 0;  // the issuing lane's term, read once a slot
  bool term_trn = false;
  float coef = 0.f;
  auto start_copies = [&](const Step& t, int slot) {
    const int kc = t.c * KC;
    const bool mirror = t.u & 1;
    const int wi = mirror ? jq : iq, wj = mirror ? iq : jq;
    const int wi0 = mirror ? j0 : i0, wj0 = mirror ? i0 : j0;
    const int key = (t.u >> 1) * MAX_TERMS + t.g;
    if (key != term_key) {
      term_key = key;
      const int term = t.g * gw + p;
      const int at = (t.u >> 1) * tmax + term;
      coef = lane < 2 * MAX_TERMS && p < gw && term < tmax ? (right_side ? P.rsgn : P.lsgn)[at]
                                                           : 0.f;
      if (coef != 0.f) {
        term_row = (right_side ? P.rrow : P.lrow)[at];
        term_col = (right_side ? P.rcol : P.lcol)[at];
        term_trn = right_side && P.rtrn[at] != 0;
      }
    }
    // a side's live terms come first, so its count is its lanes with a coefficient
    const unsigned live = __ballot_sync(0xffffffffu, coef != 0.f);
    TriTerm tt{0, false, false};
    if constexpr (TRI)
      if (right_side && coef != 0.f) tt = tri_term(P, term_row, term_col, term_trn, t.k, wj);
    const unsigned bytes =
        coef == 0.f ? 0u
                    : (right_side ? (tt.diag ? 2 : 1) * CHUNK * sizeof(Tr) : CHUNK * sizeof(Tl));
    const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
    StepTerms& st = terms[slot];
    if (lane == 0) {
      st.n_l = __popc(live & ((1u << MAX_TERMS) - 1));
      st.n_r = __popc(live >> MAX_TERMS);
      if constexpr (PAIRS) {
        st.first = t.g == 0;
        st.last = t.g == t.ng - 1;
      }
    }
    if (coef != 0.f && !right_side) st.lc[p] = coef;
    if (coef != 0.f && right_side) {
      st.rc[p] = coef;
      st.mirrored[p] = tt.mirrored;  // read for a tri right side only
      st.diag[p] = tt.diag;
    }
    __syncwarp();
    if (lane == 0) mbar_expect(&full[slot], total);
    __syncwarp();
    if (coef == 0.f) return;
    if (!right_side) {
      Tl* dst = lring + (static_cast<size_t>(slot) * gw + p) * CHUNK;
      const int lr = term_row, lc = term_col;
      if (P.left_trans)  // K x i: rows (lrow*n_k + k)*bc + kc.., cols (lcol*q_i + wi)*bi + wi0..
        tma_load(dst, &lmap, (lc * P.q_i + wi) * P.bi + wi0, (lr * P.n_k + t.k) * P.bc + kc,
                 &full[slot]);
      else  // i x K: rows (lrow*q_i + wi)*bi + wi0.., cols (lcol*n_k + k)*bc + kc..
        tma_load(dst, &lmap, (lc * P.n_k + t.k) * P.bc + kc, (lr * P.q_i + wi) * P.bi + wi0,
                 &full[slot]);
      return;
    }
    Tr* dst = rring + (static_cast<size_t>(slot) * gw + p) * RC * CHUNK;
    if constexpr (TRI) {
      if (!tt.mirrored || tt.diag)  // stored rows kc.., cols wj0..
        tma_load(dst, &rmap, wj0, static_cast<int>(tt.row) + kc, &full[slot]);
      if (tt.mirrored || tt.diag)   // stored rows wj0.., cols kc..
        tma_load(dst + CHUNK, &mmap, kc, static_cast<int>(tt.row) + wj0, &full[slot]);
    } else {
      const int rr = term_row, rc = term_col;
      if (P.right_jk)  // j x K: rows (rrow*q_j + wj)*bj + wj0.., cols (rcol*n_k + k)*bc + kc..
        tma_load(dst, &rmap, (rc * P.n_k + t.k) * P.bc + kc, (rr * P.q_j + wj) * P.bj + wj0,
                 &full[slot]);
      else  // K x j: rows (rrow*n_k + k)*bc + kc.., cols (rcol*q_j + wj)*bj + wj0..
        tma_load(dst, &rmap, (rc * P.q_j + wj) * P.bj + wj0, (rr * P.n_k + t.k) * P.bc + kc,
                 &full[slot]);
    }
  };

  // Each thread sums the elements (kk, x) of the KC x TILE chunk with x = lane + 32 q and
  // kk = (2 warp + h + lane / 2) % KC, h in {0, 1}: a warp's 32 lanes hit 32 banks where a
  // chunk is read as it lies KC x TILE ([kk][x]), where it lies TILE x KC ([x][kk], kk skewed
  // by lane / 2) and where the sum is written ([kk][x] in rows of TILE + 4).  Ownership is
  // fixed for the whole kernel, so each element sums its terms in table order, and a chunk's
  // later ring slot reads back what this thread left in the buffer.
  int kk_of[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kk_of[h] = (warp * 2 + h + (lane >> 1)) % KC;

  // Returns whether the step was its chunk's last ring slot.
  auto sum_phase = [&](const Chunk& t, int slot, float* lsum, float* rsum) {
    const StepTerms& st = terms[slot];
    const Tl* lslot = lring + static_cast<size_t>(slot) * gw * CHUNK;
    const Tr* rslot = rring + static_cast<size_t>(slot) * gw * RC * CHUNK;
    float l[2][XQ], r[2][XQ];
    if (!PAIRS || st.first) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < XQ; ++q) l[h][q] = r[h][q] = 0.f;
    } else {  // a chunk's later ring slot: carry on from what this thread left
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < XQ; ++q) {
          l[h][q] = lsum[kk_of[h] * LDS + lane + 32 * q];
          r[h][q] = rsum[kk_of[h] * LDS + lane + 32 * q];
        }
    }
    for (int p = 0; p < st.n_l; ++p) {
      const float cl = st.lc[p];
      const Tl* src = lslot + p * CHUNK;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < XQ; ++q) {
          const int x = lane + 32 * q;
          const int at = P.left_trans ? kk_of[h] * TILE + x : x * KC + kk_of[h];
          l[h][q] = __fadd_rn(l[h][q], __fmul_rn(cl, to_f32(src[at])));
        }
    }
    if constexpr (TRI) {
      // Right element (kk, j): stored[kk][j] in the stored chunk, stored[j][kk] in the
      // mirrored one; a term reads one of them, or both on a diagonal tile, the same for all
      // its elements, so the choice is one branch a term.
      for (int p = 0; p < st.n_r; ++p) {
        const float cr = st.rc[p];
        const bool mirrored = st.mirrored[p], diag = st.diag[p];
        const Tr* sto = rslot + p * RC * CHUNK;
        const Tr* mi = sto + CHUNK;
        if (diag) {  // tile + tile^t, in the order the term reads it
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < XQ; ++q) {
              const int x = lane + 32 * q;
              const float sv = to_f32(sto[kk_of[h] * TILE + x]);
              const float mv = to_f32(mi[x * KC + kk_of[h]]);
              const float v = mirrored ? __fadd_rn(mv, sv) : __fadd_rn(sv, mv);
              r[h][q] = __fadd_rn(r[h][q], __fmul_rn(cr, v));
            }
        } else if (mirrored) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < XQ; ++q)
              r[h][q] = __fadd_rn(r[h][q],
                                  __fmul_rn(cr, to_f32(mi[(lane + 32 * q) * KC + kk_of[h]])));
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < XQ; ++q)
              r[h][q] = __fadd_rn(r[h][q],
                                  __fmul_rn(cr, to_f32(sto[kk_of[h] * TILE + lane + 32 * q])));
        }
      }
    } else {
      for (int p = 0; p < st.n_r; ++p) {
        const float cr = st.rc[p];
        const Tr* src = rslot + p * CHUNK;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < XQ; ++q) {
            const int x = lane + 32 * q;
            const int at = P.right_jk ? x * KC + kk_of[h] : kk_of[h] * TILE + x;
            r[h][q] = __fadd_rn(r[h][q], __fmul_rn(cr, to_f32(src[at])));
          }
      }
    }
    // depth past the K block (the box's next K block, or zeros past the operand) sums to 0
    const int k_lim = P.bc - t.c * KC;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < XQ; ++q) {
        const bool live = kk_of[h] < k_lim;
        lsum[kk_of[h] * LDS + lane + 32 * q] = live ? l[h][q] : 0.f;
        rsum[kk_of[h] * LDS + lane + 32 * q] = live ? r[h][q] : 0.f;
      }
    return !PAIRS || st.last != 0;
  };

  // This thread's outputs: rows 64 a + 4 ty + i, columns 64 b + 4 tx + j of the sub-tile.
  float part[R][R], prod[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) part[i][j] = prod[i][j] = 0.f;

  auto multiply = [&](const float* lsum, const float* rsum) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[R], b[R];
#pragma unroll
      for (int g = 0; g < R / 4; ++g) {
        const float4 av = *reinterpret_cast<const float4*>(lsum + kk * LDS + g * 64 + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(rsum + kk * LDS + g * 64 + tx * 4);
        a[4 * g] = av.x; a[4 * g + 1] = av.y; a[4 * g + 2] = av.z; a[4 * g + 3] = av.w;
        b[4 * g] = bv.x; b[4 * g + 1] = bv.y; b[4 * g + 2] = bv.z; b[4 * g + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
  };

  const long long ldo = P.out_tri ? P.bj : static_cast<long long>(P.blocks_j) * P.q_j * P.bj;
  // The first output row and column of sub-tile (p0i, p0j) of position (pi, pj) of leaf
  // destination ld; false where the output holds none (above the diagonal of a diagonal leaf
  // block of a packed output).
  auto origin = [&](int ld, int pi, int pj, int p0i, int p0j, long long& row0,
                    long long& col0) {
    if (P.out_tri) {  // tile (gi, gj) of the packed stack
      int di, dj;
      tri_decode(ld, di, dj);
      if (di == dj && pi < pj) return false;
      const long long gi = static_cast<long long>(di) * P.q_i + pi;
      const long long gj = static_cast<long long>(dj) * P.q_j + pj;
      row0 = (gi * (gi + 1) / 2 + gj) * P.bi + p0i;
      col0 = p0j;
    } else {
      row0 = (static_cast<long long>(ld / P.blocks_j) * P.q_i + pi) * P.bi + p0i;
      col0 = (static_cast<long long>(ld % P.blocks_j) * P.q_j + pj) * P.bj + p0j;
    }
    return true;
  };
  // Output element `at` takes v: onto the seed where the slot is the first to feed it, else
  // onto what it holds; rounded into a bf16 output where it is the last.  The seed is read by
  // the thread that writes the element, before it writes: the seed may be the output.
  auto put1 = [&](long long at, float v, int flag) {
    if (!(flag & FIRST) || P.seed != nullptr)
      v = __fadd_rn(flag & FIRST ? load1(P.seed, at, P.seed_bf16) : P.ws[at], v);
    if ((flag & LAST) && P.out_bf16)
      static_cast<__nv_bfloat16*>(P.out)[at] = __float2bfloat16_rn(v);
    else
      P.ws[at] = v;
  };
  auto put4 = [&](long long at, float v[4], int flag) {
    if (!(flag & FIRST) || P.seed != nullptr) {
      const float4 w = flag & FIRST ? load4(P.seed, at, P.seed_bf16)
                                    : *reinterpret_cast<const float4*>(P.ws + at);
      v[0] = __fadd_rn(w.x, v[0]);
      v[1] = __fadd_rn(w.y, v[1]);
      v[2] = __fadd_rn(w.z, v[2]);
      v[3] = __fadd_rn(w.w, v[3]);
    }
    if ((flag & LAST) && P.out_bf16)
      store4(static_cast<__nv_bfloat16*>(P.out) + at, v[0], v[1], v[2], v[3]);
    else
      store4(P.ws + at, v[0], v[1], v[2], v[3]);
  };
  // After step t, the last ring slot of its chunk: the end of a K block adds its part into the
  // item's product; the end of an item adds sign * product into each destination of its op.
  // The walked sub-tile W (the mirror when the item is) takes the straight slots, in the order
  // of its half (below the diagonal unless it is the mirror), and the other sub-tile of the
  // pair the transposed ones, in the order of the other half.  A SELF sub-tile takes in a first
  // pass what comes first for each element and, after a barrier, the rest.
  auto finish_step = [&](const Chunk& t) {
    if (t.c != n_kc - 1) return;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        prod[i][j] = __fadd_rn(prod[i][j], part[i][j]);
        part[i][j] = 0.f;
      }
    if (t.k != P.n_k - 1) return;
    const int o = t.u >> 1;
    const bool mirror = t.u & 1;
    const int wi = mirror ? jq : iq, wj = mirror ? iq : jq;
    const int wi0 = mirror ? j0 : i0, wj0 = mirror ? i0 : j0;
    const int w_shift = mirror ? UPPER : 0;
#pragma unroll 1
    for (int pass = 0; pass < (mode == SELF ? 2 : 1); ++pass) {
      if (pass) __syncthreads();  // the first pass's writes, seen by the second's readers
      for (int d = 0; d < P.max_dests; ++d) {
        const int at_d = o * P.max_dests + d;
        const float sg = P.dsgn[at_d];
        if (sg == 0.f) break;  // an op's destinations come first
        const int flags = P.dflag[at_d];
        // only pair mode has transposed slots (and the compiler drops their writes elsewhere)
        const bool trn = mode != SINGLE && P.dtrn[at_d] != 0;
        long long row0, col0;  // of W, or of the other sub-tile for a transposed slot
        if (!(trn ? origin(P.dest[at_d], wj, wi, wj0, wi0, row0, col0)
                  : origin(P.dest[at_d], wi, wj, wi0, wj0, row0, col0)))
          continue;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int x = (i / 4) * 64 + ty * 4 + i % 4;
          if (wi0 + x >= P.bi) continue;
#pragma unroll
          for (int g = 0; g < R / 4; ++g) {
            const int y = g * 64 + tx * 4;
            if (wj0 + y >= P.bj) continue;  // bj is a multiple of 8: all 4 columns are in
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(sg, prod[i][4 * g + j]);
            if (mode != SELF && !trn) {
              put4((row0 + x) * ldo + col0 + y, v, (flags >> w_shift) & 3);
              continue;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // element (x, y + j) of W goes straight there, transposed to (y + j, x)
              const long long at =
                  trn ? (row0 + y + j) * ldo + col0 + x : (row0 + x) * ldo + col0 + y + j;
              if (mode != SELF) {
                put1(at, v[j], (flags >> (UPPER - w_shift)) & 3);
                continue;
              }
              // the target lies on or below the diagonal: straight first, else transposed
              const bool lower = trn ? y + j >= x : x >= y + j;
              if ((lower == trn) == (pass == 1)) put1(at, v[j], (flags >> (lower ? 0 : UPPER)) & 3);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) prod[i][j] = 0.f;
  };

  float* const sums = sum_base;     // [buffer][side][KC][LDS]
  auto lsum = [&](int b) { return sums + b * 2 * G::SUM; };
  auto rsum = [&](int b) { return sums + b * 2 * G::SUM + G::SUM; };
  // The chunks walked in order, live item, then K block, then chunk; warp 0 copies each
  // chunk's ring slots in turn.
  auto advance = [&](Chunk& t) {
    if (++t.c < n_kc) return;
    t.c = 0;
    if (++t.k < P.n_k) return;
    t.k = 0;
    t.u = live_item(t.u + 1);
  };
  Step copy{first, 0, 1};
  auto advance_copy = [&]() {  // warp 0's lanes together
    if constexpr (PAIRS) {
      if (++copy.g < copy.ng) return;
      copy.g = 0;
      const int u = copy.u;
      advance(copy);
      if (copy.u != u) copy.ng = groups_of(copy.u);
    } else {
      advance(copy);
    }
  };
  if constexpr (PAIRS)
    if (warp == 0) copy.ng = groups_of(first.u);
  Chunk summed = first;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The sum buffer a chunk's slots sum into alternates chunk by chunk.
  int buf = 0;
  if constexpr (STAGES == 1) {
    // Load, then compute: the copy of step s starts once step s - 1's chunks are summed
    // (the barrier after the sum phase); the sums are double-buffered, so summing step s
    // overlaps nobody's multiply of the chunk before in the same buffer.
    for (int s = 0; summed.u < end; ++s) {
      if (warp == 0) {
        start_copies(copy, 0);
        advance_copy();
      }
      __syncthreads();  // the step's terms, left by warp 0
      mbar_wait(&full[0], s & 1);
      const bool last = sum_phase(summed, 0, lsum(buf), rsum(buf));
      __syncthreads();
      if (last) {
        multiply(lsum(buf), rsum(buf));
        finish_step(summed);
        buf ^= 1;
        advance(summed);
      }
    }
  } else {
    // STAGES - 1 steps in flight.  Iteration s sums step s and multiplies the chunk that
    // step s - 1 completed, if it did, between one pair of barriers: the sums are
    // double-buffered, and the slot refilled in iteration s, (s - 1) % STAGES, was last read
    // by the sum phase of iteration s - 1.  Slot s % STAGES holds step s in its
    // (s / STAGES)-th phase.
    const bool sum_first = warp < 4;
    if (warp == 0)
      for (int s = 0; s < STAGES - 1 && copy.u < end; ++s) {
        start_copies(copy, s);
        advance_copy();
      }
    Chunk done = summed;  // the chunk completed in the iteration before, in buffer buf ^ 1
    bool done_chunk = false;
    for (int s = 0; summed.u < end || done_chunk; ++s) {
      const bool live = summed.u < end;
      if (live) mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
      __syncthreads();
      if (warp == 0 && copy.u < end) {
        start_copies(copy, (s + STAGES - 1) % STAGES);
        advance_copy();
      }
      // warps 0-3 sum first, 4-7 multiply first: each warp scheduler holds one of each, so
      // one's FMAs issue while the other waits on shared memory
      bool last = false;
      if (live && sum_first) last = sum_phase(summed, s % STAGES, lsum(buf), rsum(buf));
      if (done_chunk) multiply(lsum(buf ^ 1), rsum(buf ^ 1));
      if (live && !sum_first) last = sum_phase(summed, s % STAGES, lsum(buf), rsum(buf));
      if (done_chunk) finish_step(done);
      done_chunk = last;
      if (last) {
        done = summed;
        buf ^= 1;
        advance(summed);
      }
    }
  }
}

// Blocks below n_big walk one position each at TILE, in cell_of's order; past it (TILE 128
// only) each of the last positions is split into four quarters, walked at TILE / 2 with the
// half maps, so that a ragged last wave of whole positions becomes a short one.  In pair mode
// (a dense right side) a block walks a mirror pair: sub-tile (I, J) of a leaf block's side of
// Q sub-tiles, I > J, and its mirror (J, I), in packed order, then the Q sub-tiles (I, I) that
// are their own mirrors, which walk half as much, last.  Pair mode is its own instantiation
// (PAIRS), so the one-position walk keeps none of its code.  The arithmetic of an output
// element depends neither on the tile nor on the mode.
template <typename Tl, typename Tr, bool TRI, int TILE, int STAGES, bool PAIRS>
__global__ void __launch_bounds__(THREADS)
    leaf_products_kernel(const Ops P, const __grid_constant__ CUtensorMap lmap,
                         const __grid_constant__ CUtensorMap rmap,
                         const __grid_constant__ CUtensorMap mmap,
                         const __grid_constant__ CUtensorMap lmap_half,
                         const __grid_constant__ CUtensorMap rmap_half,
                         const __grid_constant__ CUtensorMap mmap_half) {
  const int n_sub_i = (P.bi + TILE - 1) / TILE, n_sub_j = (P.bj + TILE - 1) / TILE;
  int iq, jq, i0, j0, mode = SINGLE;
  if constexpr (PAIRS) {  // square tiles: n_sub_i == n_sub_j
    const int side = P.q_i * n_sub_i;
    const int n_two = side * (side - 1) / 2;
    int I, J = static_cast<int>(blockIdx.x) - n_two;
    if (J < 0) {
      tri_decode(blockIdx.x, I, J);
      ++I;
      mode = PAIR;
    } else {
      I = J;
      mode = SELF;
    }
    iq = I / n_sub_i;
    i0 = (I % n_sub_i) * TILE;
    jq = J / n_sub_i;
    j0 = (J % n_sub_i) * TILE;
  } else {
    int pos = blockIdx.x, quarter = -1;
    if (pos >= P.n_big) {
      quarter = (pos - P.n_big) % 4;
      pos = P.n_big + (pos - P.n_big) / 4;
    }
    j0 = (pos % n_sub_j) * TILE;
    pos /= n_sub_j;
    i0 = (pos % n_sub_i) * TILE;
    pos /= n_sub_i;
    cell_of(P, pos, iq, jq);
    if constexpr (TILE == 128) {
      if (quarter >= 0) {
        walk<Tl, Tr, TRI, TILE / 2, STAGES, false>(P, lmap_half, rmap_half, mmap_half, iq, jq,
                                                   i0 + (quarter / 2) * (TILE / 2),
                                                   j0 + (quarter % 2) * (TILE / 2), SINGLE);
        return;
      }
    }
  }
  walk<Tl, Tr, TRI, TILE, STAGES, PAIRS>(P, lmap, rmap, mmap, iq, jq, i0, j0, mode);
}

using KernelFn = void (*)(const Ops, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap, const CUtensorMap);

template <typename Tl, typename Tr, bool TRI, int TILE, bool PAIRS>
KernelFn by_stages(int stages) {
  switch (stages) {
    case 1: return leaf_products_kernel<Tl, Tr, TRI, TILE, 1, PAIRS>;
    case 2: return leaf_products_kernel<Tl, Tr, TRI, TILE, 2, PAIRS>;
    case 3: return leaf_products_kernel<Tl, Tr, TRI, TILE, 3, PAIRS>;
    case 4: return leaf_products_kernel<Tl, Tr, TRI, TILE, 4, PAIRS>;
    default: return nullptr;
  }
}

template <typename Tl, typename Tr, bool TRI, bool PAIRS>
KernelFn by_tile(int tile, int stages) {
  if (tile == 64) return by_stages<Tl, Tr, TRI, 64, PAIRS>(stages);
  if (tile == 128) return by_stages<Tl, Tr, TRI, 128, PAIRS>(stages);
  return nullptr;
}

// Pair mode is instantiated only where it can run: a gram kind's one operand, a dense right
// side.
template <typename Tl, typename Tr>
KernelFn by_layout(bool tri, bool pair, int tile, int stages) {
  if (!pair)
    return tri ? by_tile<Tl, Tr, true, false>(tile, stages)
               : by_tile<Tl, Tr, false, false>(tile, stages);
  if constexpr (std::is_same_v<Tl, Tr>)
    if (!tri) return by_tile<Tl, Tr, false, true>(tile, stages);
  return nullptr;
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <typename Tl>
KernelFn by_right(int r_dtype, bool tri, bool pair, int tile, int stages) {
  if (r_dtype == 0) return by_layout<Tl, float>(tri, pair, tile, stages);
  if (r_dtype == 1) return by_layout<Tl, __nv_bfloat16>(tri, pair, tile, stages);
  return nullptr;
}

KernelFn select(int l_dtype, int r_dtype, bool tri, bool pair, int tile, int stages) {
  if (l_dtype == 0) return by_right<float>(r_dtype, tri, pair, tile, stages);
  if (l_dtype == 1) return by_right<__nv_bfloat16>(r_dtype, tri, pair, tile, stages);
  return nullptr;
}

// The kernel for a launch, its dynamic shared memory raised to what it needs.
cudaError_t prepare(KernelFn kernel, size_t smem) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The 2-D map of a row-major (rows, cols) operand with row stride ld (elements), read in
// boxes of box_rows x box_cols; reads past its edge give zeros.
bool make_map(CUtensorMap* map, const void* base, int bf16, long long rows, long long cols,
              long long ld, int box_rows, int box_cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How many of n_pos positions a launch walks whole: all of them, unless the last wave of whole
// positions is ragged and its positions, split into quarters (TILE 128 only), fit in one wave;
// then the positions of the full waves.  -1 for arguments no kernel takes.
long long whole_positions(KernelFn kernel, size_t smem, int tile, long long n_pos) {
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) !=
          cudaSuccess)
    return -1;
  const long long wave = static_cast<long long>(sms) * per_sm;
  const long long tail = wave > 0 ? n_pos % wave : 0;
  return tile == 128 && tail > 0 && 4 * tail <= wave ? n_pos - tail : n_pos;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the wrapper refuses > 227 KB).  right_tri: the
// right side is a packed tri stack; left_bytes / right_bytes: operand element sizes; pair:
// the launch runs in pair mode.
size_t leaf_products_smem_bytes(int right_tri, int tmax, int tile, int left_bytes,
                                int right_bytes, int stages, int pair) {
  return smem_bytes(right_tri != 0, tmax, tile, left_bytes, right_bytes, stages, pair != 0);
}

// Thread blocks of one launch an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 for arguments no kernel takes.  pair: the launch runs in pair mode.
int leaf_products_blocks_per_sm(int l_dtype, int r_dtype, int right_tri, int tmax, int tile,
                                int stages, int pair) {
  const KernelFn kernel = select(l_dtype, r_dtype, right_tri != 0, pair != 0, tile, stages);
  const size_t smem = smem_bytes(right_tri != 0, tmax, tile, l_dtype == 1 ? 2 : 4,
                                 r_dtype == 1 ? 2 : 4, stages, pair != 0);
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// The positions a launch of n_pos positions walks whole (whole_positions); the other n_pos
// minus that many are walked in quarters, four blocks each.
long long leaf_products_whole_positions(int l_dtype, int r_dtype, int right_tri, int tmax,
                                        int tile, int stages, long long n_pos) {
  const size_t smem = smem_bytes(right_tri != 0, tmax, tile, l_dtype == 1 ? 2 : 4,
                                 r_dtype == 1 ? 2 : 4, stages, false);
  return whole_positions(select(l_dtype, r_dtype, right_tri != 0, false, tile, stages), smem,
                         tile, n_pos);
}

const char* leaf_products_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One bound program of a kind this library runs.  `left` / `right` are the padded operands,
// (l_rows, l_cols) and (r_rows, r_cols), contiguous, `out` the dense
// (blocks_i*q_i*bi, blocks_j*q_j*bj) grid or, with out_tri, the packed (n_out*bi, bj) stack,
// and `ws` its fp32 accumulator (out itself for an fp32 output).  `seed`, with out_tri only,
// is the incoming packed stack of rank_k or null; it may be out.  The tables are
// _op_tables' twelve arrays.  left_trans: left tiles stored K x i.  right_layout: 0 K x j, 1
// j x K, 2 packed tri stack of (bj, bj) tiles (then bc == bj).  pair: the tables have a
// transposed destination (a packed output, a dense right side).  dtype codes: 0 fp32, 1
// bf16.  tile: 64 or 128, a block's sub-tile edge.  The operands' row strides and bases are
// 16-byte aligned, their extents below 2^31.
int leaf_products_launch(const void* left, const void* right, const void* seed, void* ws,
                         void* out, const void* lrow, const void* lcol, const void* lsgn,
                         const void* rrow, const void* rcol, const void* rsgn, const void* rtrn,
                         const void* dest, const void* dsgn, const void* dflag,
                         const void* dtrn, const void* odiag, long long l_rows, long long l_cols,
                         long long r_rows, long long r_cols, int n_ops, int tmax, int max_dests,
                         int n_k, int q_i, int q_j, int blocks_j, int bi, int bj, int bc,
                         int left_trans, int right_layout, int diag_sym, int out_tri, int pair,
                         int l_dtype, int r_dtype, int seed_dtype, int out_dtype, int tile,
                         int stages, void* stream) {
  if (n_ops < 1 || tmax < 1 || tmax > MAX_TERMS || max_dests < 1 || n_k < 1 || q_i < 1 ||
      q_j < 1 || blocks_j < 1 || bi < 8 || bj < 8 || bc < 8 || right_layout < RIGHT_KJ ||
      right_layout > RIGHT_TRI || (right_layout == RIGHT_TRI && (bc != bj || rtrn == nullptr)) ||
      (out_dtype != 0 && out_dtype != 1) || (out_dtype == 0 && ws != out) ||
      odiag == nullptr || dtrn == nullptr ||
      // a packed output: square tiles, a dense right side; a seed, or pair mode, only there
      (out_tri && (right_layout == RIGHT_TRI || q_i != q_j || bi != bj)) || (pair && !out_tri) ||
      (seed != nullptr && (!out_tri || (seed_dtype != 0 && seed_dtype != 1))) ||
      l_rows >= (1LL << 31) || l_cols >= (1LL << 31) || r_rows >= (1LL << 31) ||
      r_cols >= (1LL << 31))
    return cudaErrorInvalidValue;
  const bool tri = right_layout == RIGHT_TRI;
  const KernelFn kernel = select(l_dtype, r_dtype, tri, pair != 0, tile, stages);
  const size_t smem = smem_bytes(tri, tmax, tile, l_dtype == 1 ? 2 : 4, r_dtype == 1 ? 2 : 4,
                                 stages, pair != 0);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // Boxes as each side lies: KC deep along K, TILE wide along i or j; the half maps read the
  // quarters' TILE / 2 wide boxes.
  CUtensorMap maps[2][3];
  const bool r_kx = right_layout != RIGHT_JK;  // K x j rows, or the stored read of a stack
  for (int half = 0; half < 2; ++half) {
    const int w = tile >> half;
    CUtensorMap* m = maps[half];
    if (!make_map(&m[0], left, l_dtype, l_rows, l_cols, l_cols, left_trans ? KC : w,
                  left_trans ? w : KC) ||
        !make_map(&m[1], right, r_dtype, r_rows, r_cols, r_cols, r_kx ? KC : w,
                  r_kx ? w : KC) ||
        (tri && !make_map(&m[2], right, r_dtype, r_rows, r_cols, r_cols, w, KC)))
      return cudaErrorInvalidValue;
    if (!tri) m[2] = m[1];  // unread
  }
  Ops P{static_cast<float*>(ws), out, seed,
        static_cast<const int*>(lrow), static_cast<const int*>(lcol),
        static_cast<const float*>(lsgn), static_cast<const int*>(rrow),
        static_cast<const int*>(rcol), static_cast<const float*>(rsgn),
        static_cast<const int*>(rtrn), static_cast<const int*>(dest),
        static_cast<const float*>(dsgn), static_cast<const int*>(dflag),
        static_cast<const int*>(dtrn), static_cast<const int*>(odiag),
        n_ops, tmax, max_dests, n_k, q_i, q_j, blocks_j, bi, bj, bc,
        left_trans, right_layout == RIGHT_JK, diag_sym, out_tri != 0, slot_terms(tmax, pair),
        seed_dtype == 1, out_dtype == 1, 0};
  const long long n_pos = static_cast<long long>(q_i) * q_j * ((bi + tile - 1) / tile) *
                          ((bj + tile - 1) / tile);
  // pair mode: one block a mirror pair of sub-tiles and one a sub-tile on the diagonal
  const long long side = static_cast<long long>(q_i) * ((bi + tile - 1) / tile);
  const long long n_big = pair ? side * (side + 1) / 2 : whole_positions(kernel, smem, tile, n_pos);
  const long long blocks = pair ? n_big : n_big + 4 * (n_pos - n_big);
  if (n_big < 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  P.n_big = static_cast<int>(n_big);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      P, maps[0][0], maps[0][1], maps[0][2], maps[1][0], maps[1][1], maps[1][2]);
  return cudaGetLastError();
}

}  // extern "C"
