// leaf_products.cuh — the fused leaf program, each leaf product computed once: every kind
// (ata, aat, rank_k of every gram, symm, matmul), every operand type and accumulator.
//
// The kernel's body and its plain C interface, shared by three libraries, one translation
// unit each so that their builds run side by side; each defines select(), select_batched()
// and ring_depth() over its own instantiations:
//   leaf_products.cu       fp32 and bf16 operand tiles, fp32 accumulator (the main path)
//   leaf_products_lowp.cu  fp16, fp8 e4m3fn and fp8 e5m2 operand tiles, fp32 accumulator
//   leaf_products_acc.cu   a bf16 or fp64 accumulator, over fp32, bf16, fp16 and fp8 tiles
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
//     seed, if any), its last rounds into the output type (an output of another type than the
//     accumulator accumulates in a workspace of the accumulator's type until then);
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
// The packed output, the seed, the output's type and the skipped ops are fields of the launch,
// not template parameters.  Pair mode is one (a dense right side, both sides of one type), so
// that the one-position walk, which issues about as many instructions as the card can (the
// product is 1024 FFMAs a step a thread), carries none of its per-step work; so are the
// operand types and the accumulator.  Tensor cores (3xTF32, wgmma) are later work: no TF32 on
// this fp32 path.
//
// Arithmetic, the same at every STAGES, every TILE and in either mode: each stored element is
// widened to fp32 (exact from bf16, fp16 and fp8) and each element's signed sum runs in term
// order as sum = sum + coef * x (no FMA contraction), carried from one ring slot of a chunk to
// the next through the sum buffer, and depth past the K block sums to 0; the product of a K
// block accumulates by fmaf over its depth into one fp32 part (the TPU kernel's one dot per
// grid step).  Then, by the accumulator Acc:
//   fp32       the part is added into P_o once per K block, and D = D + sign * P_o once per
//              op, each rounded, D starting from the seed or from the first contribution;
//   bf16, fp64 the TPU kernel's rounding points: at the end of each K block, sign * part is
//              rounded to Acc and added into each destination of the op, the sum rounded to
//              Acc (acc += contrib.astype(acc)), K block by K block, op by op; D starts from
//              the seed rounded to Acc.  The workspace is then of type Acc, and a block that
//              owns a sub-tile that is its own mirror walks its op twice (as a pair does), so
//              that an element takes every K block of a straight slot before those of a
//              transposed one whatever the tile.
//              Where the running values live (PER_K): the first n_run slots of each op
//              (Ops::n_run, the host's strassen_fused.run_dests: as many destinations as the
//              shared memory left beside the ring holds at the tile, TILE^2 Acc values each)
//              keep them in shared memory from the op's first K block to its last, one cell a
//              (slot, element of the thread's R x R outputs), laid out [slot][element][thread]
//              so that a warp's accesses are conflict-free.  The op's first K block reads the
//              destination (the seed, the workspace, or nothing) and adds its term into the
//              cell, each later one adds into the cell, and the last writes the sum (to the
//              workspace, or cast into the output where the slot is the last to feed it): one
//              read and one write of global memory an element and op, not one a K block.  A
//              slot past n_run reads and writes the workspace every K block, four elements a
//              vector where its elements are a row's.  The cell of an element belongs to the
//              thread that computes its product, also for a transposed slot, whose element
//              lies in another thread's part of the output: within one walked item each
//              target element is fed by one (slot, element) of one thread, and items follow
//              one another through the workspace across the walk's barriers.  So each element
//              takes exactly the rounded sums it took when every K block went through global
//              memory, in the same order: the bits do not change.
// The seed is cast into the accumulator's type where it is read, and the output is cast from
// the accumulator once, where the last slot feeding an element ends: fp64 goes through fp32 to
// a narrower type, as torch's .to() does.
//
// A launch over a stack of slots (the port of jax.vmap over the TPU kernel: Shampoo's
// statistics, the Gram service's buckets) takes a kernel of its own, leaf_products_batched_
// kernel: a persistent grid whose blocks take (slot, position) items heaviest first, a
// producer warp keeping one ring running through them, at a tile the host picks for the stack
// (see walk_items).
//
// Interface: plain C, loaded with ctypes.  The launchers return cudaGetLastError() after the
// launch.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int KC = 16;             // contraction depth per chunk
// The batched kernel's at each tile: 16 at TILE 128, 32 at 64, where a 64 x 64 x 16 step is
// too little work for the step's waits and barrier (at 128 the deeper step doubles the sum
// buffers and the registers of the sum phase)
__host__ __device__ constexpr int batched_kc(int tile) { return tile == 64 ? 32 : KC; }
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
  static constexpr int BKC = batched_kc(TILE);   // the batched kernel's chunk depth,
  static constexpr int BCHUNK = BKC * TILE;      //   chunk
  static constexpr int BSUM = BKC * LDS;         //   and summed chunk
  static constexpr int R = TILE / 16;            // outputs a thread owns along each axis
  static constexpr int XQ = TILE / 32;           // x groups of a thread's summed elements
};

// Raw chunks each right term holds in a ring slot: a tri term on a diagonal tile under
// diag_sym reads the stored chunk and its mirror.
__host__ __device__ constexpr int right_chunks(bool tri) { return tri ? 2 : 1; }

// Element types of the C interface (strassen_fused's dtype codes): operand tiles, the seed and
// the output.  An fp64 operand is stored as fp32 by the wrapper: the TPU kernel upcasts every
// tile to fp32 before any arithmetic.
enum Dtype { F32 = 0, BF16 = 1, F16 = 2, E4M3 = 3, E5M2 = 4, F64 = 5 };
// Accumulators.
enum AccCode { ACC_F32 = 0, ACC_BF16 = 1, ACC_F64 = 2 };

__host__ __device__ constexpr int elem_bytes(int code) {
  return code == F64 ? 8 : code == F32 ? 4 : code == BF16 || code == F16 ? 2 : 1;
}

// A stored element widened to fp32: exact for every operand type.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E5M2)));
}

// fp32 rounded to the accumulator's type, and a sum rounded in it.
template <typename Acc>
__device__ __forceinline__ Acc from_f32(float x) {
  if constexpr (std::is_same_v<Acc, __nv_bfloat16>) return __float2bfloat16_rn(x);
  else return static_cast<Acc>(x);
}
__device__ __forceinline__ float acc_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double acc_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 acc_add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

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
  void* ws;             // the accumulator's workspace, of its type (the output itself when the
                        //   output is of that type)
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
  int seed_code;        // the seed's element type (a Dtype)
  int out_cast;         // the output is not the workspace: the last slot casts into it
  int n_big;            // blocks that walk a whole position; the rest walk quarters
  int out_code;         // the output's element type (a Dtype)
  int l_pitch, r_pitch; // fp8 sides: the stored columns of one tile (its width rounded up to
                        //   16; the rest zeros)
  int batch;            // slots of a batched launch (1 for the one-position walk): every slot
                        //   runs this program
  long long slot_elems; // elements of one slot's output (and workspace)
  int n_run;            // bf16, fp64 accumulators: an op's slots (its first n_run) whose running
                        //   values stay in shared memory over its K blocks (0: none, and fp32)
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

// Four seed elements of type `code` (fp32, bf16, fp16, fp64) as fp32, at a multiple of 4.
__device__ __forceinline__ float4 load4(const void* base, long long at, int code) {
  if (code == F32) return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + at);
  if (code == F64) {
    const double2* p = reinterpret_cast<const double2*>(static_cast<const double*>(base) + at);
    const double2 lo = p[0], hi = p[1];
    return make_float4(__double2float_rn(lo.x), __double2float_rn(lo.y),
                       __double2float_rn(hi.x), __double2float_rn(hi.y));
  }
  const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const char*>(base) + 2 * at);
  if (code == BF16) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
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

// Bytes of the running values one slot of an op keeps in shared memory (PER_K): TILE^2 values
// of the accumulator; an fp32 accumulator keeps none there.
size_t run_bytes(int acc, int tile) {
  return static_cast<size_t>(tile) * tile * (acc == ACC_F64 ? 8 : acc == ACC_BF16 ? 2 : 0);
}

// n_run: the slots of an op whose running values stay on chip (Ops::n_run).
size_t smem_bytes(bool right_tri, int tmax, int tile, int left_bytes, int right_bytes,
                  int stages, bool pair, int acc, int n_run) {
  const size_t chunk = static_cast<size_t>(KC) * tile;
  return static_cast<size_t>(stages) * slot_terms(tmax, pair) * chunk *
             (left_bytes + right_chunks(right_tri) * right_bytes)  // raw rings
         + 2 * 2 * static_cast<size_t>(KC) * (tile + 4) * sizeof(float)  // summed, 2 buffers
         + static_cast<size_t>(stages) * (sizeof(StepTerms) + sizeof(uint64_t))  // per slot
         + n_run * run_bytes(acc, tile);  // running values
}

// The batched kernel's: batched_kc-deep chunks, a dense right side, no pair mode.
size_t batched_smem_bytes(int tmax, int tile, int bytes, int stages) {
  const size_t depth = batched_kc(tile), chunk = depth * tile;
  return static_cast<size_t>(stages) * tmax * chunk * 2 * bytes  // raw rings
         + 2 * 2 * depth * (tile + 4) * sizeof(float)              // summed, 2 buffers
         + static_cast<size_t>(stages) * (sizeof(StepTerms) + sizeof(uint64_t));  // per slot
}

// One seed element of type `code` (fp32, bf16, fp16, fp64) in the accumulator's type: fp64
// rounded to fp32 first where the accumulator is narrower (as torch's .to() and the plain
// version round it).
template <typename Acc>
__device__ __forceinline__ Acc load_seed(const void* base, long long at, int code) {
  if (code == F64) {
    const double v = static_cast<const double*>(base)[at];
    if constexpr (std::is_same_v<Acc, double>) return v;
    else return from_f32<Acc>(__double2float_rn(v));
  }
  const float v = code == F32    ? static_cast<const float*>(base)[at]
                  : code == BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[at])
                                 : __half2float(static_cast<const __half*>(base)[at]);
  return from_f32<Acc>(v);
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
// Four fp32 values cast into output elements of type `code` (bf16, fp16, fp64; fp32 output is
// the workspace), at a multiple of 4.
__device__ __forceinline__ void store4(void* out, long long at, int code, float a, float b,
                                       float c, float d) {
  if (code == BF16) {
    store4(static_cast<__nv_bfloat16*>(out) + at, a, b, c, d);
  } else if (code == F16) {
    __half2 lo = __floats2half2_rn(a, b), hi = __floats2half2_rn(c, d);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned*>(&lo);
    raw.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__half*>(out) + at) = raw;
  } else {
    double2* p = reinterpret_cast<double2*>(static_cast<double*>(out) + at);
    p[0] = make_double2(a, b);
    p[1] = make_double2(c, d);
  }
}
// An accumulated value cast into an output element of type `code` (fp32, bf16, fp16, fp64);
// fp64 goes through fp32 to a narrower type, as torch's .to() does.
__device__ __forceinline__ void store1(void* out, long long at, int code, float v) {
  switch (code) {
    case F32: static_cast<float*>(out)[at] = v; break;
    case BF16: static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v); break;
    case F16: static_cast<__half*>(out)[at] = __float2half_rn(v); break;
    default: static_cast<double*>(out)[at] = v;
  }
}
__device__ __forceinline__ void store1(void* out, long long at, int code, __nv_bfloat16 v) {
  if (code == BF16) static_cast<__nv_bfloat16*>(out)[at] = v;
  else store1(out, at, code, __bfloat162float(v));
}
__device__ __forceinline__ void store1(void* out, long long at, int code, double v) {
  if (code == F64) static_cast<double*>(out)[at] = v;
  else store1(out, at, code, __double2float_rn(v));
}

// The arithmetic of a walk, shared by walk() (DEPTH = KC) and the batched kernel's walk_items()
// (DEPTH = batched_kc(TILE)): the elements of a DEPTH x TILE chunk a thread sums, the signed sums
// of a side's terms, the summed chunk's store, its product, and the fp32 writes of a product
// into a destination.  An item of either walks the same operations in the same order.

// The rows kk of the chunk whose elements (kk, lane + 32 q) a thread sums, H = DEPTH / 8 of
// them: kk = (H warp + h + lane / 2 + 16 (lane % 2)) % DEPTH.  A warp's 32 lanes hit 32 banks
// where a chunk is read as it lies DEPTH x TILE ([kk][x]), where it lies TILE x DEPTH ([x][kk],
// kk skewed by lane / 2, and at DEPTH 32 a lane pair 16 rows apart) and where the sum is written
// ([kk][x] in rows of TILE + 4).  Ownership is fixed for the whole kernel, so each element sums
// its terms in table order, and a chunk's later ring slot reads back what this thread left in
// the buffer.
template <int DEPTH>
__device__ __forceinline__ void sum_rows(int (&kk_of)[DEPTH / 8], int warp, int lane) {
#pragma unroll
  for (int h = 0; h < DEPTH / 8; ++h)
    kk_of[h] = (warp * (DEPTH / 8) + h + (lane >> 1) + 16 * (lane & 1)) % DEPTH;
}

// Adds the n dense terms of a side into v: term p's coefficient c[p] times its chunk, the p-th
// at chunks, read as it lies (DEPTH x TILE where kx, else TILE x DEPTH); each element's terms in
// table order as v = v + coef * x, no FMA contraction.
template <int TILE, int DEPTH, typename T>
__device__ __forceinline__ void sum_terms(float (&v)[DEPTH / 8][TILE / 32], const T* chunks,
                                          const float* c, int n, bool kx,
                                          const int (&kk_of)[DEPTH / 8], int lane) {
  for (int p = 0; p < n; ++p) {
    const float cp = c[p];
    const T* src = chunks + p * DEPTH * TILE;
#pragma unroll
    for (int h = 0; h < DEPTH / 8; ++h)
#pragma unroll
      for (int q = 0; q < TILE / 32; ++q) {
        const int x = lane + 32 * q;
        const int at = kx ? kk_of[h] * TILE + x : x * DEPTH + kk_of[h];
        v[h][q] = __fadd_rn(v[h][q], __fmul_rn(cp, to_f32(src[at])));
      }
  }
}

// A summed chunk into the sum buffers ([kk][x] in rows of TILE + 4): depth past the K block
// (from row k_lim: the box's next K block, or zeros past the operand) sums to 0.
template <int TILE, int DEPTH>
__device__ __forceinline__ void store_sums(const float (&l)[DEPTH / 8][TILE / 32],
                                           const float (&r)[DEPTH / 8][TILE / 32], float* lsum,
                                           float* rsum, const int (&kk_of)[DEPTH / 8], int lane,
                                           int k_lim) {
#pragma unroll
  for (int h = 0; h < DEPTH / 8; ++h)
#pragma unroll
    for (int q = 0; q < TILE / 32; ++q) {
      const bool live = kk_of[h] < k_lim;
      lsum[kk_of[h] * (TILE + 4) + lane + 32 * q] = live ? l[h][q] : 0.f;
      rsum[kk_of[h] * (TILE + 4) + lane + 32 * q] = live ? r[h][q] : 0.f;
    }
}

// part += the summed chunk's product over its DEPTH rows by fmaf, for this thread's outputs:
// rows 64 a + 4 ty + i, columns 64 b + 4 tx + j of the sub-tile.
template <int TILE, int DEPTH>
__device__ __forceinline__ void multiply_chunk(float (&part)[TILE / 16][TILE / 16],
                                               const float* lsum, const float* rsum, int tx,
                                               int ty) {
  constexpr int R = TILE / 16, LDS = TILE + 4;
#pragma unroll
  for (int kk = 0; kk < DEPTH; ++kk) {
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
}

template <int R>
__device__ __forceinline__ void zero(float (&a)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) a[i][j] = 0.f;
}

// The end of a K block under an fp32 accumulator: its part added into the op's product,
// rounded, and the part cleared.
template <int R>
__device__ __forceinline__ void fold_part(float (&prod)[R][R], float (&part)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      prod[i][j] = __fadd_rn(prod[i][j], part[i][j]);
      part[i][j] = 0.f;
    }
}

// The first output row and column of sub-tile (p0i, p0j) of position (pi, pj) of leaf
// destination ld; false where the output holds none (above the diagonal of a diagonal leaf
// block of a packed output).
__device__ __forceinline__ bool dest_origin(const Ops& P, int ld, int pi, int pj, int p0i,
                                            int p0j, long long& row0, long long& col0) {
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
}

// Four accumulator values at a multiple of 4 elements, as one vector.
__device__ __forceinline__ void load4(const double* p, double (&w)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, __nv_bfloat16 (&w)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
}
__device__ __forceinline__ void store4(double* p, const double (&w)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(w[0], w[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(w[2], w[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 (&w)[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = w[0]; lo.y = w[1]; hi.x = w[2]; hi.y = w[3];
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Four fp32 values v into the elements at `at` (the slot's offset included) of an fp32
// accumulator: onto the seed where the slot is the first to feed them, else onto what they hold,
// each rounded; cast into the output where the slot is the last, unless the output is the
// workspace.  The seed is read by the thread that writes the element, before it writes: the
// seed may be the output.
__device__ __forceinline__ void put4_f32(const Ops& P, long long at, float (&v)[4], int flag) {
  float* const ws = static_cast<float*>(P.ws);
  if (!(flag & FIRST) || P.seed != nullptr) {
    const float4 w = flag & FIRST ? load4(P.seed, at, P.seed_code)
                                  : *reinterpret_cast<const float4*>(ws + at);
    v[0] = __fadd_rn(w.x, v[0]);
    v[1] = __fadd_rn(w.y, v[1]);
    v[2] = __fadd_rn(w.z, v[2]);
    v[3] = __fadd_rn(w.w, v[3]);
  }
  if ((flag & LAST) && P.out_cast)
    store4(P.out, at, P.out_code, v[0], v[1], v[2], v[3]);
  else
    store4(ws + at, v[0], v[1], v[2], v[3]);
}

// sign * val, a thread's outputs of sub-tile (i0, j0), into a straight destination whose
// sub-tile starts at (row0, col0) of rows ldo long: put(e, at, v) takes four elements of a row,
// val's i * R + 4 g + (0..3), at their offset.  Rows past bi and columns past bj belong to no
// output.
template <int R, typename Put>
__device__ __forceinline__ void write_straight(const Ops& P, const float (&val)[R][R], float sg,
                                               long long row0, long long col0, long long ldo,
                                               int i0, int j0, int tx, int ty, Put&& put) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int x = (i / 4) * 64 + ty * 4 + i % 4;
    if (i0 + x >= P.bi) continue;
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const int y = g * 64 + tx * 4;
      if (j0 + y >= P.bj) continue;  // bj is a multiple of 8: all 4 columns are in
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(sg, val[i][4 * g + j]);
      put(i * R + 4 * g, (row0 + x) * ldo + col0 + y, v);
    }
  }
}

// One block's walk of every op at one position: output tile (iq, jq) of a leaf block,
// TILE x TILE sub-tile (i0, j0) of it; in PAIR mode also at its mirror, tile (jq, iq),
// sub-tile (j0, i0).  The three operand maps are the left side's, the right side's and, for a
// tri right side, the mirrored read of the same stack (boxes TILE x KC where the stored box is
// KC x TILE).  z is the block's slot: the outermost coordinate of every box, and the slot's
// output, workspace and seed lie at z * slot_elems (0 here: batched launches take
// leaf_products_batched_kernel).  PAIRS: the
// pair-mode instantiation, whose ring slots hold GROUP terms a side
// (a chunk of an op with more takes several slots in turn); elsewhere a slot holds tmax.  Acc:
// the accumulator's type (float, __nv_bfloat16 or double).
template <typename Tl, typename Tr, typename Acc, bool TRI, int TILE, int STAGES, bool PAIRS>
__device__ __forceinline__ void walk(const Ops& P, const CUtensorMap& lmap,
                                     const CUtensorMap& rmap, const CUtensorMap& mmap, int iq,
                                     int jq, int i0, int j0, int mode, int z) {
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

  const long long so = static_cast<long long>(z) * P.slot_elems;  // batch slot z's elements
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int n_kc = (P.bc + KC - 1) / KC;
  // An accumulator other than fp32 takes each K block's part where it ends (PER_K).
  constexpr bool PER_K = !std::is_same_v<Acc, float>;
  // The items walked, u = 2 o + m: op o at the block's position (m = 0) or at its mirror
  // (m = 1, PAIR mode; also SELF under PER_K, the mirror being the position itself).  A
  // position above the diagonal of a leaf block (iq < jq of a packed output) holds no tile of
  // a diagonal leaf block: there the ops that feed only diagonal blocks, straight, are skipped.
  const int end = 2 * P.n_ops;
  auto live_item = [&](int u) {
    for (; u < end; ++u) {
      const bool mirror = u & 1;
      if (mirror && (PER_K ? mode == SINGLE : mode != PAIR)) continue;
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
    // A box's first column must lie on 16 bytes: an fp8 side whose tiles are not 16 columns
    // wide is stored with each tile's columns padded to its pitch (l_pitch, r_pitch).
    if (!right_side) {
      Tl* dst = lring + (static_cast<size_t>(slot) * gw + p) * CHUNK;
      const int lr = term_row, lc = term_col;
      if (P.left_trans) {  // K x i: rows (lrow*n_k + k)*bc + kc.., cols (lcol*q_i + wi)*bi + wi0..
        const int pitch = sizeof(Tl) == 1 ? P.l_pitch : P.bi;
        tma_load(dst, &lmap, (lc * P.q_i + wi) * pitch + wi0, (lr * P.n_k + t.k) * P.bc + kc,
                 z, &full[slot]);
      } else {  // i x K: rows (lrow*q_i + wi)*bi + wi0.., cols (lcol*n_k + k)*bc + kc..
        const int pitch = sizeof(Tl) == 1 ? P.l_pitch : P.bc;
        tma_load(dst, &lmap, (lc * P.n_k + t.k) * pitch + kc, (lr * P.q_i + wi) * P.bi + wi0,
                 z, &full[slot]);
      }
      return;
    }
    Tr* dst = rring + (static_cast<size_t>(slot) * gw + p) * RC * CHUNK;
    if constexpr (TRI) {
      if (!tt.mirrored || tt.diag)  // stored rows kc.., cols wj0..
        tma_load(dst, &rmap, wj0, static_cast<int>(tt.row) + kc, z, &full[slot]);
      if (tt.mirrored || tt.diag)   // stored rows wj0.., cols kc..
        tma_load(dst + CHUNK, &mmap, kc, static_cast<int>(tt.row) + wj0, z, &full[slot]);
    } else {
      const int rr = term_row, rc = term_col;
      if (P.right_jk) {  // j x K: rows (rrow*q_j + wj)*bj + wj0.., cols (rcol*n_k + k)*bc + kc..
        const int pitch = sizeof(Tr) == 1 ? P.r_pitch : P.bc;
        tma_load(dst, &rmap, (rc * P.n_k + t.k) * pitch + kc, (rr * P.q_j + wj) * P.bj + wj0,
                 z, &full[slot]);
      } else {  // K x j: rows (rrow*n_k + k)*bc + kc.., cols (rcol*q_j + wj)*bj + wj0..
        const int pitch = sizeof(Tr) == 1 ? P.r_pitch : P.bj;
        tma_load(dst, &rmap, (rc * P.q_j + wj) * pitch + wj0, (rr * P.n_k + t.k) * P.bc + kc,
                 z, &full[slot]);
      }
    }
  };

  // The elements (kk_of[h], lane + 32 q) of a chunk this thread sums (sum_rows).
  int kk_of[KC / 8];
  sum_rows<KC>(kk_of, warp, lane);

  // Returns whether the step was its chunk's last ring slot.
  auto sum_phase = [&](const Chunk& t, int slot, float* lsum, float* rsum) {
    const StepTerms& st = terms[slot];
    const Tl* lslot = lring + static_cast<size_t>(slot) * gw * CHUNK;
    const Tr* rslot = rring + static_cast<size_t>(slot) * gw * RC * CHUNK;
    float l[KC / 8][XQ], r[KC / 8][XQ];
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
    sum_terms<TILE, KC>(l, lslot, st.lc, st.n_l, P.left_trans, kk_of, lane);
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
      sum_terms<TILE, KC>(r, rslot, st.rc, st.n_r, !P.right_jk, kk_of, lane);
    }
    store_sums<TILE, KC>(l, r, lsum, rsum, kk_of, lane, P.bc - t.c * KC);
    return !PAIRS || st.last != 0;
  };

  // This thread's outputs: rows 64 a + 4 ty + i, columns 64 b + 4 tx + j of the sub-tile.
  float part[R][R], prod[R][R];
  zero(part);
  zero(prod);

  const long long ldo = P.out_tri ? P.bj : static_cast<long long>(P.blocks_j) * P.q_j * P.bj;
  // Under PER_K: whether the K block being written is its op's first and its last, and the
  // running values of the op's first P.n_run slots, one cell a (slot d, element e of val) of
  // this thread, [d][e][thread] after the ring's barriers.
  bool k_first = true, k_last = true;
  Acc* const cells = reinterpret_cast<Acc*>(full + STAGES);
  auto cell = [&](int d, int e) -> Acc& {
    return cells[(static_cast<size_t>(d) * R * R + e) * THREADS + tid];
  };
  // Output element `at` takes v, val's element e times the sign of slot d (sign times the op's
  // product, or under PER_K times one K block's part): onto the seed where the slot is the
  // first to feed it, else onto what it holds, rounded in the accumulator's type; cast into the
  // output where the slot is the last, unless the output is the workspace.  The seed is read by
  // the thread that writes the element, before it writes: the seed may be the output.  Under
  // PER_K a kept slot (d < P.n_run) holds what it holds in its cell between its op's first K
  // block and its last.
  auto put1 = [&](int d, int e, long long at, float v, int flag) {
    at += so;
    Acc* const ws = static_cast<Acc*>(P.ws);
    if constexpr (PER_K) {
      const bool kept = d < P.n_run;
      const Acc term = from_f32<Acc>(v);
      const Acc x = kept && !k_first ? acc_add(cell(d, e), term)
                    : !(flag & FIRST) ? acc_add(ws[at], term)
                    : P.seed != nullptr
                        ? acc_add(load_seed<Acc>(P.seed, at, P.seed_code), term)
                        : term;
      if (kept && !k_last)
        cell(d, e) = x;
      else if ((flag & LAST) && P.out_cast)
        store1(P.out, at, P.out_code, x);
      else
        ws[at] = x;
    } else {
      if (!(flag & FIRST) || P.seed != nullptr)
        v = __fadd_rn(flag & FIRST ? load_seed<float>(P.seed, at, P.seed_code) : ws[at], v);
      if ((flag & LAST) && P.out_cast)
        store1(P.out, at, P.out_code, v);
      else
        ws[at] = v;
    }
  };
  // put1 over the four elements e.. of a row at `at`.., the workspace read and written as one
  // vector.
  auto put4 = [&](int d, int e, long long at, float (&v)[4], int flag) {
    if constexpr (PER_K) {
      at += so;
      Acc* const ws = static_cast<Acc*>(P.ws);
      const bool kept = d < P.n_run;
      Acc x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = from_f32<Acc>(v[j]);
      if (kept && !k_first) {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = acc_add(cell(d, e + j), x[j]);
      } else if (!(flag & FIRST)) {
        Acc w[4];
        load4(ws + at, w);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = acc_add(w[j], x[j]);
      } else if (P.seed != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[j] = acc_add(load_seed<Acc>(P.seed, at + j, P.seed_code), x[j]);
      }
      if (kept && !k_last) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cell(d, e + j) = x[j];
      } else if ((flag & LAST) && P.out_cast) {
#pragma unroll
        for (int j = 0; j < 4; ++j) store1(P.out, at + j, P.out_code, x[j]);
      } else {
        store4(ws + at, x);
      }
    } else {
      put4_f32(P, at + so, v, flag);
    }
  };
  // Adds sign * val into each destination of item t's op, where `keep` holds of the slots'
  // FIRST and LAST flags (under PER_K they hold only at an op's first and last K block).  The
  // walked sub-tile W (the mirror when the item is) takes the straight slots, in the order of
  // its half (below the diagonal unless it is the mirror), and the other sub-tile of the pair
  // the transposed ones, in the order of the other half.  A SELF sub-tile takes in a first
  // pass what comes first for each element and, after a barrier, the rest; under PER_K its op
  // is walked twice, the first walk making the first pass and the mirror walk the second.  The
  // slots before d0 took val in their cells (finish_step).
  auto write_dests = [&](const Chunk& t, const float (&val)[R][R], int keep, int d0) {
    const int o = t.u >> 1;
    const bool mirror = t.u & 1;
    const int wi = mirror ? jq : iq, wj = mirror ? iq : jq;
    const int wi0 = mirror ? j0 : i0, wj0 = mirror ? i0 : j0;
    const int w_shift = mirror ? UPPER : 0;
#pragma unroll 1
    for (int run = 0; run < (mode == SELF && !PER_K ? 2 : 1); ++run) {
      const int pass = PER_K ? static_cast<int>(mirror) : run;
      if (run) __syncthreads();  // the first pass's writes, seen by the second's readers
      for (int d = d0; d < P.max_dests; ++d) {
        const int at_d = o * P.max_dests + d;
        const float sg = P.dsgn[at_d];
        if (sg == 0.f) break;  // an op's destinations come first
        const int flags = P.dflag[at_d];
        // only pair mode has transposed slots (and the compiler drops their writes elsewhere)
        const bool trn = mode != SINGLE && P.dtrn[at_d] != 0;
        long long row0, col0;  // of W, or of the other sub-tile for a transposed slot
        if (!(trn ? dest_origin(P, P.dest[at_d], wj, wi, wj0, wi0, row0, col0)
                  : dest_origin(P, P.dest[at_d], wi, wj, wi0, wj0, row0, col0)))
          continue;
        if (mode != SELF && !trn) {
          const int flag = (flags >> w_shift) & keep;
          write_straight(P, val, sg, row0, col0, ldo, wi0, wj0, tx, ty,
                         [&](int e, long long at, float (&v)[4]) { put4(d, e, at, v, flag); });
          continue;
        }
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
            for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(sg, val[i][4 * g + j]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // element (x, y + j) of W goes straight there, transposed to (y + j, x)
              const long long at =
                  trn ? (row0 + y + j) * ldo + col0 + x : (row0 + x) * ldo + col0 + y + j;
              const int e = i * R + 4 * g + j;
              if (mode != SELF) {
                put1(d, e, at, v[j], (flags >> (UPPER - w_shift)) & keep);
                continue;
              }
              // the target lies on or below the diagonal: straight first, else transposed
              const bool lower = trn ? y + j >= x : x >= y + j;
              if ((lower == trn) == (pass == 1))
                put1(d, e, at, v[j], (flags >> (lower ? 0 : UPPER)) & keep);
            }
          }
        }
      }
    }
  };
  // After step t, the last ring slot of its chunk.  An fp32 accumulator adds the part of a K
  // block that ends into the item's product, and at the end of the item sign * product into
  // each destination of its op; under PER_K each K block's sign * part goes into them.  Between
  // an op's first K block and its last, a kept slot's part goes into its cells alone, every
  // element at once, with no output address computed (what a cell that no output element reads
  // takes is never stored).
  auto finish_step = [&](const Chunk& t) {
    if (t.c != n_kc - 1) return;
    if constexpr (PER_K) {
      k_first = t.k == 0;
      k_last = t.k == P.n_k - 1;
      int d0 = 0;
      if (!k_first && !k_last) {
        const int o = t.u >> 1;
        for (; d0 < P.n_run; ++d0) {
          const float sg = P.dsgn[o * P.max_dests + d0];
          if (sg == 0.f) break;
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j)
              cell(d0, i * R + j) =
                  acc_add(cell(d0, i * R + j), from_f32<Acc>(__fmul_rn(sg, part[i][j])));
        }
      }
      write_dests(t, part, (k_first ? FIRST : 0) | (k_last ? LAST : 0), d0);
      zero(part);
      return;
    }
    fold_part(prod, part);
    if (t.k != P.n_k - 1) return;
    write_dests(t, prod, FIRST | LAST, 0);
    zero(prod);
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
        multiply_chunk<TILE, KC>(part, lsum(buf), rsum(buf), tx, ty);
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
      if (done_chunk) multiply_chunk<TILE, KC>(part, lsum(buf ^ 1), rsum(buf ^ 1), tx, ty);
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
// are their own mirrors, which walk half as much (as much under PER_K), last.  Pair mode is its
// own instantiation (PAIRS), so the one-position walk keeps none of its code.  The arithmetic
// of an output element depends neither on the tile nor on the mode.
//
// The slot of a block is g % batch of walk item g, batch being 1 here: batched launches take
// the persistent leaf_products_batched_kernel below, whose list of items keeps this order.
template <typename Tl, typename Tr, typename Acc, bool TRI, int TILE, int STAGES, bool PAIRS>
__device__ __forceinline__ void run(const Ops& P, const CUtensorMap& lmap,
                                    const CUtensorMap& rmap, const CUtensorMap& mmap,
                                    const CUtensorMap& lmap_half, const CUtensorMap& rmap_half,
                                    const CUtensorMap& mmap_half) {
  const int n_sub_i = (P.bi + TILE - 1) / TILE, n_sub_j = (P.bj + TILE - 1) / TILE;
  int iq, jq, i0, j0, mode = SINGLE, z;
  if constexpr (PAIRS) {  // square tiles: n_sub_i == n_sub_j
    const int side = P.q_i * n_sub_i;
    const int n_two = side * (side - 1) / 2;
    const int item = static_cast<int>(blockIdx.x) / P.batch;
    z = static_cast<int>(blockIdx.x) % P.batch;
    int I, J = item - n_two;
    if (J < 0) {
      tri_decode(item, I, J);
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
    z = pos % P.batch;
    pos /= P.batch;
    j0 = (pos % n_sub_j) * TILE;
    pos /= n_sub_j;
    i0 = (pos % n_sub_i) * TILE;
    pos /= n_sub_i;
    cell_of(P, pos, iq, jq);
    if constexpr (TILE == 128) {
      if (quarter >= 0) {
        walk<Tl, Tr, Acc, TRI, TILE / 2, STAGES, false>(
            P, lmap_half, rmap_half, mmap_half, iq, jq, i0 + (quarter / 2) * (TILE / 2),
            j0 + (quarter % 2) * (TILE / 2), SINGLE, z);
        return;
      }
    }
  }
  walk<Tl, Tr, Acc, TRI, TILE, STAGES, PAIRS>(P, lmap, rmap, mmap, iq, jq, i0, j0, mode, z);
}

// ---------------------------------------------------------------------------------------------
// The batched launch (batch > 1: the port of jax.vmap over the TPU kernel, whose grid gains a
// leading batch axis), for the gram kinds that read one operand as a dense right side (ata,
// aat; the strassen gram: no transposed destination, no seed) with an fp32 accumulator.  Its
// callers launch stacks of a few slots (Shampoo's statistics: up to 44 slots of 1024^2, or
// 1-4 of 256^2; the Gram service's buckets of 4).  What bounds it is the one-position walk's:
// the products on the fp32 CUDA cores.  Its design:
//   * persistent: a grid of at most blocks-an-SM x SMs blocks (strassen_fused.batched_plan)
//     walks the launch's items, (slot, position) pairs at its tile, in the one-position
//     walk's order with the slot innermost (item g is position g / batch of slot g % batch,
//     every slot's heavy cells before any slot's light ones) and only those that write
//     something.  Block b walks item b, then takes the next from a counter, so the heaviest
//     item left goes to the first block free, as the hardware hands out the blocks of a
//     launch of one block a position (a static stride leaves the blocks that drew light
//     items idle at the end);
//   * warp-specialized: one warp of a producer warpgroup issues every copy, into a ring whose
//     slots the consumers hand back through an mbarrier each, and runs on across items, so
//     the boxes of the next item are in flight while this item's last chunks are multiplied
//     and its destinations written; the two consumer warpgroups are walk()'s 256 threads,
//     freed of the copies (whose warp would otherwise hold the step's barrier for all) and of
//     their registers (setmaxnreg gives them 232 at TILE 128);
//   * TILE 128 takes one block an SM and steps 16 deep, TILE 64 (4 x 4 outputs a thread) two
//     and steps 32 deep (batched_kc); the host picks the tile whose busiest block takes least
//     (strassen_fused.batched_plan): 64 for stacks whose 128-tile items leave SMs idle.
// An item walks its position exactly as walk() does in SINGLE mode with an fp32 accumulator,
// so every output element takes the same operations in the same order: each slot's bits are
// those of a launch on that slot alone, at either tile.
// ---------------------------------------------------------------------------------------------

// A block's place in its walk: its j-th item, item g of the launch, live op o of the item's
// position, K block k, chunk c of the K block; light: the position lies above the diagonal of
// a leaf block of a packed output (it skips the ops that feed only diagonal blocks).
// g >= n_items: walked out.
struct Cursor {
  int j, g, o, k, c;
  bool light;
};

// Where item g lies: slot z, output tile (iq, jq) of a leaf block, sub-tile (i0, j0).
struct Item {
  int z, iq, jq, i0, j0;
};

// Packed lower-triangular index t -> (i, j), i >= j, for the cells of a leaf block (t below
// 2^24): an fp32 root estimate and its integer correction, cell_of's decode without the fp64
// registers of tri_decode.
__device__ __forceinline__ void cell_decode(int t, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.f * static_cast<float>(t) + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  while (r * (r + 1) / 2 > t) --r;
  i = r;
  j = t - r * (r + 1) / 2;
}

template <int TILE>
__device__ __forceinline__ Item item_of(const Ops& P, int g) {
  const int n_sub_i = (P.bi + TILE - 1) / TILE, n_sub_j = (P.bj + TILE - 1) / TILE;
  Item w;
  w.z = g % P.batch;
  int pos = g / P.batch;
  w.j0 = (pos % n_sub_j) * TILE;
  pos /= n_sub_j;
  w.i0 = (pos % n_sub_i) * TILE;
  pos /= n_sub_i;
  // the cell, in cell_of's order
  const int heavy = P.q_i * (P.q_i + 1) / 2;
  if (!P.out_tri) {
    w.iq = pos / P.q_j;
    w.jq = pos % P.q_j;
  } else if (pos < heavy) {
    cell_decode(pos, w.iq, w.jq);
  } else {
    int i, j;
    cell_decode(pos - heavy, i, j);
    w.iq = j;
    w.jq = i + 1;
  }
  return w;
}

// Items a block holds ahead: its j-th item's successor is fetched when its copies enter item j.
constexpr int QUEUE = 8;
// The batched kernel's threads: a producer warpgroup, whose first warp issues the copies, and
// two consumer warpgroups, the 256 threads of walk()'s sums and products; and the named
// barrier the consumers alone meet at (0 is __syncthreads').
constexpr int BATCHED_THREADS = 384;
constexpr int CONSUMERS = 1;

// Registers a thread of the producer warpgroup keeps after entry and a consumer takes: at one
// block an SM (TILE 128) 168 at entry for 384 threads, 40 and 232 after; at two (TILE 64) 80,
// then 24 and 104.
template <int TILE>
constexpr int PRODUCER_REGS = TILE == 64 ? 24 : 40;
template <int TILE>
constexpr int CONSUMER_REGS = TILE == 64 ? 104 : 232;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(CONSUMERS), "r"(THREADS) : "memory");
}

template <typename Tl, typename Tr, int TILE, int STAGES>
__device__ __forceinline__ void walk_items(const Ops& P, const CUtensorMap& lmap,
                                           const CUtensorMap& rmap, int n_items, int* next) {
  using G = Geometry<TILE>;
  constexpr int R = G::R, XQ = G::XQ, CHUNK = G::BCHUNK, BKC = G::BKC;
  // the producer runs at most STAGES steps ahead, and every item has a step
  static_assert(STAGES < QUEUE, "the item queue outruns the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int queue[QUEUE];  // the block's items, the j-th at j % QUEUE
  // a ring slot's barrier for the consumers' release: one arrival a consumer warp once its
  // sum phase has read the slot
  __shared__ uint64_t empty[STAGES];
  const int tmax = P.tmax;      // a ring slot holds every term of a side
  Tl* lring = reinterpret_cast<Tl*>(smem);
  const size_t lring_bytes = static_cast<size_t>(STAGES) * tmax * CHUNK * sizeof(Tl);
  Tr* rring = reinterpret_cast<Tr*>(smem + lring_bytes);
  float* sum_base = reinterpret_cast<float*>(
      smem + lring_bytes + static_cast<size_t>(STAGES) * tmax * CHUNK * sizeof(Tr));
  StepTerms* terms = reinterpret_cast<StepTerms*>(sum_base + 2 * 2 * G::BSUM);  // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + STAGES);                 // [STAGES]

  // the producer warpgroup's threads 0-127; a consumer's place (tid) among the 256 consumers
  const bool producer = threadIdx.x < BATCHED_THREADS - THREADS;
  const int tid = static_cast<int>(threadIdx.x) - (BATCHED_THREADS - THREADS);
  const int tx = tid % 16, ty = tid / 16;
  const int lane = threadIdx.x % 32, warp = tid / 32;
  const int n_kc = (P.bc + BKC - 1) / BKC;

  // A block walks item blockIdx.x, then the items it takes from the launch's counter in turn
  // (every block walks one at a time, so the heaviest left goes to the first block free); the
  // host counts only items that write something, so each has a live op.  Each block takes one
  // item more than it walks, so the launch's takes are numbered 0 .. n_items - 1 from a counter
  // the launch alone owns, 0 at its start.  A take past them finds a counter that was not 0: it
  // traps rather than let a position go unwritten.
  auto take = [&]() {
    const int v = atomicAdd(next, 1);
    if (v >= n_items) __trap();
    return static_cast<int>(gridDim.x) + v;
  };
  auto live_op = [&](int o, bool light) {
    while (o < P.n_ops && light && P.odiag[o]) ++o;
    return o;
  };
  // Cursor t enters its j-th item, the item queued for it.
  auto enter = [&](Cursor& t, int j) {
    t.j = j;
    t.g = queue[j % QUEUE];
    if (t.g >= n_items) return;
    const Item w = item_of<TILE>(P, t.g);
    t.light = P.out_tri && w.iq < w.jq;
    t.o = live_op(0, t.light);
  };
  auto advance = [&](Cursor& t) {
    if (++t.c < n_kc) return;
    t.c = 0;
    if (++t.k < P.n_k) return;
    t.k = 0;
    t.o = live_op(t.o + 1, t.light);
    if (t.o == P.n_ops) enter(t, t.j + 1);
  };

  // The producer's warp starts the copies of a step into ring slot `slot`, lane p the left
  // term p and lane MAX_TERMS + p the right one, as walk() does for a dense right side; it
  // queues the block's next item where its cursor enters one.  The copy state, in registers:
  // the item's slot and its offsets along each side's tiles (decoded once an item), and each
  // lane's term (its coefficient and its tile's offsets along x and y, read once an op).
  const bool right_side = lane >= MAX_TERMS;
  const int p = lane % MAX_TERMS;
  int at_j = -1, at_z = 0, at_l = 0, at_r = 0;
  int term_op = -1, term_x = 0, term_y = 0;
  float coef = 0.f;
  const int l_pitch = sizeof(Tl) == 1 ? P.l_pitch : P.left_trans ? P.bi : P.bc;
  const int r_pitch = sizeof(Tr) == 1 ? P.r_pitch : P.right_jk ? P.bc : P.bj;
  auto start_copies = [&](const Cursor& t, int slot) {
    if (t.j != at_j) {
      if (lane == 0) queue[(t.j + 1) % QUEUE] = take();
      __syncwarp();
      const Item w = item_of<TILE>(P, t.g);
      at_j = t.j;
      at_z = w.z;
      // the item's offset along a K x i side's columns (i x K: rows), and a K x j side's
      // columns (j x K: rows)
      at_l = w.iq * (P.left_trans ? l_pitch : P.bi) + w.i0;
      at_r = w.jq * (P.right_jk ? P.bj : r_pitch) + w.j0;
    }
    if (t.o != term_op) {
      term_op = t.o;
      const int idx = t.o * tmax + p;
      coef = lane < 2 * MAX_TERMS && p < tmax ? (right_side ? P.rsgn : P.lsgn)[idx] : 0.f;
      if (coef != 0.f) {
        const int row = (right_side ? P.rrow : P.lrow)[idx];
        const int col = (right_side ? P.rcol : P.lcol)[idx];
        // the term's tile: K x i rows (row n_k + k) bc.., cols (col q_i + iq) pitch + i0..;
        // i x K rows (row q_i + iq) bi + i0.., cols (col n_k + k) pitch..; the right side
        // likewise with q_j, bj
        const bool kx = right_side ? !P.right_jk : P.left_trans;
        const int q = right_side ? P.q_j : P.q_i, edge = right_side ? P.bj : P.bi;
        const int pitch = right_side ? r_pitch : l_pitch;
        term_x = kx ? col * q * pitch : col * P.n_k * pitch;
        term_y = kx ? row * P.n_k * P.bc : row * q * edge;
      }
    }
    const int kc = t.c * BKC;
    // a side's live terms come first, so its count is its lanes with a coefficient
    const unsigned live = __ballot_sync(0xffffffffu, coef != 0.f);
    const unsigned bytes =
        coef == 0.f ? 0u : CHUNK * static_cast<unsigned>(right_side ? sizeof(Tr) : sizeof(Tl));
    const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
    StepTerms& st = terms[slot];
    if (lane == 0) {
      st.n_l = __popc(live & ((1u << MAX_TERMS) - 1));
      st.n_r = __popc(live >> MAX_TERMS);
    }
    if (coef != 0.f) (right_side ? st.rc : st.lc)[p] = coef;
    __syncwarp();
    if (lane == 0) mbar_expect(&full[slot], total);
    __syncwarp();
    if (coef == 0.f) return;
    const bool kx = right_side ? !P.right_jk : P.left_trans;
    const int off = right_side ? at_r : at_l;
    const int x = kx ? term_x + off : term_x + t.k * (right_side ? r_pitch : l_pitch) + kc;
    const int y = kx ? term_y + t.k * P.bc + kc : term_y + off;
    if (right_side)
      tma_load(rring + (static_cast<size_t>(slot) * tmax + p) * CHUNK, &rmap, x, y, at_z,
               &full[slot]);
    else
      tma_load(lring + (static_cast<size_t>(slot) * tmax + p) * CHUNK, &lmap, x, y, at_z,
               &full[slot]);
  };

  // walk()'s sum phase, dense sides, over BKC-deep chunks (at BKC 16 each thread sums walk()'s
  // elements).
  int kk_of[BKC / 8];
  sum_rows<BKC>(kk_of, warp, lane);
  auto sum_phase = [&](const Cursor& t, int slot, float* lsum, float* rsum) {
    const StepTerms& st = terms[slot];
    float l[BKC / 8][XQ], r[BKC / 8][XQ];
#pragma unroll
    for (int h = 0; h < BKC / 8; ++h)
#pragma unroll
      for (int q = 0; q < XQ; ++q) l[h][q] = r[h][q] = 0.f;
    sum_terms<TILE, BKC>(l, lring + static_cast<size_t>(slot) * tmax * CHUNK, st.lc, st.n_l,
                         P.left_trans, kk_of, lane);
    sum_terms<TILE, BKC>(r, rring + static_cast<size_t>(slot) * tmax * CHUNK, st.rc, st.n_r,
                         !P.right_jk, kk_of, lane);
    store_sums<TILE, BKC>(l, r, lsum, rsum, kk_of, lane, P.bc - t.c * BKC);
  };

  // This thread's outputs: rows 64 a + 4 ty + i, columns 64 b + 4 tx + j of the sub-tile.
  float part[R][R], prod[R][R];
  zero(part);
  zero(prod);

  const long long ldo = P.out_tri ? P.bj : static_cast<long long>(P.blocks_j) * P.q_j * P.bj;
  // After the last chunk of op o at item g: sign * product into each destination of the op,
  // as walk() writes a SINGLE position.
  auto write_dests = [&](int g, int o) {
    const Item w = item_of<TILE>(P, g);
    const long long so = static_cast<long long>(w.z) * P.slot_elems;
    for (int d = 0; d < P.max_dests; ++d) {
      const int at_d = o * P.max_dests + d;
      const float sg = P.dsgn[at_d];
      if (sg == 0.f) break;  // an op's destinations come first
      const int flags = P.dflag[at_d];
      long long row0, col0;
      if (!dest_origin(P, P.dest[at_d], w.iq, w.jq, w.i0, w.j0, row0, col0)) continue;
      write_straight(P, prod, sg, row0, col0, ldo, w.i0, w.j0, tx, ty,
                     [&](int, long long at, float (&v)[4]) {
                       put4_f32(P, so + at, v, flags);
                     });
    }
  };
  // After a chunk that ends a K block (end 1) the K block's part goes into the op's product,
  // and where it also ends op o of item g (end 2) sign * product into its destinations.
  auto finish_step = [&](int end, int g, int o) {
    if (end == 0) return;
    fold_part(prod, part);
    if (end == 1) return;
    write_dests(g, o);
    zero(prod);
  };

  float* const sums = sum_base;  // [buffer][side][BKC][LDS]
  auto lsum = [&](int b) { return sums + b * 2 * G::BSUM; };
  auto rsum = [&](int b) { return sums + b * 2 * G::BSUM + G::BSUM; };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    queue[0] = blockIdx.x;
  }
  __syncthreads();
  Cursor first{0, 0, 0, 0, 0, false};
  enter(first, 0);

  // The producer: step s, the s-th chunk of the block's walk over its items, goes to ring slot
  // s % STAGES once the consumers have summed step s - STAGES from it.  The terms it leaves
  // with the slot, and the items it queues, reach the consumers through the slot's barrier.
  // It keeps a few registers; the consumers take the rest.
  if (producer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS<TILE>));
    if (threadIdx.x >= 32) return;
    Cursor copy = first;
    for (int s = 0; copy.g < n_items; ++s) {
      mbar_wait(&empty[s % STAGES], ((s / STAGES) & 1) ^ 1);
      start_copies(copy, s % STAGES);
      advance(copy);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS<TILE>));

  // The consumers: iteration s waits for step s, sums it into buffer buf (then releases its
  // slot) and multiplies the chunk summed in the iteration before from buf ^ 1, between one
  // pair of their barriers, as walk() does; warps 0-3 sum first, 4-7 multiply first.  A
  // cursor reads the item queued for its next one where it leaves an item: queued when the
  // copies entered the item it leaves.  What a summed chunk ends: 0 nothing, 1 its K block, 2
  // its K block and its op.
  auto ends = [&](const Cursor& t) { return t.c != n_kc - 1 ? 0 : t.k != P.n_k - 1 ? 1 : 2; };
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  };
  const bool sum_first = warp < 4;
  Cursor summed = first;
  int buf = 0;
  // the chunk summed in the iteration before, in buffer buf ^ 1: what it ends (-1: none), its
  // item and op
  int done_end = -1, done_g = 0, done_o = 0;
  for (int s = 0; summed.g < n_items || done_end >= 0; ++s) {
    const bool live = summed.g < n_items;
    if (live) mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
    consumers_sync();
    if (live && sum_first) {
      sum_phase(summed, s % STAGES, lsum(buf), rsum(buf));
      release(s % STAGES);
    }
    if (done_end >= 0) multiply_chunk<TILE, BKC>(part, lsum(buf ^ 1), rsum(buf ^ 1), tx, ty);
    if (live && !sum_first) {
      sum_phase(summed, s % STAGES, lsum(buf), rsum(buf));
      release(s % STAGES);
    }
    if (done_end >= 0) finish_step(done_end, done_g, done_o);
    done_end = -1;
    if (live) {
      done_end = ends(summed);
      done_g = summed.g;
      done_o = summed.o;
      buf ^= 1;
      advance(summed);
    }
  }
}

// The batched launch's kernel: TILE 64 at two blocks an SM (4 x 4 outputs a thread and their
// product, 32 accumulators), TILE 128 at one.
template <typename Tl, typename Tr, int TILE, int STAGES>
__global__ void __launch_bounds__(BATCHED_THREADS, TILE == 64 ? 2 : 1)
    leaf_products_batched_kernel(const Ops P, const __grid_constant__ CUtensorMap lmap,
                                 const __grid_constant__ CUtensorMap rmap, int n_items,
                                 int* next) {
  walk_items<Tl, Tr, TILE, STAGES>(P, lmap, rmap, n_items, next);
}

// The kernel with an fp32 accumulator.
template <typename Tl, typename Tr, bool TRI, int TILE, int STAGES, bool PAIRS>
__global__ void __launch_bounds__(THREADS)
    leaf_products_kernel(const Ops P, const __grid_constant__ CUtensorMap lmap,
                         const __grid_constant__ CUtensorMap rmap,
                         const __grid_constant__ CUtensorMap mmap,
                         const __grid_constant__ CUtensorMap lmap_half,
                         const __grid_constant__ CUtensorMap rmap_half,
                         const __grid_constant__ CUtensorMap mmap_half) {
  run<Tl, Tr, float, TRI, TILE, STAGES, PAIRS>(P, lmap, rmap, mmap, lmap_half, rmap_half,
                                               mmap_half);
}

// The kernel with a bf16 or fp64 accumulator.  One block an SM is all it asks for, so that
// ptxas gives the per-K-block writes of the tile-64 pair mode the registers they need rather
// than spill to fit two.
template <typename Tl, typename Tr, typename Acc, bool TRI, int TILE, int STAGES, bool PAIRS>
__global__ void __launch_bounds__(THREADS, 1)
    leaf_products_acc_kernel(const Ops P, const __grid_constant__ CUtensorMap lmap,
                             const __grid_constant__ CUtensorMap rmap,
                             const __grid_constant__ CUtensorMap mmap,
                             const __grid_constant__ CUtensorMap lmap_half,
                             const __grid_constant__ CUtensorMap rmap_half,
                             const __grid_constant__ CUtensorMap mmap_half) {
  run<Tl, Tr, Acc, TRI, TILE, STAGES, PAIRS>(P, lmap, rmap, mmap, lmap_half, rmap_half,
                                             mmap_half);
}

using KernelFn = void (*)(const Ops, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap, const CUtensorMap);

// What each library defines over its own instantiations: the kernel of a launch (null for
// arguments it has no instantiation for: another library's or none), and the ring depth that
// runs for a requested one (1-4).
KernelFn select(int l_dtype, int r_dtype, int acc, bool tri, bool pair, int tile, int stages);
int ring_depth(int stages);

// The instantiations of one operand pair and accumulator, for select(): every ring depth, or
// only FIXED where it is not 0 (depth changes no bit).
template <typename Tl, typename Tr, typename Acc, bool TRI, int TILE, int STAGES, bool PAIRS>
KernelFn kernel_of() {
  if constexpr (std::is_same_v<Acc, float>)
    return leaf_products_kernel<Tl, Tr, TRI, TILE, STAGES, PAIRS>;
  else
    return leaf_products_acc_kernel<Tl, Tr, Acc, TRI, TILE, STAGES, PAIRS>;
}

template <typename Tl, typename Tr, typename Acc, bool TRI, int TILE, bool PAIRS, int FIXED>
KernelFn by_stages(int stages) {
  if constexpr (FIXED != 0) {
    return kernel_of<Tl, Tr, Acc, TRI, TILE, FIXED, PAIRS>();
  } else {
    switch (stages) {
      case 1: return kernel_of<Tl, Tr, Acc, TRI, TILE, 1, PAIRS>();
      case 2: return kernel_of<Tl, Tr, Acc, TRI, TILE, 2, PAIRS>();
      case 3: return kernel_of<Tl, Tr, Acc, TRI, TILE, 3, PAIRS>();
      case 4: return kernel_of<Tl, Tr, Acc, TRI, TILE, 4, PAIRS>();
      default: return nullptr;
    }
  }
}

template <typename Tl, typename Tr, typename Acc, bool TRI, bool PAIRS, int FIXED>
KernelFn by_tile(int tile, int stages) {
  if (tile == 64) return by_stages<Tl, Tr, Acc, TRI, 64, PAIRS, FIXED>(stages);
  if (tile == 128) return by_stages<Tl, Tr, Acc, TRI, 128, PAIRS, FIXED>(stages);
  return nullptr;
}

// Pair mode is instantiated only where it can run: a gram kind's one operand, a dense right
// side.
template <typename Tl, typename Tr, typename Acc, int FIXED = 0>
KernelFn by_layout(bool tri, bool pair, int tile, int stages) {
  if (!pair)
    return tri ? by_tile<Tl, Tr, Acc, true, false, FIXED>(tile, stages)
               : by_tile<Tl, Tr, Acc, false, false, FIXED>(tile, stages);
  if constexpr (std::is_same_v<Tl, Tr>)
    if (!tri) return by_tile<Tl, Tr, Acc, false, true, FIXED>(tile, stages);
  return nullptr;
}

// The batched launch's kernel (leaf_products_batched_kernel) for operand tiles of type `dtype`
// on both sides, or null where the library has no such instantiation; each library defines it.
using BatchedFn = void (*)(const Ops, const CUtensorMap, const CUtensorMap, int, int*);
BatchedFn select_batched(int dtype, int tile, int stages);

template <typename T, int TILE>
BatchedFn batched_by_stages(int stages) {
  switch (stages) {
    case 1: return leaf_products_batched_kernel<T, T, TILE, 1>;
    case 2: return leaf_products_batched_kernel<T, T, TILE, 2>;
    case 3: return leaf_products_batched_kernel<T, T, TILE, 3>;
    case 4: return leaf_products_batched_kernel<T, T, TILE, 4>;
    default: return nullptr;
  }
}

template <typename T>
BatchedFn batched_of(int tile, int stages) {
  if (tile == 64) return batched_by_stages<T, 64>(stages);
  if (tile == 128) return batched_by_stages<T, 128>(stages);
  return nullptr;
}

// The kernel for a launch, its dynamic shared memory raised to what it needs.
template <typename Fn>
cudaError_t prepare(Fn kernel, size_t smem) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The map of a stack of `batch` row-major (rows, cols) operands of element type `code`, one
// after the other, with row stride ld (elements), read in boxes of box_rows x box_cols of one
// operand; reads past an operand's edge give zeros.  The stack is the map's third, outermost
// dimension, so that a box that runs past one operand's last row reads zeros and not the next
// operand's first rows (a 2-D map over the rows of the whole stack would).  Both fp8 types
// travel as bytes.
bool make_map(CUtensorMap* map, const void* base, int code, long long rows, long long cols,
              long long ld, int batch, int box_rows, int box_cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type = code == F32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : code == BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : code == F16  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t pitch = static_cast<cuuint64_t>(ld) * elem_bytes(code);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {pitch, pitch * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
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

// The operand types a launch takes, the seed's and the output's, and the accumulator's type as
// a Dtype.
bool operand_code(int code) { return code >= F32 && code <= E5M2; }
bool value_code(int code) { return code == F32 || code == BF16 || code == F16 || code == F64; }
int acc_dtype(int acc) { return acc == ACC_BF16 ? BF16 : acc == ACC_F64 ? F64 : F32; }

}  // namespace

extern "C" {

// The ring depth this library runs for a requested one (1-4): the request itself, or one depth
// for every request where depth changes no bit and one instantiation serves.
int leaf_products_ring_depth(int stages) { return ring_depth(stages); }

// Dynamic shared memory one launch needs (the wrapper refuses > 227 KB).  right_tri: the
// right side is a packed tri stack; left_bytes / right_bytes: operand element sizes; pair:
// the launch runs in pair mode; acc (AccCode) and n_run: the accumulator, and the slots of an
// op whose running values a bf16 or fp64 one keeps on chip (0 for an fp32 one).
size_t leaf_products_smem_bytes(int right_tri, int tmax, int tile, int left_bytes,
                                int right_bytes, int stages, int pair, int acc, int n_run) {
  return smem_bytes(right_tri != 0, tmax, tile, left_bytes, right_bytes, ring_depth(stages),
                    pair != 0, acc, n_run);
}

// Thread blocks of one launch an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1 for arguments no kernel of this library takes.  pair: the launch runs in pair mode.
int leaf_products_blocks_per_sm(int l_dtype, int r_dtype, int acc, int right_tri, int tmax,
                                int tile, int stages, int pair, int n_run) {
  if (!operand_code(l_dtype) || !operand_code(r_dtype)) return -1;
  const KernelFn kernel = select(l_dtype, r_dtype, acc, right_tri != 0, pair != 0, tile, stages);
  const size_t smem = smem_bytes(right_tri != 0, tmax, tile, elem_bytes(l_dtype),
                                 elem_bytes(r_dtype), ring_depth(stages), pair != 0, acc, n_run);
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// The positions a launch of n_pos positions walks whole (whole_positions); the other n_pos
// minus that many are walked in quarters, four blocks each.
long long leaf_products_whole_positions(int l_dtype, int r_dtype, int acc, int right_tri,
                                        int tmax, int tile, int stages, int n_run,
                                        long long n_pos) {
  if (!operand_code(l_dtype) || !operand_code(r_dtype)) return -1;
  const size_t smem = smem_bytes(right_tri != 0, tmax, tile, elem_bytes(l_dtype),
                                 elem_bytes(r_dtype), ring_depth(stages), false, acc, n_run);
  return whole_positions(select(l_dtype, r_dtype, acc, right_tri != 0, false, tile, stages),
                         smem, tile, n_pos);
}

const char* leaf_products_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One bound program of a kind this library runs.  `left` / `right` are the padded operands,
// (l_rows, l_cols) and (r_rows, r_cols), contiguous (a stored row may be wider than the
// operand: zero columns the wrapper adds so that an fp8 row stride is a multiple of 16 bytes),
// `out` the dense (blocks_i*q_i*bi, blocks_j*q_j*bj) grid or, with out_tri, the packed
// (n_out*bi, bj) stack, and `ws` its accumulator's workspace, of the accumulator's type (out
// itself where the output is of that type).  `seed`, with out_tri only, is the incoming packed
// stack of rank_k or null; it may be out.  The tables are _op_tables' twelve arrays.
// left_trans: left tiles stored K x i.  right_layout: 0 K x j, 1 j x K, 2 packed tri stack of
// (bj, bj) tiles (then bc == bj).  pair: the tables have a transposed destination (a packed
// output, a dense right side).  dtype codes (Dtype): operands fp32, bf16, fp16, fp8 e4m3fn or
// e5m2; the seed and the output fp32, bf16, fp16 or fp64.  acc (AccCode): fp32, bf16,
// fp64.
// l_pitch / r_pitch: an fp8 dense side's stored columns per tile along its rows (the tile's
// width, bi or bc on the left and bj or bc on the right, rounded up to 16, zeros past it), so
// that every box starts on 16 bytes; read for fp8 sides only.
// tile: 64 or 128, a block's sub-tile edge.  stages: the requested ring depth
// (leaf_products_ring_depth says which runs).  n_run: with a bf16 or fp64 accumulator, the
// slots of each op whose running values stay in shared memory over its K blocks, 0 to
// max_dests (strassen_fused.run_dests; 0 for an fp32 accumulator).  The operands' row strides
// and bases are 16-byte aligned, their extents below 2^31.  A batched launch is
// leaf_products_batched_launch.
int leaf_products_launch(const void* left, const void* right, const void* seed, void* ws,
                         void* out, const void* lrow, const void* lcol, const void* lsgn,
                         const void* rrow, const void* rcol, const void* rsgn, const void* rtrn,
                         const void* dest, const void* dsgn, const void* dflag,
                         const void* dtrn, const void* odiag, long long l_rows, long long l_cols,
                         long long r_rows, long long r_cols, int n_ops, int tmax, int max_dests,
                         int n_k, int q_i, int q_j, int blocks_j, int bi, int bj, int bc,
                         int left_trans, int right_layout, int diag_sym, int out_tri, int pair,
                         int l_dtype, int r_dtype, int seed_dtype, int out_dtype, int acc,
                         int l_pitch, int r_pitch, int tile, int stages, int n_run,
                         void* stream) {
  if (n_ops < 1 || tmax < 1 || tmax > MAX_TERMS || max_dests < 1 || n_k < 1 || q_i < 1 ||
      n_run < 0 || n_run > max_dests || (acc == ACC_F32 && n_run != 0) ||
      q_j < 1 || blocks_j < 1 || bi < 8 || bj < 8 || bc < 8 || right_layout < RIGHT_KJ ||
      right_layout > RIGHT_TRI || (right_layout == RIGHT_TRI && (bc != bj || rtrn == nullptr)) ||
      !operand_code(l_dtype) || !operand_code(r_dtype) || !value_code(out_dtype) ||
      (ws == out && out_dtype != acc_dtype(acc)) || odiag == nullptr || dtrn == nullptr ||
      // a packed output: square tiles, a dense right side; a seed, or pair mode, only there
      (out_tri && (right_layout == RIGHT_TRI || q_i != q_j || bi != bj)) || (pair && !out_tri) ||
      (seed != nullptr && (!out_tri || !value_code(seed_dtype))) ||
      (elem_bytes(l_dtype) == 1 && (l_pitch % 16 || l_pitch < (left_trans ? bi : bc))) ||
      (elem_bytes(r_dtype) == 1 && right_layout != RIGHT_TRI &&
       (r_pitch % 16 || r_pitch < (right_layout == RIGHT_JK ? bc : bj))) ||
      l_rows >= (1LL << 31) || l_cols >= (1LL << 31) || r_rows >= (1LL << 31) ||
      r_cols >= (1LL << 31))
    return cudaErrorInvalidValue;
  const bool tri = right_layout == RIGHT_TRI;
  const KernelFn kernel = select(l_dtype, r_dtype, acc, tri, pair != 0, tile, stages);
  const size_t smem = smem_bytes(tri, tmax, tile, elem_bytes(l_dtype), elem_bytes(r_dtype),
                                 ring_depth(stages), pair != 0, acc, n_run);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // Boxes as each side lies: KC deep along K, TILE wide along i or j; the half maps read the
  // quarters' TILE / 2 wide boxes.
  CUtensorMap maps[2][3];
  const bool r_kx = right_layout != RIGHT_JK;  // K x j rows, or the stored read of a stack
  for (int half = 0; half < 2; ++half) {
    const int w = tile >> half;
    CUtensorMap* m = maps[half];
    if (!make_map(&m[0], left, l_dtype, l_rows, l_cols, l_cols, 1, left_trans ? KC : w,
                  left_trans ? w : KC) ||
        !make_map(&m[1], right, r_dtype, r_rows, r_cols, r_cols, 1, r_kx ? KC : w,
                  r_kx ? w : KC) ||
        (tri && !make_map(&m[2], right, r_dtype, r_rows, r_cols, r_cols, 1, w, KC)))
      return cudaErrorInvalidValue;
    if (!tri) m[2] = m[1];  // unread
  }
  Ops P{ws, out, seed,
        static_cast<const int*>(lrow), static_cast<const int*>(lcol),
        static_cast<const float*>(lsgn), static_cast<const int*>(rrow),
        static_cast<const int*>(rcol), static_cast<const float*>(rsgn),
        static_cast<const int*>(rtrn), static_cast<const int*>(dest),
        static_cast<const float*>(dsgn), static_cast<const int*>(dflag),
        static_cast<const int*>(dtrn), static_cast<const int*>(odiag),
        n_ops, tmax, max_dests, n_k, q_i, q_j, blocks_j, bi, bj, bc,
        left_trans, right_layout == RIGHT_JK, diag_sym, out_tri != 0, slot_terms(tmax, pair),
        seed_dtype, ws != out, 0, out_dtype, l_pitch, r_pitch, 1, 0, n_run};
  const long long n_pos = static_cast<long long>(q_i) * q_j * ((bi + tile - 1) / tile) *
                          ((bj + tile - 1) / tile);
  // pair mode: one block a mirror pair of sub-tiles and one a sub-tile on the diagonal
  const long long side = static_cast<long long>(q_i) * ((bi + tile - 1) / tile);
  const long long n_big =
      pair ? side * (side + 1) / 2 : whole_positions(kernel, smem, tile, n_pos);
  const long long blocks = pair ? n_big : n_big + 4 * (n_pos - n_big);
  if (n_big < 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  P.n_big = static_cast<int>(n_big);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      P, maps[0][0], maps[0][1], maps[0][2], maps[1][0], maps[1][1], maps[1][2]);
  return cudaGetLastError();
}

// Dynamic shared memory of one batched launch (leaf_products_batched_kernel).
size_t leaf_products_batched_smem_bytes(int dtype, int tmax, int tile, int stages) {
  return batched_smem_bytes(tmax, tile, elem_bytes(dtype), ring_depth(stages));
}

// Thread blocks of the batched launch (leaf_products_batched_kernel) an SM holds at once, or -1
// for arguments no kernel of this library takes.
int leaf_products_batched_blocks_per_sm(int dtype, int tmax, int tile, int stages) {
  if (!operand_code(dtype) || tmax < 1 || tmax > MAX_TERMS) return -1;
  const BatchedFn kernel = select_batched(dtype, tile, stages);
  const size_t smem = batched_smem_bytes(tmax, tile, elem_bytes(dtype), ring_depth(stages));
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BATCHED_THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// One batched launch of a gram kind that reads one operand as a dense right side (ata: left
// K x i, right K x j; aat: left i x K, right j x K) with an fp32 accumulator: `batch` slots,
// each running the bound program on its own operand, a persistent grid of `grid` blocks over
// the first `items` (slot, position) pairs at `tile`, those that write something
// (strassen_fused.batched_plan).  `next` is an int on the device, 0 before the launch and
// after it, the counter the blocks take items from: one for each stream.  The other arguments are
// leaf_products_launch's for such a program: the same operands (one type, `dtype`), tables
// and geometry, no seed; ws, out and each operand hold `batch` of their kind one after the
// other, out_slot elements apart for the first two.
int leaf_products_batched_launch(const void* left, const void* right, void* ws, void* out,
                                 const void* lrow, const void* lcol, const void* lsgn,
                                 const void* rrow, const void* rcol, const void* rsgn,
                                 const void* rtrn, const void* dest, const void* dsgn,
                                 const void* dflag, const void* dtrn, const void* odiag,
                                 long long l_rows, long long l_cols, long long r_rows,
                                 long long r_cols, int n_ops, int tmax, int max_dests, int n_k,
                                 int q_i, int q_j, int blocks_j, int bi, int bj, int bc,
                                 int left_trans, int right_jk, int out_tri, int dtype,
                                 int out_dtype, int l_pitch, int r_pitch, int tile, int stages,
                                 int batch, long long out_slot, long long items, int grid,
                                 void* next, void* stream) {
  const long long n_items = static_cast<long long>(q_i) * q_j * ((bi + tile - 1) / tile) *
                            ((bj + tile - 1) / tile) * batch;
  if (n_ops < 1 || tmax < 1 || tmax > MAX_TERMS || max_dests < 1 || n_k < 1 || q_i < 1 ||
      q_j < 1 || blocks_j < 1 || bi < 8 || bj < 8 || bc < 8 || (tile != 64 && tile != 128) ||
      !operand_code(dtype) || !value_code(out_dtype) || (ws == out && out_dtype != F32) ||
      odiag == nullptr || (out_tri && (q_i != q_j || bi != bj)) ||
      (elem_bytes(dtype) == 1 && (l_pitch % 16 || l_pitch < (left_trans ? bi : bc) ||
                                  r_pitch % 16 || r_pitch < (right_jk ? bc : bj))) ||
      l_rows >= (1LL << 31) || l_cols >= (1LL << 31) || r_rows >= (1LL << 31) ||
      r_cols >= (1LL << 31) || batch < 1 || out_slot < 1 || items > n_items || items < 1 ||
      n_items >= (1LL << 31) || grid < 1 || grid > items || next == nullptr)
    return cudaErrorInvalidValue;
  const BatchedFn kernel = select_batched(dtype, tile, stages);
  const size_t smem = batched_smem_bytes(tmax, tile, elem_bytes(dtype), ring_depth(stages));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // Boxes as each side lies: batched_kc(tile) deep along K, TILE wide along i or j.  Both sides
  // of ata (and of aat) are one tensor read in one box shape: one map serves both.
  CUtensorMap lmap, rmap;
  const int depth = batched_kc(tile);
  const int l_box_rows = left_trans ? depth : tile, l_box_cols = left_trans ? tile : depth;
  const int r_box_rows = right_jk ? tile : depth, r_box_cols = right_jk ? depth : tile;
  if (!make_map(&lmap, left, dtype, l_rows, l_cols, l_cols, batch, l_box_rows, l_box_cols))
    return cudaErrorInvalidValue;
  if (left == right && l_rows == r_rows && l_cols == r_cols && l_box_rows == r_box_rows &&
      l_box_cols == r_box_cols)
    rmap = lmap;
  else if (!make_map(&rmap, right, dtype, r_rows, r_cols, r_cols, batch, r_box_rows,
                     r_box_cols))
    return cudaErrorInvalidValue;
  const Ops P{ws, out, nullptr,
              static_cast<const int*>(lrow), static_cast<const int*>(lcol),
              static_cast<const float*>(lsgn), static_cast<const int*>(rrow),
              static_cast<const int*>(rcol), static_cast<const float*>(rsgn),
              static_cast<const int*>(rtrn), static_cast<const int*>(dest),
              static_cast<const float*>(dsgn), static_cast<const int*>(dflag),
              static_cast<const int*>(dtrn), static_cast<const int*>(odiag),
              n_ops, tmax, max_dests, n_k, q_i, q_j, blocks_j, bi, bj, bc,
              left_trans, right_jk, 0, out_tri != 0, tmax, F32, ws != out, 0, out_dtype,
              l_pitch, r_pitch, batch, out_slot, 0};
  kernel<<<static_cast<unsigned>(grid), BATCHED_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      P, lmap, rmap, static_cast<int>(items), static_cast<int*>(next));
  return cudaGetLastError();
}

}  // extern "C"
