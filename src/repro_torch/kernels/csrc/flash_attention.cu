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
//   online softmax over kv tiles: m, l and the (64, D) accumulator in fp32,
//   p = exp(s - m_new) summed into l in fp32 and cast to v's type before P V;
//   out = acc / max(l, 1e-30) in q's type.
//
// The mask value is the TPU kernel's finite -1e30, not -inf.  A row whose first worked kv
// tile is wholly masked (under a sliding window: the tile skip below tests only the q tile's
// first row) takes p = exp(0) = 1 there; its first real score then wipes that through
// corr = exp(-1e30 - m) = 0.  With -inf the same row would give inf - inf = NaN.
//
// What bounds it on an H100 SXM (data-sheet peaks at the 700 W limit): at the serving
// prefill (1 x 16 heads x 2048 queries over a 2048-slot cache, 2 kv heads, D 128, bf16,
// causal) the unmasked (q, k) pairs need 4 D flops each, 17.2 GFLOP, which take 0.017 ms on
// the bf16 tensor cores at 989 TFLOP/s; q, k, v and o once are 18.9 MB, 0.0056 ms at
// 3.35 TB/s.  So it is bound by operations.
//
// The design is the simple one: one block of 256 threads per (b * h, tile of 64 query
// rows); a loop over kv tiles of 64 inside the block, in place of the TPU's sequential kv
// grid axis; Q, K and V staged in shared memory as fp32 (dynamic, up to 212 KB at D 256);
// S = Q K^T and P V by fp32 FMA on the CUDA cores in the kernel's own body, each thread a
// 4 x 4 tile of S and 4 rows x D/16 columns of the accumulator; four threads per row for the
// softmax.  Causal tiles past the q tile's last row, and tiles wholly below the window of its
// first row, are skipped.  What it leaves on the table: the tensor cores (wgmma or mma.sync
// on bf16 fragments, the whole gap to the bound), TMA and a double-buffered kv ring (loads
// are not overlapped with compute), warp specialisation, and occupancy (one block per SM at
// D 128, as Q, K and V sit in fp32).
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv columns per tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr int F32 = 0, BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p rounded to v's type, as the TPU kernel casts p before P V.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Copy `rows` valid rows of a (rows_total, D) row-major tile, starting at `src`, into shared
// memory as fp32 with row stride `stride`; rows past `rows` are zero.  16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src, int rows) {
  constexpr int VEC = 16 / sizeof(T);           // 4 fp32 or 8 bf16
  constexpr int CHUNKS = BQ * D / VEC;
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int e = c * VEC, r = e / D, col = e % D;
    float vals[VEC];
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * D + col);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = to_f32(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
    float* out = dst + r * stride + col;
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(out + i) = make_float4(vals[i], vals[i + 1], vals[i + 2],
                                                        vals[i + 3]);
  }
}

template <int D>
constexpr int smem_floats() {
  return 2 * BQ * (D + 4) + BK * D + BQ * (BK + 4) + BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(const T* q, const T* k, const T* v,
                                                        T* out, int heads, int kv_heads,
                                                        int sq, int skv, float scale,
                                                        float softcap, int causal,
                                                        int window) {
  constexpr int DS = D + 4;                     // padded row stride of Q and K
  constexpr int SS = BK + 4;                    // padded row stride of S
  constexpr int NC = D / 16;                    // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * DS;
  float* vs = ks + BK * DS;
  float* ss = vs + BK * D;
  float* corr_s = ss + BQ * SS;                 // per row: the rescale, then l

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int hkv = h / (heads / kv_heads);
  const int q0 = blockIdx.x * BQ;
  const long long q_off = (static_cast<long long>(b) * heads + h) * sq * D;
  const long long kv_off = (static_cast<long long>(b) * kv_heads + hkv) * skv * D;

  load_tile<T, D>(qs, DS, q + q_off + static_cast<long long>(q0) * D, min(BQ, sq - q0));

  // the softmax's row and its quarter of the columns
  const int srow = tid >> 2, spart = tid & 3;
  float m_run = NEG_INF, l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BQ, sq) - 1;
  int n_tiles = (skv + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q_last / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // below the window of the q tile's first row: no row of the tile needs it
    if (window > 0 && q0 - (k0 + BK - 1) >= window) continue;
    __syncthreads();                            // the last tile's K, V and P are spent
    const int kv_rows = min(BK, skv - k0);
    load_tile<T, D>(ks, DS, k + kv_off + static_cast<long long>(k0) * D, kv_rows);
    load_tile<T, D>(vs, D, v + kv_off + static_cast<long long>(k0) * D, kv_rows);
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * DS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // scale after the dot, softcap before the mask, as the TPU kernel
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = c < kv_rows;
        if (causal) valid = valid && qp >= kp;
        if (window > 0) valid = valid && (qp - kp) < window;
        ss[r * SS + c] = valid ? x : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, columns spart + 4 u
    {
      float* row = ss + srow * SS;
      float m_cur = NEG_INF;
#pragma unroll
      for (int u = 0; u < BK / 4; ++u) m_cur = fmaxf(m_cur, row[spart + 4 * u]);
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
      const float m_new = fmaxf(m_run, m_cur);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 4; ++u) {
        const float p = expf(row[spart + 4 * u] - m_new);
        sum += p;
        row[spart + 4 * u] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (spart == 0) corr_s[srow] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();                              // corr_s is read above
  if (spart == 0) corr_s[srow] = fmaxf(l_run, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = corr_s[r];
    T* o = out + q_off + static_cast<long long>(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch,
                   int heads, int kv_heads, int sq, int skv, float scale, float softcap,
                   int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  // above 48 KB only after this attribute; set on every launch, so every card has it
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), heads, kv_heads, sq, skv, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int d, const void* q, const void* k, const void* v, void* out, int batch,
                   int heads, int kv_heads, int sq, int skv, float scale, float softcap,
                   int causal, int window, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                           causal, window, s);
    case 32:
      return launch<T, 32>(q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                           causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                           causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                            causal, window, s);
    case 256:
      return launch<T, 256>(q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                            causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory a launch at head_dim d takes, in bytes (0 for an unsupported d).
int flash_attention_smem_bytes(int d) {
  switch (d) {
    case 16: return smem_floats<16>() * 4;
    case 32: return smem_floats<32>() * 4;
    case 64: return smem_floats<64>() * 4;
    case 128: return smem_floats<128>() * 4;
    case 256: return smem_floats<256>() * 4;
    default: return 0;
  }
}

// out (B, H, Sq, D) = attention of q (B, H, Sq, D) over k, v (B, Hkv, Skv, D), all contiguous,
// 16-byte aligned and of one dtype (0 fp32, 1 bf16).  d in {16, 32, 64, 128, 256};
// heads % kv_heads == 0; window 0 means none, softcap 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int batch,
                           int heads, int kv_heads, int sq, int skv, int d, float scale,
                           float softcap, int causal, int window, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || sq < 1 || skv < 1 ||
      window < 0 || static_cast<long long>(batch) * heads > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return by_dim<float>(d, q, k, v, out, batch, heads, kv_heads, sq, skv, scale, softcap,
                         causal, window, s);
  if (dtype == BF16)
    return by_dim<__nv_bfloat16>(d, q, k, v, out, batch, heads, kv_heads, sq, skv, scale,
                                 softcap, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
