// combine.cu — Strassen's recombination of the PyTorch port in one pass.
//
// Replaces the TPU kernel src/repro/kernels/combine.py:17 _combine_kernel (launched by
// strassen_combine :25, pallas_call :43).  It computes what that kernel computes, from the
// seven products of one Strassen level, elementwise:
//   c11 = ((m1 + m4) - m5) + m7,  c12 = m3 + m5,  c21 = m2 + m4,  c22 = ((m1 - m2) + m3) + m6,
// each add rounded to the element type in that order (t1 = m1 + m4 first), so that it is
// bit-equal to the same expression written in torch.
//
// What bounds it: bytes.  Seven reads and four writes of every element against ten adds: at
// 5120^2 fp32 (one Strassen level at n = 10240) 1.15 GB at 3.35 TB/s, 0.34 ms, on an H100 SXM
// at 700 W.  The design reads each input and writes each output once, in 16-byte vectors
// (4 fp32, or 8 bf16 or fp16, a thread and iteration), in a grid-stride loop over the flat
// arrays; the tile blocks of the TPU kernel shape nothing here, except that padded to multiples
// of 8 the arrays hold whole vectors.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 resident blocks a Hopper SM, enough to fill it

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ __nv_bfloat16 sub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fsub_rn(__bfloat162float(a), __bfloat162float(b)));
}
// fp16 (and bf16): fp32 carries at least 2 x 11 + 2 significand bits, so a sum rounded to fp32
// and then to fp16 is the correctly rounded fp16 sum (double rounding is innocuous there), which
// is what torch computes for each operation on fp16 tensors.
__device__ __forceinline__ __half add(__half a, __half b) {
  return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
}
__device__ __forceinline__ __half sub(__half a, __half b) {
  return __float2half_rn(__fsub_rn(__half2float(a), __half2float(b)));
}

template <typename T>
struct Args {
  const T* m[7];
  T* c[4];
};

template <typename T>
__device__ __forceinline__ void combine_one(const T (&m)[7], T (&c)[4]) {
  const T t1 = add(m[0], m[3]);
  c[0] = add(sub(t1, m[4]), m[6]);
  c[1] = add(m[2], m[4]);
  c[2] = add(m[1], m[3]);
  c[3] = add(add(sub(m[0], m[1]), m[2]), m[5]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) combine_kernel(const Args<T> args, long long n_vec) {
  constexpr int V = 16 / sizeof(T);  // elements of one 16-byte vector
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    uint4 in[7], out[4];
#pragma unroll
    for (int p = 0; p < 7; ++p) in[p] = reinterpret_cast<const uint4*>(args.m[p])[v];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      T m[7], c[4];
#pragma unroll
      for (int p = 0; p < 7; ++p) m[p] = reinterpret_cast<const T*>(&in[p])[e];
      combine_one(m, c);
#pragma unroll
      for (int q = 0; q < 4; ++q) reinterpret_cast<T*>(&out[q])[e] = c[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) reinterpret_cast<uint4*>(args.c[q])[v] = out[q];
  }
}

template <typename T>
cudaError_t launch(const void* const* m, void* const* c, long long numel, cudaStream_t stream) {
  Args<T> args;
  for (int p = 0; p < 7; ++p) args.m[p] = static_cast<const T*>(m[p]);
  for (int q = 0; q < 4; ++q) args.c[q] = static_cast<T*>(c[q]);
  const long long n_vec = numel / (16 / sizeof(T));
  long long blocks = (n_vec + THREADS - 1) / THREADS;
  blocks = blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks;
  combine_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args, n_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (c11, c12, c21, c22) from m1..m7, all `numel` elements of one type, 16-byte aligned;
// numel a multiple of 8 (whole 16-byte vectors).  dtype codes: 0 fp32, 1 bf16, 2 fp16.
int combine_launch(const void* m1, const void* m2, const void* m3, const void* m4,
                   const void* m5, const void* m6, const void* m7, void* c11, void* c12,
                   void* c21, void* c22, long long numel, int dtype, void* stream) {
  if (numel < 1 || numel % 8) return cudaErrorInvalidValue;
  const void* m[7] = {m1, m2, m3, m4, m5, m6, m7};
  void* c[4] = {c11, c12, c21, c22};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(m, c, numel, s);
  if (dtype == 1) return launch<__nv_bfloat16>(m, c, numel, s);
  if (dtype == 2) return launch<__half>(m, c, numel, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
