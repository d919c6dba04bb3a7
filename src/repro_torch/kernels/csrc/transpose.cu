// transpose.cu — the tiled matrix transpose of the PyTorch port.
//
// Replaces the TPU kernel src/repro/kernels/transpose.py:17 _transpose_kernel (launched by
// transpose_padded :21, pallas_call :32): out (n, m) = a (m, n)^t, output block (i, j) the
// transpose of input block (j, i).  A copy: every element is moved bit for bit, so one
// instantiation per element size (2 and 4 bytes) serves every type of that size (bf16, fp16,
// fp32, int32, ...).
//
// What bounds it: bytes, one read and one write of every element: 2 x 10240^2 x 4 B at
// 3.35 TB/s, 0.25 ms, on an H100 SXM at 700 W.  The design is the classic one: a 32 x 32 tile
// per block of 32 x 8 threads, read row by row (neighbouring threads on neighbouring
// addresses), turned through shared memory padded by one element a row (the column reads hit
// 32 banks), and written row by row of the output.
//
// Interface: plain C, loaded with ctypes.  The launcher returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TDIM = 32;   // tile edge
constexpr int ROWS = 8;    // thread rows: each thread moves TDIM / ROWS elements

template <typename T>
__global__ void __launch_bounds__(TDIM * ROWS) transpose_kernel(const T* a, T* out,
                                                                long long m, long long n) {
  __shared__ T tile[TDIM][TDIM + 1];
  const long long r0 = static_cast<long long>(blockIdx.y) * TDIM;  // input rows
  const long long c0 = static_cast<long long>(blockIdx.x) * TDIM;  // input columns
  for (int r = threadIdx.y; r < TDIM; r += ROWS) {
    const long long row = r0 + r, col = c0 + threadIdx.x;
    if (row < m && col < n) tile[r][threadIdx.x] = a[row * n + col];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TDIM; r += ROWS) {
    const long long row = c0 + r, col = r0 + threadIdx.x;  // output (n, m)
    if (row < n && col < m) out[row * m + col] = tile[threadIdx.x][r];
  }
}

template <typename T>
cudaError_t launch(const void* a, void* out, long long m, long long n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + TDIM - 1) / TDIM),
                  static_cast<unsigned>((m + TDIM - 1) / TDIM));
  transpose_kernel<T><<<grid, dim3(TDIM, ROWS), 0, stream>>>(static_cast<const T*>(a),
                                                             static_cast<T*>(out), m, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* transpose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (n, m) = a (m, n)^t, both row-major, elements of elem_bytes (2 or 4) bytes.
int transpose_launch(const void* a, void* out, long long m, long long n, int elem_bytes,
                     void* stream) {
  if (m < 1 || n < 1 || (m + TDIM - 1) / TDIM > 65535 || (n + TDIM - 1) / TDIM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<uint16_t>(a, out, m, n, s);
  if (elem_bytes == 4) return launch<uint32_t>(a, out, m, n, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
