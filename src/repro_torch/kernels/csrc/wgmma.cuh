// wgmma.cuh — the warpgroup matrix products shared by the port's tensor-core kernels
// (csrc/flash_attention.cu, csrc/tile_product_tc.cuh behind csrc/syrk.cu and csrc/matmul.cu).
//
// Every operand tile in shared memory lies in slabs of 64 16-bit elements along its contiguous
// axis, 128 bytes a row, under the 128-byte swizzle that the TMA box and the descriptor both name;
// slabs are 1024-byte aligned, so the swizzle phase of a row is its index mod 8.  An operand is
// K-major (K contiguous: the rows of one slab are M or N) or MN-major (M or N contiguous: the rows
// of one slab are K, read with the transpose bit; 16-bit types only).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace wgmma {

// A wgmma matrix descriptor of a tile in shared memory under the 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units) and the layout type (1, 128B).
// K-major: the 8-row groups lie 1024 bytes apart (stride), and the leading offset is unused.
// MN-major: 64-element slabs lie lbo bytes apart along M or N, 8-row groups along K 1024 bytes
// apart.
__device__ __forceinline__ uint64_t descriptor(unsigned addr, unsigned lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin an accumulator's registers at this point, so the compiler moves no read or write of
// them across the asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of an m64nNk16 wgmma: d[0 .. N / 2 - 1], N / 2 fp32 registers.
#define WGMMA_ACC8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_ACC32 WGMMA_ACC8(0), WGMMA_ACC8(8), WGMMA_ACC8(16), WGMMA_ACC8(24)
#define WGMMA_ACC64 WGMMA_ACC32, WGMMA_ACC8(32), WGMMA_ACC8(40), WGMMA_ACC8(48), WGMMA_ACC8(56)
#define WGMMA_ACC128                                                                    \
  WGMMA_ACC64, WGMMA_ACC8(64), WGMMA_ACC8(72), WGMMA_ACC8(80), WGMMA_ACC8(88), WGMMA_ACC8(96), \
      WGMMA_ACC8(104), WGMMA_ACC8(112), WGMMA_ACC8(120)
// The A fragment of an RS wgmma: 4 registers of a, each two 16-bit elements.
#define WGMMA_A_FRAG "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])

// The PTX of the wgmma forms, for operands of type AB ("bf16" or "f16"): SS reads A and B
// from shared memory, each K-major or, with its transpose immediate (the last two operands)
// set, MN-major; RS reads A from 4 registers and B from shared memory (N-major, the transpose
// bit set).  The first operand past the accumulators is the predicate that scales D (0: D =
// A B).
#define WGMMA_SS_N64(AB) \
  "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
#define WGMMA_SS_N128(AB) \
  "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
#define WGMMA_RS_N64(AB) \
  "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
#define WGMMA_RS_N128(AB) \
  "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define WGMMA_RS_N256(AB) \
  "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127" \
  "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"

// The tensor cores' operand type: bf16, or fp16 (the same wgmma forms, .f16).
template <typename T>
constexpr bool IS_F16 = std::is_same<T, __half>::value;

// D (64 x 64) += A B, A (64 x 16) and B (16 x 64) in shared memory; TA, TB: each operand
// MN-major (1) or K-major (0).
template <typename T, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  if constexpr (IS_F16<T>)
    asm volatile(WGMMA_SS_N64("f16")
                 : WGMMA_ACC32
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else
    asm volatile(WGMMA_SS_N64("bf16")
                 : WGMMA_ACC32
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128) += A B, A (64 x 16) and B (16 x 128) in shared memory; TA, TB as above.
template <typename T, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (IS_F16<T>)
    asm volatile(WGMMA_SS_N128("f16")
                 : WGMMA_ACC64
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else
    asm volatile(WGMMA_SS_N128("bf16")
                 : WGMMA_ACC64
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64) += A B, A (64 x 16) in registers, B (16 x 64) in shared memory N-major.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  if constexpr (IS_F16<T>)
    asm volatile(WGMMA_RS_N64("f16") : WGMMA_ACC32 : WGMMA_A_FRAG, "l"(db), "r"(scale_d));
  else
    asm volatile(WGMMA_RS_N64("bf16") : WGMMA_ACC32 : WGMMA_A_FRAG, "l"(db), "r"(scale_d));
}

// D (64 x 128) += A B, A (64 x 16) in registers, B (16 x 128) in shared memory N-major.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  if constexpr (IS_F16<T>)
    asm volatile(WGMMA_RS_N128("f16") : WGMMA_ACC64 : WGMMA_A_FRAG, "l"(db), "r"(scale_d));
  else
    asm volatile(WGMMA_RS_N128("bf16") : WGMMA_ACC64 : WGMMA_A_FRAG, "l"(db), "r"(scale_d));
}

// D (64 x 256) += A B, A (64 x 16) in registers, B (16 x 256) in shared memory N-major.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  if constexpr (IS_F16<T>)
    asm volatile(WGMMA_RS_N256("f16") : WGMMA_ACC128 : WGMMA_A_FRAG, "l"(db), "r"(scale_d));
  else
    asm volatile(WGMMA_RS_N256("bf16") : WGMMA_ACC128 : WGMMA_A_FRAG, "l"(db), "r"(scale_d));
}

template <typename T, int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64<T, TA, TB>(d, da, db, scale_d);
  else wgmma_ss_n128<T, TA, TB>(d, da, db, scale_d);
}
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64<T>(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128<T>(d, a, db, 1);
  else wgmma_rs_n256<T>(d, a, db, 1);
}

}  // namespace wgmma
