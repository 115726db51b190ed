// Hopper warpgroup MMA (wgmma) building blocks for bf16 operands in shared
// memory with f32 accumulators: shared-memory matrix descriptors for the
// 128-byte swizzle, the fences, commit and wait, and the m64n64k16 and
// m64n128k16 products with A in shared memory (ss_) or in registers (rs_).
// Used by qmm_gemm.cuh and flash_prefill.cu; needs sm_90a.
//
// Operand layouts (the 128-byte swizzle, "SW128"): a row of 64 bf16 is 128
// bytes, and its eight 16-byte chunks are stored at chunk c ^ (row % 8);
// an 8-row atom is 1024 bytes and must start 1024-aligned, since the
// hardware takes row % 8 from address bits 7-9.
//   A, K-major (64 rows x 64 k per warpgroup): row m at 128 m. One k16
//     slice starts 32 kk bytes into the rows; SBO = 1024 (the next 8 rows),
//     LBO unused.
//   B, MN-major (64 k x 128 n, read with the transpose bit): k row r of the
//     n-half h (64 columns) at 8192 h + 128 r. One k16 slice starts 2048 kk
//     bytes in; SBO = 1024 (the next 8 k rows), LBO = 8192 (the next 64
//     columns).
//   B, K-major (n rows x 64 k, no transpose bit): as A, row n at 128 n, a k16
//     slice 32 kk bytes in, SBO = 1024.
//   A from registers (rs_): the m16n8k16 A fragment (mma_bf16.cuh) of warp
//     w of the warpgroup, rows 16 w .. 16 w + 15; an f32 accumulator's
//     columns 16 kk .. 16 kk + 15, packed to bf16 pairs, are that fragment
//     of k16 slice kk.
//
// Accumulator fragment of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16 w .. 16 w + 15; with g = lane / 4, q = lane % 4, register 4 j + 2 h + e
// is row 16 w + g + 8 h, column 8 j + 2 q + e.
//
// wgmma reads shared memory through the async proxy: data written there by
// ordinary stores or by cp.async must be made visible to it by
// fence_proxy_async() in the writing threads before the barrier that
// precedes the wgmma (wgmma::fence() alone does not order those writes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

// Descriptor of a 128-byte-swizzled operand at shared address `saddr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// Orders this warpgroup's register and shared-memory accesses before the
// wgmmas that follow.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (an empty asm that "rewrites" each register).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A operands of in-flight wgmmas: fenced after the
// wait, they stay live (and unmoved) until the wgmmas that read them end.
template <int M, int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] @ B[16 x 64] from shared memory, A K-major; B
// K-major (TB = 0) or MN-major (TB = 1); scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB)
      : "memory");
}

// d[64 x 128] (+)= A[64 x 16] @ B[16 x 128] from shared memory, A K-major; B
// K-major (TB = 0) or MN-major (TB = 1); scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB)
      : "memory");
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64]: A from registers (a: the m16n8k16
// A fragment of warp w's rows 16 w .. 16 w + 15), B MN-major in shared memory.
__device__ __forceinline__ void rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128]: A from registers (a: the m16n8k16
// A fragment of warp w's rows 16 w .. 16 w + 15), B MN-major in shared memory.
__device__ __forceinline__ void rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128]; A K-major, B MN-major (bf16).
__device__ __forceinline__ void m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  ss_m64n128k16<1>(d, da, db, 1);
}

}  // namespace wgmma
