// Hopper warpgroup MMA (wgmma) with s8 operands and s32 accumulators, for
// qmm_i8p.cu: the m64nNk32 products (N = 128, 64) and the operand fence of
// int accumulators. Descriptors, fences, commit and wait are those of
// wgmma_bf16.cuh; needs sm_90a.
//
// Operand layouts: for 8-bit types both A and B must be K-major (an integer
// wgmma has no transpose bit). With the 128-byte swizzle a row of 128 int8
// of K is 128 bytes, stored as wgmma_bf16.cuh's K-major A: row r at 128 r,
// its eight 16-byte chunks at chunk c ^ (r % 8), 8-row atoms of 1024 bytes
// at 1024-aligned addresses. One k32 slice starts 32 kk bytes into the
// rows; SBO = 1024 (the next 8 rows), LBO unused. A is 64 rows (m) of a
// warpgroup, B N rows (n) of the weights [Ns, K]: the same descriptor.
//
// Accumulator fragment of m64nNk32 (s32), as wgmma_bf16.cuh's f32 one: warp
// w of the warpgroup holds rows 16 w .. 16 w + 15; with g = lane / 4, q =
// lane % 4, register 4 j + 2 h + e is row 16 w + g + 8 h, column 8 j + 2 q + e.
#pragma once

#include "wgmma_bf16.cuh"

namespace wgmma {

// Keeps the compiler from moving accesses of int accumulators across the
// asynchronous wgmma (an empty asm that "rewrites" each register).
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 32] @ B[32 x 128], s8 in, s32 out; both operands
// K-major. scale_d 0 starts d from the product (no prior zeroing).
__device__ __forceinline__ void m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d[64 x 64] (+)= A[64 x 32] @ B[32 x 64], s8 in, s32 out; both operands
// K-major. scale_d 0 starts d from the product (no prior zeroing).
__device__ __forceinline__ void m64n64k32(int (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

}  // namespace wgmma
