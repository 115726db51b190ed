// Tensor-core building blocks of the s8 mma.sync body (qmm_txn.cuh): the
// m16n8k32 int8 product with int32 accumulation. cp.async and ldmatrix come
// from mma_bf16.cuh: ldmatrix moves 16-byte rows whatever their element type, so
// an 8x8 b16 matrix is 8 rows of 16 int8 and each lane receives 4
// consecutive bytes of one row, which is the s8 fragment layout when both
// operands are stored K-contiguous.
//
// Fragment layouts of mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (g = lane / 4,
// q = lane % 4; a register holds 4 int8, lowest k in the low byte):
//   A (16 x 32, row-major): a[0] = (g, 4q..4q+3),    a[1] = (g+8, 4q..),
//                           a[2] = (g, 16+4q..),     a[3] = (g+8, 16+4q..)
//   B (32 x 8, k x n):      b[0] = (k 4q..4q+3, n g), b[1] = (k 16+4q.., n g)
//   C (16 x 8, s32):        c[0..1] = (g, 2q..2q+1),  c[2..3] = (g+8, 2q..)
#pragma once

#include "mma_bf16.cuh"

namespace mma {

// c += a @ b, s8 operands, s32 accumulators.
__device__ __forceinline__ void mma_16832_s8(int* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
