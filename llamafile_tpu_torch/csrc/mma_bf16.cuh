// Tensor-core building blocks shared by the bf16 mma.sync kernels
// (flash_prefill.cu, flash_decode_write.cu) and the s8 one (qmm_txn.cuh,
// through mma_s8.cuh), and the cp.async and pack helpers of the wgmma bodies
// qmm_gemm.cuh and qmm_i8p.cu: cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 bf16 product with f32
// accumulation.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major): a[0] = (g, 2q..2q+1), a[1] = (g+8, 2q..),
//                           a[2] = (g, 2q+8..),   a[3] = (g+8, 2q+8..)
//   B (16 x 8, k x n):      b[0] = (k 2q..2q+1, n g), b[1] = (k 2q+8.., n g)
//   C (16 x 8, f32):        c[0..1] = (g, 2q..2q+1), c[2..3] = (g+8, 2q..)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of the committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane t gives the address of row t % 8 of matrix t / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (B operands stored k-major).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a @ b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mma
