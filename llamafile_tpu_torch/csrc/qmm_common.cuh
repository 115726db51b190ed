// Shared device code of the q4b and q8b matmul kernels (qmm_m1.cuh,
// qmm_txn.cuh, qmm_q8.cuh and their entries).
//
// Weight layout (ops/repack.py, byte-identical to the JAX package's repack):
//   qs     uint8 [K/2, Ns]: packed row 128*sb + i holds k = 256*sb + i in the
//          lo nibble and k = 256*sb + 128 + i in the hi nibble
//   scales bf16  [K/32, Ns] natural group order; hi-plane groups pre-divided
//          by 16 and their bias rows carry +8a, so the hi nibble is read as
//          int8((p ^ 0x80) & 0xF0) = 16q - 128 with nothing unfolded here
//   bias   bf16  [K/32, Ns] (formats with mins; may be absent)
//
// A "chunk" is 32 packed rows of one superblock: rows 128*sb + 32*j + r,
// r < 32. Its lo nibbles form group g_lo = 8*sb + j, its hi nibbles group
// g_hi = 8*sb + 4 + j. Per group and column the math is the TPU kernels'
// (ops/qmatmul.py _qmm_kernel_txn_m1 / _qmm_kernel_txn):
//   y += (float(sum_k xq[k] * w[k]) * scale) * sx
//   y += bf16(float(sum_k xq[k]) * sx) * bias          (fused bias)
// The int32 group dot is exact; only the order of the f32 sums differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TN = 128;            // columns per block: 32 lanes x 4 columns
constexpr int CHUNK_ROWS = 32;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4x4 byte transpose: in[r] holds columns 0..3 of row r; out[c] holds rows
// 0..3 of column c (byte r = row r), ready for __dp4a along K.
__device__ __forceinline__ void transpose4x4(const uint32_t* in, uint32_t* out) {
  uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Four signed 8-bit codes of the lo plane (0..15) and of the hi plane
// (16q - 128) from a column word of four packed rows.
__device__ __forceinline__ int lo_plane(uint32_t p) { return (int)(p & 0x0F0F0F0Fu); }
__device__ __forceinline__ int hi_plane(uint32_t p) {
  return (int)((p ^ 0x80808080u) & 0xF0F0F0F0u);
}

__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float* out) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}

// Chunk range of split s of S over C chunks.
__device__ __forceinline__ void split_range(int C, int S, int s, int* cb, int* ce) {
  *cb = (int)(((long long)C * s) / S);
  *ce = (int)(((long long)C * (s + 1)) / S);
}

// Split-K combine with a fixed order and no float atomics: every block
// stores its partial values, and the last block of a column tile (found with
// an integer counter) sums the S partials in split order. Returns true in
// the block that holds the final values (written back into vals[0..n)).
// partial: [S, stride] f32; off(i) is the offset of vals[i] inside one
// split's slice, or -1 for a column past the edge. counter: one int per
// tile, zero on entry and left zero on exit. vals lives in shared memory;
// every thread of the block calls this.
template <typename Off>
__device__ __forceinline__ bool splitk_combine(float* vals, int n, float* partial,
                                               size_t stride, Off off,
                                               int* counter, int S, int s) {
  __shared__ int is_last;
  __syncthreads();
  if (S == 1) return true;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long o = off(i);
    if (o >= 0) partial[(size_t)s * stride + o] = vals[i];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = (atomicAdd(counter, 1) == S - 1);
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long o = off(i);
    if (o < 0) continue;
    float v = 0.f;
    for (int t = 0; t < S; ++t) v += __ldcg(partial + (size_t)t * stride + o);
    vals[i] = v;
  }
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();
  return true;
}

// Sum of the WARPS per-warp partials red[w][i] in warp order into vals[i].
__device__ __forceinline__ void reduce_warps(const float (*red)[TN], float* vals) {
  __syncthreads();
  for (int i = threadIdx.x; i < TN; i += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][i];
    vals[i] = v;
  }
}

struct M1Off {
  int n_base, Ns;
  __device__ long long operator()(int i) const {
    return n_base + i < Ns ? n_base + i : -1;
  }
};

// Slot z of a routed launch (blockIdx.z): its expert e = ei[z] (0 when ei
// is null) and its activation row ti[z] (z when ti is null), read by each
// block from device memory, as the TPU kernels took them by scalar prefetch.
struct Slot {
  int z, e, row;
  __device__ Slot(const int* ei, const int* ti)
      : z(blockIdx.z), e(ei ? __ldg(ei + blockIdx.z) : 0),
        row(ti ? __ldg(ti + blockIdx.z) : (int)blockIdx.z) {}
};

}  // namespace qmm
