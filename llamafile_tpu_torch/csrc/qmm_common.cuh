// Shared device code of the q4b matmul kernels (qmm_txn_m1.cu, qmm_txn.cu,
// qmm_moe_m1.cu).
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

// One chunk of the M=1 product for the 4 columns [n0, n0+4) of one lane:
// reads 32 packed rows straight from device memory (a warp reads 128
// contiguous bytes per row) and adds the chunk's two groups into acc[4].
// x: int8 codes [K], sx: f32 scales [K/32]; bias may be null.
__device__ __forceinline__ void m1_chunk(
    const int8_t* __restrict__ x, const float* __restrict__ sx,
    const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
    const __nv_bfloat16* __restrict__ bias, int Ns, int c, int n0,
    float* acc) {
  const int sb = c >> 2, j = c & 3;
  const int g_lo = 8 * sb + j, g_hi = g_lo + 4;
  const uint8_t* q = qs + (size_t)(128 * sb + 32 * j) * Ns + n0;
  uint32_t w[CHUNK_ROWS];
#pragma unroll
  for (int r = 0; r < CHUNK_ROWS; ++r)
    w[r] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)r * Ns));
  const int4* xl = reinterpret_cast<const int4*>(x + 256 * sb + 32 * j);
  const int4* xh = reinterpret_cast<const int4*>(x + 256 * sb + 128 + 32 * j);
  int4 l0 = __ldg(xl), l1 = __ldg(xl + 1), h0 = __ldg(xh), h1 = __ldg(xh + 1);
  const int xlo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
  const int xhi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  int dlo[4] = {0, 0, 0, 0}, dhi[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    uint32_t col[4];
    transpose4x4(&w[4 * t], col);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      dlo[cc] = __dp4a(lo_plane(col[cc]), xlo[t], dlo[cc]);
      dhi[cc] = __dp4a(hi_plane(col[cc]), xhi[t], dhi[cc]);
    }
  }
  const float sxl = __ldg(sx + g_lo), sxh = __ldg(sx + g_hi);
  float scl[4], sch[4];
  load_bf16x4(sc + (size_t)g_lo * Ns + n0, scl);
  load_bf16x4(sc + (size_t)g_hi * Ns + n0, sch);
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    acc[cc] += ((float)dlo[cc] * scl[cc]) * sxl;
    acc[cc] += ((float)dhi[cc] * sch[cc]) * sxh;
  }
  if (bias != nullptr) {
    int slo = 0, shi = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      slo = __dp4a(xlo[t], 0x01010101, slo);
      shi = __dp4a(xhi[t], 0x01010101, shi);
    }
    const float bl = bf16_round((float)slo * sxl);
    const float bh = bf16_round((float)shi * sxh);
    float bbl[4], bbh[4];
    load_bf16x4(bias + (size_t)g_lo * Ns + n0, bbl);
    load_bf16x4(bias + (size_t)g_hi * Ns + n0, bbh);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[cc] += bl * bbl[cc] + bh * bbh[cc];
  }
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

// The M=1 product of one block: warp w runs chunks cb+w, cb+w+WARPS, ...
// of [cb, ce) for the 4 columns at col0(lane), and the per-warp partials are
// summed in warp order into vals[TN] (shared). Columns past the edge
// (col0 < 0) contribute zeros.
__device__ __forceinline__ void m1_block(
    const int8_t* x, const float* sx, const uint8_t* qs,
    const __nv_bfloat16* sc, const __nv_bfloat16* bias, int Ns, int cb,
    int ce, int n0, float (*red)[TN], float* vals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n0 >= 0)
    for (int c = cb + warp; c < ce; c += WARPS)
      m1_chunk(x, sx, qs, sc, bias, Ns, c, n0, acc);
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) red[warp][4 * lane + cc] = acc[cc];
  reduce_warps(red, vals);
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

// M=1 q4b GEMV: y[Ns] = x @ W (see the header comment). Grid (tiles, S,
// slots): block (tile, s, z) covers columns [128*tile, 128*tile + 128) and
// chunk split s of S for slot z, which multiplies activation row ti[z] by
// expert ei[z] of the expert-stacked weights [E, K/2, Ns] (one slot with ei
// and ti null: the plain GEMV). y [slots, Ns]; partial [slots, S, Ns] f32
// and counters [slots, tiles] int32 are scratch.
__global__ void __launch_bounds__(THREADS)
m1_gemv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
               const __nv_bfloat16* __restrict__ bias, float* __restrict__ y,
               float* partial, int* counters, int K, int Ns, int S,
               const int* __restrict__ ei, const int* __restrict__ ti) {
  __shared__ float red[WARPS][TN];
  __shared__ float vals[TN];
  const Slot sl(ei, ti);
  const size_t wsc = (size_t)sl.e * (K / 32) * Ns;
  x += (size_t)sl.row * K;
  sx += (size_t)sl.row * (K / 32);
  qs += (size_t)sl.e * (K / 2) * Ns;
  sc += wsc;
  if (bias != nullptr) bias += wsc;
  y += (size_t)sl.z * Ns;
  partial += (size_t)sl.z * S * Ns;
  counters += (size_t)sl.z * gridDim.x;
  const int tile = blockIdx.x, s = blockIdx.y;
  const int n_base = tile * TN;
  const int n0 = n_base + 4 * (threadIdx.x & 31);
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);
  m1_block(x, sx, qs, sc, bias, Ns, cb, ce, n0 < Ns ? n0 : -1, red, vals);
  if (!splitk_combine(vals, TN, partial, (size_t)Ns, M1Off{n_base, Ns},
                      counters + tile, S, s))
    return;
  for (int i = threadIdx.x; i < TN; i += blockDim.x)
    if (n_base + i < Ns) y[n_base + i] = vals[i];
}

}  // namespace qmm
