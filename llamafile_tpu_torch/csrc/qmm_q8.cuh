// The M=1 GEMV on int8-stored weights (q8b: Q8_0 with g = 32, Q6_K with
// g = 16), shared by qmm_q8_m1.cu (one weight) and qmm_routed.cu (one
// expert of an expert stack per slot).
//
// Per group and column, the TPU kernels' math (_qmm_kernel_q8_m1 and its
// routed form _qmm_kernel_q8_m1_r, llamafile_tpu/ops/qmatmul.py:684, :948):
//   y += (float(sum_k xq[k] * w[k]) * scale) * sx      (int32 group dot)
//   y += bf16(float(sum_k xq[k]) * sx) * bias           (optional fused bias)
// with xq, sx from quantize_activations_g32; for g = 16 one per-32 sx covers
// two weight groups. Only the order of the f32 sums differs.
//
// Design (that of qmm_txn_m1, qmm_common.cuh): a lane owns 4 adjacent
// columns and a warp reads whole 128-byte rows, 32 rows in flight a lane;
// __dp4a on a 4x4 byte transpose does the group dots; K is split over 8
// warps and S blocks, the partials summed in a fixed order by the last block
// of each column tile (integer counter, no float atomics).
#pragma once

#include "qmm_common.cuh"

namespace qmm {

// One 32-row chunk c (K rows 32c .. 32c+31: one per-32 activation group,
// G = 32 / g weight groups) for the 4 columns [n0, n0+4) of one lane.
template <int G>
__device__ __forceinline__ void q8_chunk(const int8_t* __restrict__ x,
                                         const float* __restrict__ sx,
                                         const int8_t* __restrict__ qs,
                                         const __nv_bfloat16* __restrict__ sc,
                                         const __nv_bfloat16* __restrict__ bias, int Ns,
                                         int c, int n0, float* acc) {
  constexpr int NG = 32 / G;         // weight groups in the chunk
  constexpr int WPG = G / 4;         // 4-row words a group
  const int8_t* q = qs + (size_t)(32 * c) * Ns + n0;
  uint32_t w[CHUNK_ROWS];
#pragma unroll
  for (int r = 0; r < CHUNK_ROWS; ++r)
    w[r] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)r * Ns));
  const int4* xp = reinterpret_cast<const int4*>(x + 32 * c);
  const int4 x0 = __ldg(xp), x1 = __ldg(xp + 1);
  const int xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const float s = __ldg(sx + c);
#pragma unroll
  for (int h = 0; h < NG; ++h) {
    int d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < WPG; ++t) {
      uint32_t col[4];
      transpose4x4(&w[4 * (WPG * h + t)], col);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) d[cc] = __dp4a((int)col[cc], xv[WPG * h + t], d[cc]);
    }
    const int grp = NG * c + h;
    float scv[4];
    load_bf16x4(sc + (size_t)grp * Ns + n0, scv);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[cc] += ((float)d[cc] * scv[cc]) * s;
    if (bias != nullptr) {
      int xs = 0;
#pragma unroll
      for (int t = 0; t < WPG; ++t) xs = __dp4a(xv[WPG * h + t], 0x01010101, xs);
      const float bs = bf16_round((float)xs * s);
      float bb[4];
      load_bf16x4(bias + (size_t)grp * Ns + n0, bb);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[cc] += bs * bb[cc];
    }
  }
}

// Grid (tiles, S, slots): block (tile, s, z) covers columns [128 tile,
// 128 tile + 128) and chunk split s of S for slot z, which multiplies
// activation row ti[z] by expert ei[z] of the stacked codes [E, K, Ns] (one
// slot with ei and ti null: the plain GEMV). y [slots, Ns]; partial
// [slots, S, Ns] f32 and counters [slots, tiles] int32 are scratch
// (counters zero on entry and left zero).
template <int G>
__global__ void __launch_bounds__(THREADS)
q8_m1_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
             const int8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
             const __nv_bfloat16* __restrict__ bias, float* __restrict__ y,
             float* partial, int* counters, int K, int Ns, int S,
             const int* __restrict__ ei, const int* __restrict__ ti) {
  __shared__ float red[WARPS][TN];
  __shared__ float vals[TN];
  const Slot sl(ei, ti);
  const size_t wsc = (size_t)sl.e * (K / G) * Ns;
  x += (size_t)sl.row * K;
  sx += (size_t)sl.row * (K / 32);
  qs += (size_t)sl.e * K * Ns;
  sc += wsc;
  if (bias != nullptr) bias += wsc;
  y += (size_t)sl.z * Ns;
  partial += (size_t)sl.z * S * Ns;
  counters += (size_t)sl.z * gridDim.x;
  const int tile = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_base = tile * TN;
  const int n0 = n_base + 4 * lane;
  int cb, ce;
  split_range(K / 32, S, s, &cb, &ce);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n0 < Ns)
    for (int c = cb + warp; c < ce; c += WARPS) q8_chunk<G>(x, sx, qs, sc, bias, Ns, c, n0, acc);
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) red[warp][4 * lane + cc] = acc[cc];
  reduce_warps(red, vals);
  if (!splitk_combine(vals, TN, partial, (size_t)Ns, M1Off{n_base, Ns}, counters + tile, S, s))
    return;
  for (int i = threadIdx.x; i < TN; i += blockDim.x)
    if (n_base + i < Ns) y[n_base + i] = vals[i];
}

// Launch on `slots` slots (ei/ti null for the plain GEMV). K % 32 == 0,
// Ns % 4 == 0, g 16 or 32.
inline int launch_q8_m1(const void* x, const void* sx, const void* qs, const void* sc,
                        const void* bias, void* y, void* partial, void* counters, int K,
                        int Ns, int g, int S, int slots, const void* ei, const void* ti,
                        cudaStream_t st) {
  if (K % 32 || Ns % 4 || S < 1 || slots < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((Ns + TN - 1) / TN, S, slots);
  const int8_t* xp = (const int8_t*)x;
  const int8_t* q = (const int8_t*)qs;
  const __nv_bfloat16* s = (const __nv_bfloat16*)sc;
  const __nv_bfloat16* b = (const __nv_bfloat16*)bias;
  if (g == 32)
    q8_m1_kernel<32><<<grid, THREADS, 0, st>>>(xp, (const float*)sx, q, s, b, (float*)y,
                                               (float*)partial, (int*)counters, K, Ns, S,
                                               (const int*)ei, (const int*)ti);
  else if (g == 16)
    q8_m1_kernel<16><<<grid, THREADS, 0, st>>>(xp, (const float*)sx, q, s, b, (float*)y,
                                               (float*)partial, (int*)counters, K, Ns, S,
                                               (const int*)ei, (const int*)ti);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace qmm
