// The q4b product for 1 <= M <= 32 rows, shared by qmm_txn.cu (one weight)
// and qmm_txn_g.cu (row tiles of M rows, each on its own expert).
//
// Per row, the math is qmm_txn_m1's: exact int32 group dots of int8
// activations (natural K-group order) against the 4-bit codes, times the
// bf16 group scale and the activation scale, plus the fused bias on the
// bf16-rounded activation group sums.
//
// Design: each 32-row weight chunk of a 128-column tile is read into shared
// memory once and reused for every row: warp w serves rows w, w+8, w+16,
// w+24. The activation codes of 32 rows x K = 14336 do not fit shared
// memory, so they are streamed chunk by chunk with the weights (64 bytes a
// row a chunk). K is split over S blocks with the fixed-order combine of
// qmm_common.cuh. __dp4a after a 4x4 byte transpose does the int8 math; a
// later version would move to s8 mma.sync and a cp.async pipeline.
#pragma once

#include "qmm_common.cuh"

namespace qmm {

constexpr int MAXM = 32;
constexpr int RPW = MAXM / WARPS;   // rows per warp

struct TxnOff {
  int Ns, n_base;
  __device__ long long operator()(int i) const {
    const int m = i / TN, c = n_base + i % TN;
    return c < Ns ? (long long)m * Ns + c : -1;
  }
};

__global__ void __launch_bounds__(THREADS)
qmm_txn_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
               const __nv_bfloat16* __restrict__ bias, float* __restrict__ y,
               float* partial, int* counters, int M, int K, int Ns, int S,
               const int* __restrict__ te) {
  __shared__ __align__(16) uint8_t wq[CHUNK_ROWS][TN];
  __shared__ __align__(16) int8_t xs[MAXM][64];           // lo 32 | hi 32
  __shared__ __align__(16) __nv_bfloat16 scs[2][TN];
  __shared__ __align__(16) __nv_bfloat16 bss[2][TN];
  __shared__ float sxs[MAXM][2];
  __shared__ float vals[MAXM * TN];
  {  // row tile z of a grouped launch: its rows and expert te[z]
    const int z = blockIdx.z;
    const int e = te ? __ldg(te + z) : 0;
    const size_t wsc = (size_t)e * (K / 32) * Ns;
    x += (size_t)z * M * K;
    sx += (size_t)z * M * (K / 32);
    qs += (size_t)e * (K / 2) * Ns;
    sc += wsc;
    if (bias != nullptr) bias += wsc;
    y += (size_t)z * M * Ns;
    partial += (size_t)z * S * M * Ns;
    counters += (size_t)z * gridDim.x;
  }
  const int tile = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_base = tile * TN;
  const int KG = K / 32;
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);
  float acc[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[i][cc] = 0.f;

  for (int c = cb; c < ce; ++c) {
    const int sb = c >> 2, j = c & 3;
    const int g_lo = 8 * sb + j, g_hi = g_lo + 4;
    {  // weights: 32 rows x 128 bytes, 16 bytes a thread
      const int r = t >> 3, seg = t & 7, col = n_base + 16 * seg;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (col < Ns)
        v = __ldg(reinterpret_cast<const uint4*>(
            qs + (size_t)(128 * sb + 32 * j + r) * Ns + col));
      *reinterpret_cast<uint4*>(&wq[r][16 * seg]) = v;
    }
    if (t < 4 * M) {  // activations: 32 lo + 32 hi bytes a row
      const int m = t >> 2, part = t & 3;
      const int k = 256 * sb + (part < 2 ? 0 : 128) + 32 * j + 16 * (part & 1);
      *reinterpret_cast<int4*>(&xs[m][16 * part]) =
          __ldg(reinterpret_cast<const int4*>(x + (size_t)m * K + k));
    } else if (t >= 128 && t < 160) {  // group scales (and bias) of the chunk
      const int which = (t - 128) >> 4, seg = t & 15, col = n_base + 8 * seg;
      const int g = which ? g_hi : g_lo;
      uint4 vs = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (col < Ns) {
        vs = __ldg(reinterpret_cast<const uint4*>(sc + (size_t)g * Ns + col));
        if (bias != nullptr)
          vb = __ldg(reinterpret_cast<const uint4*>(bias + (size_t)g * Ns + col));
      }
      *reinterpret_cast<uint4*>(&scs[which][8 * seg]) = vs;
      *reinterpret_cast<uint4*>(&bss[which][8 * seg]) = vb;
    } else if (t >= 192 && t < 192 + 2 * M) {
      const int i = t - 192, m = i >> 1, which = i & 1;
      sxs[m][which] = __ldg(sx + (size_t)m * KG + (which ? g_hi : g_lo));
    }
    __syncthreads();

    uint32_t cw[CHUNK_ROWS];      // column words: cw[4*tt + cc] = rows 4tt..4tt+3
    {
      uint32_t w[4];
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(&wq[4 * tt + r][4 * lane]);
        transpose4x4(w, &cw[4 * tt]);
      }
    }
    float scl[4], sch[4], bl4[4], bh4[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      scl[cc] = __bfloat162float(scs[0][4 * lane + cc]);
      sch[cc] = __bfloat162float(scs[1][4 * lane + cc]);
      bl4[cc] = __bfloat162float(bss[0][4 * lane + cc]);
      bh4[cc] = __bfloat162float(bss[1][4 * lane + cc]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int m = warp + WARPS * i;
      if (m < M) {
        const int* xw = reinterpret_cast<const int*>(xs[m]);
        int dlo[4] = {0, 0, 0, 0}, dhi[4] = {0, 0, 0, 0};
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          const int xl = xw[tt], xh = xw[8 + tt];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            dlo[cc] = __dp4a(lo_plane(cw[4 * tt + cc]), xl, dlo[cc]);
            dhi[cc] = __dp4a(hi_plane(cw[4 * tt + cc]), xh, dhi[cc]);
          }
        }
        const float sxl = sxs[m][0], sxh = sxs[m][1];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          acc[i][cc] += ((float)dlo[cc] * scl[cc]) * sxl;
          acc[i][cc] += ((float)dhi[cc] * sch[cc]) * sxh;
        }
        if (bias != nullptr) {
          int slo = 0, shi = 0;
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            slo = __dp4a(xw[tt], 0x01010101, slo);
            shi = __dp4a(xw[8 + tt], 0x01010101, shi);
          }
          const float bl = bf16_round((float)slo * sxl);
          const float bh = bf16_round((float)shi * sxh);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[i][cc] += bl * bl4[cc] + bh * bh4[cc];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int m = warp + WARPS * i;
    if (m < M)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) vals[m * TN + 4 * lane + cc] = acc[i][cc];
  }
  if (!splitk_combine(vals, M * TN, partial, (size_t)M * Ns, TxnOff{Ns, n_base},
                      counters + tile, S, s))
    return;
  for (int i = t; i < M * TN; i += THREADS) {
    const int m = i / TN, col = n_base + i % TN;
    if (col < Ns) y[(size_t)m * Ns + col] = vals[i];
  }
}

}  // namespace qmm
