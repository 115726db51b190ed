// A design variant of llamafile_tpu_torch/csrc/flash_decode_write.cu, kept
// only for the timings of scripts/probe_fdw.py (PERF.md): the kernel's
// tensor-core tiles with the sketch's block-wide ring and rank-0 merge. It
// computes the same function with the same numerics (q and p rounded to
// bf16, f32 scores and l, the new token merged last, out / max(l, 1e-30));
// the port never calls it.
//
// Each (batch row, kv head) is one thread-block cluster of `cs` blocks of
// 4 warps (the C entry takes cs, 1..16; 16 is non-portable):
// - rank r takes the rows [r * n_vis / cs, (r + 1) * n_vis / cs), n_vis =
//   min(pos, s_eff); a rank with no rows leaves m = -1e30, l = 0;
// - it streams its rows in tiles of TR = 64 through a block-wide ring of
//   NS = 3 stages in shared memory (two tiles ahead), cp.async 16 bytes a
//   lane, with a block barrier a stage;
// - warp w takes rows 16w..16w+15 of each tile on the tensor cores as the
//   kernel does ("swap AB" mma.sync.m16n8k16: S^T = K Q^T, one max and one
//   rescale a warp tile and head, O^T += V^T P^T with bf16 p moved into the
//   B fragment by movmatrix.trans);
// - the warps' partials merge in warp order into the rank's (m, l,
//   acc[G][D]) in its shared memory; after a cluster barrier rank 0 reads
//   ranks 0..cs-1 in rank order through distributed shared memory, merges
//   the new token last, writes out and the new K/V row, and a second
//   barrier keeps every rank's shared memory alive until rank 0 is done.
#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma;

constexpr int D = 128;
constexpr int DP = D + 8;            // padded row stride: conflict-free ldmatrix
constexpr int NW = 4;                // warps a block
constexpr int NT = NW * 32;
constexpr int RW = 16;               // rows a warp takes of each tile
constexpr int TR = NW * RW;          // rows a tile
constexpr int NS = 3;                // stages of the ring
constexpr int STAGE = 2 * TR * DP;   // bf16 elements of a stage: K rows, then V rows
constexpr int HN = 8;                // query heads a group, padded: the mma's n
constexpr int MAX_CS = 16;
constexpr float NEG = -1e30f;

// An 8x8 b16 matrix in the mma fragment layout, transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// first row of rank r of cs over n rows (testing.fdw_rank_ranges is the same rule)
__device__ __forceinline__ int rank_lo(int r, int n, int cs) {
  return (int)((long long)r * n / cs);
}

// rows j0 .. j0 + nr - 1 of this rank's K and V slices into one stage; the
// stage's rows nr .. TR - 1 are zero-filled, so P.V over them adds 0
__device__ __forceinline__ void load_tile(__nv_bfloat16* stage, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int j0, int nr, int HD) {
  constexpr int CH = D / 8;          // 16-byte chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < 2 * TR * CH; c += NT) {
    const int kv = c / (TR * CH), row = c / CH % TR, col = c % CH;
    const bool ok = row < nr;
    cp_async16(stage + (kv * TR + row) * DP + col * 8,
               (kv ? vb : kb) + (size_t)(j0 + (ok ? row : 0)) * HD + col * 8, ok);
  }
}

template <int G>
constexpr int smem_bytes() {
  // ring (after the loop: the warps' acc [NW][HN][D]) | acc [G][D] |
  // warps' m, l, weights [NW][HN] | kn, vn [D] | m, l, sn, L, pn [G] |
  // ranks' m (then weights), l [MAX_CS][G]
  return NS * STAGE * 2 + (G * D + 3 * NW * HN + 2 * D + 5 * G + 2 * MAX_CS * G) * 4;
}

template <int G>
__global__ void __launch_bounds__(NT)
fdw_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ k3,
           __nv_bfloat16* __restrict__ v3, const float* __restrict__ kn,
           const float* __restrict__ vn, const int* __restrict__ pos,
           float* __restrict__ out, int li, int B, int S, int Hkv, int s_eff,
           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* part_acc = reinterpret_cast<float*>(ring + NS * STAGE);   // [G][D]
  float* wm = part_acc + G * D;        // [NW][HN] each warp's m
  float* wl = wm + NW * HN;            // [NW][HN] each warp's l
  float* wf = wl + NW * HN;            // [NW][HN] each warp's weight
  float* kn_t = wf + NW * HN;          // rank 0: the new token's f32 k, v
  float* vn_t = kn_t + D;
  float* part_m = vn_t + D;
  float* part_l = part_m + G;
  float* sn_t = part_l + G;            // rank 0: the new token's scores
  float* L_t = sn_t + G;               // rank 0: merged l
  float* pn_t = L_t + G;               // rank 0: the new token's weight
  float* m_r = pn_t + G;               // rank 0: [MAX_CS][G] ranks' m, then weights
  float* l_r = m_r + MAX_CS * G;       // rank 0: [MAX_CS][G] ranks' l

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, qd = lane & 3;
  const int HD = Hkv * D, Hq = Hkv * G;
  const int p = pos[b];
  const int n_vis = max(0, min(p, s_eff));
  const int lo = rank_lo(rank, n_vis, cs);
  const int n = rank_lo(rank + 1, n_vis, cs) - lo;
  const int n_tiles = (n + TR - 1) / TR;
  const size_t row0 = ((size_t)li * B + b) * S;
  const __nv_bfloat16* kb = k3 + (row0 + lo) * HD + h * D;
  const __nv_bfloat16* vb = v3 + (row0 + lo) * HD + h * D;

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {   // the first NS - 1 tiles in flight at once
    if (t < n_tiles) load_tile(ring + t * STAGE, kb, vb, t * TR, min(TR, n - t * TR), HD);
    cp_async_commit();
  }
  if (rank == 0 && tid < D) {
    kn_t[tid] = kn[(size_t)b * HD + h * D + tid];
    vn_t[tid] = vn[(size_t)b * HD + h * D + tid];
  }

  // q as the B operand (k = dim, n = head): head gq, dims 16kk + 2qd (+8),
  // rounded to bf16; heads G..7 are zero
  uint32_t qb[D / 16][2];
  const float* qr = q + ((size_t)b * Hq + h * G + gq) * D + 2 * qd;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = gq < G ? pack_bf16x2(qr[16 * kk], qr[16 * kk + 1]) : 0u;
    qb[kk][1] = gq < G ? pack_bf16x2(qr[16 * kk + 8], qr[16 * kk + 9]) : 0u;
  }
  if (rank == 0 && warp == 0) {        // the new token's scores, from its f32 k
    const float* kr = kn + (size_t)b * HD + h * D + 2 * qd;
    float sc = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sc += bf16_lo(qb[kk][0]) * kr[16 * kk] + bf16_hi(qb[kk][0]) * kr[16 * kk + 1] +
            bf16_lo(qb[kk][1]) * kr[16 * kk + 8] + bf16_hi(qb[kk][1]) * kr[16 * kk + 9];
    sc += __shfl_xor_sync(0xffffffffu, sc, 1);
    sc += __shfl_xor_sync(0xffffffffu, sc, 2);
    if (qd == 0 && gq < G) sn_t[gq] = sc * scale;
  }

  // this warp's online softmax of heads 2qd, 2qd + 1, and O^T: acc[mt] holds
  // dims 16mt + gq (+8) of those two heads
  float m2[2] = {NEG, NEG}, l2[2] = {0.f, 0.f};
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();           // tile t has landed
    __syncthreads();                   // and every warp is done with tile t - 1
    const int nt = t + NS - 1;
    if (nt < n_tiles)
      load_tile(ring + (nt % NS) * STAGE, kb, vb, nt * TR, min(TR, n - nt * TR), HD);
    cp_async_commit();
    const int nrw = min(TR, n - t * TR) - RW * warp;     // this warp's rows of the tile
    if (nrw <= 0) continue;
    const __nv_bfloat16* ks = ring + (t % NS) * STAGE + RW * warp * DP;
    const __nv_bfloat16* vs = ks + TR * DP;

    float c[4] = {0.f, 0.f, 0.f, 0.f};   // S^T: rows gq (+8), heads 2qd (+1)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ks + (lane & 15) * DP + 16 * kk + 8 * (lane >> 4));
      mma_16816(c, a, qb[kk][0], qb[kk][1]);
    }
    const bool v0 = gq < nrw, v1 = gq + 8 < nrw;
    float pr[4], corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s0 = v0 ? c[j] * scale : NEG, s1 = v1 ? c[j + 2] * scale : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m2[j], mx);
      corr[j] = expf(m2[j] - mn);
      pr[j] = v0 ? expf(s0 - mn) : 0.f;
      pr[j + 2] = v1 ? expf(s1 - mn) : 0.f;
      float rs = pr[j] + pr[j + 2];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l2[j] = l2[j] * corr[j] + rs;
      m2[j] = mn;
    }
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      acc[mt][0] *= corr[0];
      acc[mt][1] *= corr[1];
      acc[mt][2] *= corr[0];
      acc[mt][3] *= corr[1];
    }
    // P^T as the B operand (k = row, n = head): rows 2qd (+1) and 8 + 2qd
    // (+1) of head gq, in bf16
    const uint32_t pb0 = movmatrix_trans(pack_bf16x2(pr[0], pr[1]));
    const uint32_t pb1 = movmatrix_trans(pack_bf16x2(pr[2], pr[3]));
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      uint32_t a[4];                   // V^T: dims 16mt.., the warp's 16 rows
      ldmatrix_x4_trans(a, vs + ((lane & 7) + 8 * (lane >> 4)) * DP + 16 * mt +
                               8 * ((lane >> 3) & 1));
      mma_16816(acc[mt], a, pb0, pb1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free

  // this rank's partial: the warps' partials merged in warp order
  float* wacc = reinterpret_cast<float*>(ring);                    // [NW][HN][D]
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wacc[(warp * HN + 2 * qd + (e & 1)) * D + 16 * mt + gq + 8 * (e >> 1)] = acc[mt][e];
  if (gq == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm[warp * HN + 2 * qd + j] = m2[j];
      wl[warp * HN + 2 * qd + j] = l2[j];
    }
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * HN + g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * HN + g] - mx);
      wf[w * HN + g] = f;
      L += wl[w * HN + g] * f;
    }
    part_m[g] = mx;
    part_l[g] = L;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += wacc[(w * HN + g) * D + d] * wf[w * HN + g];
    part_acc[i] = a;
  }
  cluster.sync();                      // every rank's partial is in place

  if (rank == 0) {                     // one remote load a thread for (m, l)
    for (int i = tid; i < cs * G; i += NT) {
      m_r[i] = cluster.map_shared_rank(part_m, i / G)[i % G];
      l_r[i] = cluster.map_shared_rank(part_l, i / G)[i % G];
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float mx = sn_t[g];
      for (int r = 0; r < cs; ++r) mx = fmaxf(mx, m_r[r * G + g]);
      float L = 0.f;
      for (int r = 0; r < cs; ++r) {
        const float w = expf(m_r[r * G + g] - mx);
        m_r[r * G + g] = w;
        L += l_r[r * G + g] * w;
      }
      const float pn = expf(sn_t[g] - mx);
      L_t[g] = L + pn;
      pn_t[g] = pn;
    }
    __syncthreads();
    for (int i = tid; i < G * D / 4; i += NT) {
      const int g = i / (D / 4), d = 4 * (i % (D / 4));
      float4 x[MAX_CS];
#pragma unroll
      for (int r = 0; r < MAX_CS; ++r)   // every rank's load in flight at once
        if (r < cs)
          x[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part_acc, r))[i];
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < MAX_CS; ++r)
        if (r < cs) {
          const float w = m_r[r * G + g];
          a.x += x[r].x * w;
          a.y += x[r].y * w;
          a.z += x[r].z * w;
          a.w += x[r].w * w;
        }
      const float pn = pn_t[g], inv = 1.f / fmaxf(L_t[g], 1e-30f);
      float4 o;
      o.x = (a.x + pn * vn_t[d]) * inv;
      o.y = (a.y + pn * vn_t[d + 1]) * inv;
      o.z = (a.z + pn * vn_t[d + 2]) * inv;
      o.w = (a.w + pn * vn_t[d + 3]) * inv;
      *reinterpret_cast<float4*>(out + ((size_t)b * Hq + h * G + g) * D + d) = o;
    }
    if (tid < D && p < S) {            // the new row, in place
      const size_t o = (row0 + p) * HD + h * D + tid;
      k3[o] = __float2bfloat16_rn(kn_t[tid]);
      v3[o] = __float2bfloat16_rn(vn_t[tid]);
    }
  }
  cluster.sync();                      // rank 0 has read every partial
}

template <int G>
int launch(const void* q, void* k3, void* v3, const void* kn, const void* vn,
           const void* pos, void* out, int li, int B, int S, int Hkv, int s_eff,
           int cs, float scale, cudaStream_t st) {
  constexpr int smem = smem_bytes<G>();
  static bool attrs_set = false;     // once, so later launches can be captured
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fdw_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)          // clusters of more than 8 blocks
      err = cudaFuncSetAttribute(fdw_kernel<G>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fdw_kernel<G>, (const float*)q, (__nv_bfloat16*)k3, (__nv_bfloat16*)v3,
      (const float*)kn, (const float*)vn, (const int*)pos, (float*)out, li, B, S, Hkv,
      s_eff, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// cs: blocks a cluster (1..16), one cluster per (batch row, kv head).
extern "C" int flash_decode_write(const void* q, void* k3, void* v3,
                                  const void* kn, const void* vn,
                                  const void* pos, void* out, int li, int B,
                                  int S, int Hq, int Hkv, int s_eff, int cs,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cs < 1 || cs > MAX_CS) return (int)cudaErrorInvalidValue;
  switch (Hq / Hkv) {
    case 1: return launch<1>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, cs, scale, st);
    case 2: return launch<2>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, cs, scale, st);
    case 4: return launch<4>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, cs, scale, st);
    case 8: return launch<8>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, cs, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
