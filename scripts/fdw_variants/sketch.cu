// A design variant of llamafile_tpu_torch/csrc/flash_decode_write.cu, kept
// only for the timings of scripts/probe_fdw.py (PERF.md): the first sketch
// of the cluster split. It computes the same function with the same
// numerics (q and p rounded to bf16, f32 scores and l, the new token merged
// last, out / max(l, 1e-30)); the port never calls it.
//
// The sketch: each (batch row, kv head) is one thread-block cluster of `cs`
// blocks of 8 warps (the C entry takes cs, 1..16; 16 is non-portable):
// - rank r takes the rows [r * n_vis / cs, (r + 1) * n_vis / cs), n_vis =
//   min(pos, s_eff); a rank with no rows leaves m = -1e30, l = 0;
// - it streams its rows in tiles of TR = 32 through a block-wide ring of
//   NS = 4 stages in shared memory, cp.async 16 bytes a lane, with a block
//   barrier a stage;
// - a tile: each 16-lane group takes one row's scores for the G query
//   heads of the group (scalar dots and shuffles), then one max and one
//   rescale of acc a tile and head, then P.V with each thread owning 2
//   output dims of all G heads over every NPAR-th row of the tile;
// - each rank leaves (m, l, acc[G][D]) in its shared memory; after a
//   cluster barrier rank 0 reads ranks 0..cs-1 in rank order through
//   distributed shared memory, merges the new token last, writes out and
//   the new K/V row, and a second barrier keeps every rank's shared memory
//   alive until rank 0 is done.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;
constexpr int NT = 256;              // threads a block
constexpr int NHW = NT / 16;         // 16-lane groups a block
constexpr int TR = 32;               // cache rows a tile: one a lane of the softmax warp
constexpr int NS = 4;                // stages of the ring
constexpr int NPAR = NT / (D / 2);   // row classes of the P.V step
constexpr int STAGE = 2 * TR * D;    // bf16 elements of a stage: K rows, then V rows
constexpr int MAX_CS = 16;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float half_sum(float v) {
  // the 16 lanes of one group; both halves of the warp run it together
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// first row of rank r of cs over n rows (testing.fdw_rank_ranges is the same rule)
__device__ __forceinline__ int rank_lo(int r, int n, int cs) {
  return (int)((long long)r * n / cs);
}

// rows j0 .. j0 + nr - 1 of this rank's K and V slices into one stage
__device__ __forceinline__ void load_tile(__nv_bfloat16* stage, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int j0, int nr, int HD) {
  constexpr int CH = D / 8;          // 16-byte chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < 2 * TR * CH; c += NT) {
    const int kv = c / (TR * CH), row = c / CH % TR, col = c % CH;
    if (row < nr)
      cp_async16(stage + (kv * TR + row) * D + col * 8,
                 (kv ? vb : kb) + (size_t)(j0 + row) * HD + col * 8);
  }
}

template <int G>
constexpr int smem_bytes() {
  // ring | acc [G][D] | scores [G][TR] | p [TR][G] | kn, vn [D] |
  // m, l, corr, sn, L, pn [G] | ranks' m, l [MAX_CS][G]
  return NS * STAGE * 2 + (G * D + 2 * G * TR + 2 * D + 6 * G + 2 * MAX_CS * G) * 4;
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
  float* s_t = part_acc + G * D;                                    // [G][TR]
  float* p_t = s_t + G * TR;                                        // [TR][G]
  float* kn_t = p_t + TR * G;          // rank 0: the new token's f32 k, v
  float* vn_t = kn_t + D;
  float* part_m = vn_t + D;
  float* part_l = part_m + G;
  float* corr_t = part_l + G;
  float* sn_t = corr_t + G;            // rank 0: the new token's scores
  float* L_t = sn_t + G;               // rank 0: merged l
  float* pn_t = L_t + G;               // rank 0: the new token's weight
  float* m_r = pn_t + G;               // rank 0: [MAX_CS][G] ranks' m, then weights
  float* l_r = m_r + MAX_CS * G;       // rank 0: [MAX_CS][G] ranks' l

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hl = tid & 15, hw = tid >> 4;
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
  for (int t = 0; t < NS; ++t) {       // the first NS tiles in flight at once
    if (t < n_tiles) load_tile(ring + t * STAGE, kb, vb, t * TR, min(TR, n - t * TR), HD);
    cp_commit();
  }

  if (rank == 0 && tid < D) {
    kn_t[tid] = kn[(size_t)b * HD + h * D + tid];
    vn_t[tid] = vn[(size_t)b * HD + h * D + tid];
  }
  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qv[g][e] = bf16_round(q[((size_t)b * Hq + h * G + g) * D + 8 * hl + e]);

  if (rank == 0 && warp == 0) {        // the new token's scores, from its f32 k
    float knv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) knv[e] = kn[(size_t)b * HD + h * D + 8 * hl + e];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) sc += qv[g][e] * knv[e];
      sc = half_sum(sc) * scale;
      if (lane == 0) sn_t[g] = sc;
    }
  }

  const int d2 = tid % (D / 2), par = tid / (D / 2);
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
  float m_run = NEG, l_run = 0.f;      // of head `warp`, in warps < G

  for (int t = 0; t < n_tiles; ++t) {
    const int nr = min(TR, n - t * TR);
    __nv_bfloat16* ks = ring + (t % NS) * STAGE;
    const __nv_bfloat16* vs = ks + TR * D;
    cp_wait<NS - 1>();
    __syncthreads();
    // scores: group hw takes rows hw and hw + NHW; the bound is per group,
    // the shuffles run in both halves of every warp
#pragma unroll
    for (int r = hw; r < TR; r += NHW) {
      float kf[8];
      if (r < nr) {
        const uint4 u = *reinterpret_cast<const uint4*>(ks + r * D + 8 * hl);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kf[2 * i] = __low2float(h2[i]);
          kf[2 * i + 1] = __high2float(h2[i]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) sc += qv[g][e] * kf[e];
        sc = half_sum(sc) * scale;
        if (hl == 0 && r < nr) s_t[g * TR + r] = sc;
      }
    }
    __syncthreads();
    if (warp < G) {                    // warp g: the tile's softmax of head g
      const float s = lane < nr ? s_t[warp * TR + lane] : NEG;
      const float mn = fmaxf(m_run, warp_max(s));
      const float c = expf(m_run - mn);
      const float pp = lane < nr ? expf(s - mn) : 0.f;
      l_run = l_run * c + warp_sum(pp);
      m_run = mn;
      p_t[lane * G + warp] = bf16_round(pp);
      if (lane == 0) corr_t[warp] = c;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float c = corr_t[g];
      acc[g][0] *= c;
      acc[g][1] *= c;
    }
    for (int j = par; j < nr; j += NPAR) {
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vs + j * D + 2 * d2);
      const float v0 = __low2float(v2), v1 = __high2float(v2);
      float pj[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int g = 0; g < G; g += 4) {
          const float4 f = *reinterpret_cast<const float4*>(p_t + j * G + g);
          pj[g] = f.x;
          pj[g + 1] = f.y;
          pj[g + 2] = f.z;
          pj[g + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) pj[g] = p_t[j * G + g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g][0] += pj[g] * v0;
        acc[g][1] += pj[g] * v1;
      }
    }
    __syncthreads();                   // the stage is free again
    if (t + NS < n_tiles)
      load_tile(ks, kb, vb, (t + NS) * TR, min(TR, n - (t + NS) * TR), HD);
    cp_commit();
  }
  cp_wait<0>();

  // this rank's partial: the NPAR row classes summed in class order
  float* red = reinterpret_cast<float*>(ring);                     // [NPAR][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float2*>(red + (par * G + g) * D + 2 * d2) =
        make_float2(acc[g][0], acc[g][1]);
  if (warp < G && lane == 0) {
    part_m[warp] = m_run;
    part_l[warp] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    float a = red[i];
#pragma unroll
    for (int c = 1; c < NPAR; ++c) a += red[c * G * D + i];
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
