// flash_decode_write: T=1 GQA attention over the layer-stacked flat bf16 KV
// cache [L, B, S, Hkv*D], with the new token's K/V row written in place.
//
// Replaces the TPU kernel _flash_decode_write_kernel
// (llamafile_tpu/ops/attention.py:217), called by flash_decode_write_stacked
// (:317). Numerics kept from it: q rounded to bf16; scores in f32 times
// `scale`; p rounded to bf16 before P.V while l sums the f32 p; cache rows
// j <= pos-1 are streamed (the stale row at pos is excluded) and the new
// token, whose k/v arrive in f32, is merged last; the output is divided by
// max(l, 1e-30). Its new K/V land as bf16 at [li, b, pos] in the cache
// tensor itself.
//
// What bounds it on an H100: device-memory bytes of the visible cache rows
// (2 * pos * Hkv * D * 2 bytes a layer); the arithmetic is ~2 flops a byte.
// This first version runs one block per (batch row, kv head), 16 warps
// striding over positions with 4 rows in flight each and a per-warp online
// softmax (lane = 4 of the 128 head dims), merged in warp order through
// shared memory. With Hkv = 8 that is 8 blocks a layer: splitting the
// positions over more blocks (flash-decoding) is the next step.
// The window and softcap options of the TPU kernel are not in this kernel;
// its wrapper raises for them (llama3 uses neither).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int FW = 16;          // warps a block
constexpr int UNROLL = 4;       // cache rows in flight a warp
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&u.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}

template <int G>
__global__ void __launch_bounds__(FW * 32)
fdw_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ k3,
           __nv_bfloat16* __restrict__ v3, const float* __restrict__ kn,
           const float* __restrict__ vn, const int* __restrict__ pos,
           float* __restrict__ out, int li, int B, int S, int Hkv, int s_eff,
           float scale) {
  extern __shared__ float smem[];
  float* sm = smem;                      // [FW][G]
  float* sl = sm + FW * G;               // [FW][G]
  float* sacc = sl + FW * G;             // [FW][G][D]
  __shared__ float ssn[G];
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HD = Hkv * D, Hq = Hkv * G;
  const int p = pos[b];
  const int n_vis = min(p, s_eff);
  const size_t row0 = ((size_t)li * B + b) * S;
  const __nv_bfloat16* kb = k3 + row0 * HD + h * D + 4 * lane;
  const __nv_bfloat16* vb = v3 + row0 * HD + h * D + 4 * lane;

  float qv[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qv[g][e] = bf16_round(q[((size_t)b * Hq + h * G + g) * D + 4 * lane + e]);

  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  for (int j0 = warp; j0 < n_vis; j0 += FW * UNROLL) {
    float kf[UNROLL][4], vf[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * FW;
      if (j < n_vis) {
        load4(kb + (size_t)j * HD, kf[u]);
        load4(vb + (size_t)j * HD, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j0 + u * FW >= n_vis) break;          // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) sc += kf[u][e] * qv[g][e];
        sc = warp_sum(sc) * scale;
        const float mn = fmaxf(m[g], sc);
        const float corr = expf(m[g] - mn);
        const float pp = expf(sc - mn);
        l[g] = l[g] * corr + pp;
        const float pb = bf16_round(pp);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = acc[g][e] * corr + pb * vf[u][e];
        m[g] = mn;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm[warp * G + g] = m[g];
      sl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[(warp * G + g) * D + 4 * lane + e] = acc[g][e];
  }
  if (warp == 0) {               // the new token's scores, from its f32 k
    float knv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) knv[e] = kn[(size_t)b * HD + h * D + 4 * lane + e];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) sc += knv[e] * qv[g][e];
      sc = warp_sum(sc) * scale;
      if (lane == 0) ssn[g] = sc;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = NEG;
    for (int w = 0; w < FW; ++w) mx = fmaxf(mx, sm[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < FW; ++w) {
      const float f = expf(sm[w * G + g] - mx);
      L += sl[w * G + g] * f;
      A += sacc[(w * G + g) * D + d] * f;
    }
    const float sn = ssn[g];
    const float nm = fmaxf(mx, sn);
    const float corr = expf(mx - nm), pn = expf(sn - nm);
    L = L * corr + pn;
    A = A * corr + pn * vn[(size_t)b * HD + h * D + d];
    out[((size_t)b * Hq + h * G + g) * D + d] = A / fmaxf(L, 1e-30f);
  }
  if (threadIdx.x < D && p < S) {  // the new row, in place
    const size_t o = (row0 + p) * HD + h * D + threadIdx.x;
    k3[o] = __float2bfloat16_rn(kn[(size_t)b * HD + h * D + threadIdx.x]);
    v3[o] = __float2bfloat16_rn(vn[(size_t)b * HD + h * D + threadIdx.x]);
  }
}

template <int G>
int launch(const void* q, void* k3, void* v3, const void* kn, const void* vn,
           const void* pos, void* out, int li, int B, int S, int Hkv, int s_eff,
           float scale, cudaStream_t st) {
  const int smem = (2 * FW * G + FW * G * D) * (int)sizeof(float);
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fdw_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  fdw_kernel<G><<<B * Hkv, FW * 32, smem, st>>>(
      (const float*)q, (__nv_bfloat16*)k3, (__nv_bfloat16*)v3,
      (const float*)kn, (const float*)vn, (const int*)pos, (float*)out, li, B,
      S, Hkv, s_eff, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_write(const void* q, void* k3, void* v3,
                                  const void* kn, const void* vn,
                                  const void* pos, void* out, int li, int B,
                                  int S, int Hq, int Hkv, int s_eff,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (Hq / Hkv) {
    case 1: return launch<1>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, scale, st);
    case 2: return launch<2>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, scale, st);
    case 4: return launch<4>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, scale, st);
    case 8: return launch<8>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, s_eff, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
