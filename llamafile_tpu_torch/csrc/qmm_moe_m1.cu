// qmm_moe_m1: the fused M=1 FFN (gate|up, silu(g)*u, requantize, down).
//
// Replaces the TPU kernel _qmm_kernel_moe_m1 (llamafile_tpu/ops/qmatmul.py:1037),
// which the dense llama FFN reaches with the layer id as its "expert"
// (models/llama.py:960-971). On the TPU, phase B ran after all of phase A
// because the grid is sequential; Hopper blocks run in no order, so the entry
// below launches two kernels on one stream:
//   (A) moe_gateup_kernel: the gate|up GEMV on the GU_STRIPE-interleaved
//       weights. A block owns 64 gate columns and the 64 matching up columns
//       of one 2048-wide stripe pair, so its epilogue forms y = silu(g)*u for
//       two whole 32-groups and quantizes them exactly as
//       quantize_activations_g32 does (inv = 127/amax and sy = amax/127
//       computed apart, round half to even, clip to +-127), with the routing
//       weight folded into sy. Codes and scales go to a small device buffer.
//   (B) the down GEMV on those codes: the same kernel as qmm_txn_m1.
// What bounds it on an H100: device-memory bytes of the two weight streams
// (the 2*dff x d gate|up and the d x dff down, 4.5 bits a weight); the
// intermediate y costs dff bytes plus dff/8 of scales, and both phases use
// the split-K layout of qmm_txn_m1 to fill the SMs.
#include "qmm_common.cuh"

using namespace qmm;

struct GUOff {
  int j, o;
  __device__ long long operator()(int i) const {
    return i < 64 ? 2048LL * j + o + i : 2048LL * j + 1024 + o + (i - 64);
  }
};

__global__ void __launch_bounds__(THREADS)
moe_gateup_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                  const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
                  const __nv_bfloat16* __restrict__ bias, int8_t* __restrict__ yq,
                  float* __restrict__ sy, float* partial, int* counters, int K,
                  int Ngu, int S, float topw) {
  __shared__ float red[WARPS][TN];
  __shared__ float vals[TN];
  __shared__ float yv[64];
  const int tile = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = tile / 16, o = (tile % 16) * 64;     // stripe pair, offset
  const int n0 = lane < 16 ? 2048 * j + o + 4 * lane
                           : 2048 * j + 1024 + o + 4 * (lane - 16);
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);
  m1_block(x, sx, qs, sc, bias, Ngu, cb, ce, n0, red, vals);
  if (!splitk_combine(vals, TN, partial, (size_t)Ngu, GUOff{j, o},
                      counters + tile, S, s))
    return;
  if (threadIdx.x < 64) {
    const float g = vals[threadIdx.x], u = vals[64 + threadIdx.x];
    yv[threadIdx.x] = (g * (1.0f / (1.0f + expf(-g)))) * u;
  }
  __syncthreads();
  if (warp < 2) {
    const float v = yv[32 * warp + lane];
    float amax = fabsf(v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float inv = amax > 0.f ? 127.0f / amax : 0.f;
    const float q = fminf(fmaxf(rintf(v * inv), -127.f), 127.f);
    const int i = 1024 * j + o + 32 * warp + lane;
    yq[i] = (int8_t)q;
    if (lane == 0) sy[i / 32] = (amax / 127.0f) * topw;
  }
}

extern "C" int qmm_moe_m1(const void* x, const void* sx, const void* gu_qs,
                          const void* gu_sc, const void* gu_bias,
                          const void* dn_qs, const void* dn_sc,
                          const void* dn_bias, void* yq, void* sy, void* out,
                          void* partial_a, void* partial_b, void* counters,
                          int K, int dff, int Nd, int Sa, int Sb, float topw,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Ngu = 2 * dff;
  moe_gateup_kernel<<<dim3(Ngu / TN, Sa), THREADS, 0, st>>>(
      (const int8_t*)x, (const float*)sx, (const uint8_t*)gu_qs,
      (const __nv_bfloat16*)gu_sc, (const __nv_bfloat16*)gu_bias,
      (int8_t*)yq, (float*)sy, (float*)partial_a, (int*)counters, K, Ngu, Sa,
      topw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // stream order: phase A (and its counter reset) ends before phase B starts
  m1_gemv_kernel<<<dim3((Nd + TN - 1) / TN, Sb), THREADS, 0, st>>>(
      (const int8_t*)yq, (const float*)sy, (const uint8_t*)dn_qs,
      (const __nv_bfloat16*)dn_sc, (const __nv_bfloat16*)dn_bias, (float*)out,
      (float*)partial_b, (int*)counters, dff, Nd, Sb);
  return (int)cudaGetLastError();
}
