// qmm_moe_m1: the fused M=1 FFN (gate|up, silu(g)*u, requantize, down) for
// every routed slot of a step in one launch pair.
//
// Replaces the TPU kernel _qmm_kernel_moe_m1 (llamafile_tpu/ops/qmatmul.py:1037,
// call :1150), which runs all S slots in one call with the expert ids ei,
// token rows ti and routing weights topw taken by scalar prefetch. Here the
// three are int32 / f32 device arrays [S] that each block reads itself
// (blockIdx.z is the slot), so a MoE layer feeds the router's on-device
// top-k straight in; the dense llama FFN passes its layer id as a one-slot
// ei (models/llama.py), weight 1. On the TPU, phase B ran after all of
// phase A because the grid is sequential; Hopper blocks run in no order, so
// the entry below launches two kernels on one stream:
//   (A) moe_gateup_kernel: the gate|up GEMV of slot z on expert ei[z]'s
//       GU_STRIPE-interleaved weights and activation row ti[z]. A block owns
//       64 gate columns and the 64 matching up columns of one 2048-wide
//       stripe pair, so its epilogue forms y = silu(g)*u for two whole
//       32-groups and quantizes them exactly as quantize_activations_g32
//       does (inv = 127/amax and sy = amax/127 computed apart, round half to
//       even, clip to +-127), with topw[z] folded into sy. Codes and scales
//       go to a small device buffer, one row a slot.
//   (B) the down GEMV of slot z on expert ei[z] and row z of those codes:
//       the routed m1_gemv_kernel of qmm_txn_m1 / qmm_txn_m1_r.
// What bounds it on an H100: device-memory bytes of the S experts' two
// weight streams (the 2*dff x d gate|up and the d x dff down, 4.5 bits a
// weight); the intermediate y costs dff bytes plus dff/8 of scales a slot.
// Both phases run the M = 1 body of qmm_m1.cuh (a cp.async ring a warp, the
// activations staged once a block, a column tile's K splits one cluster
// summed in a fixed order through distributed shared memory), every slot
// on its own, split by ops.qmatmul.m1_split.
#include "qmm_m1.cuh"

using namespace qmm;

// Stripe pair j's 64 gate columns from offset o, then the 64 matching up
// columns: the tile columns of a gate|up block.
struct GUCols {
  int j, o;
  __device__ int operator()(int i) const {
    return i < 64 ? 2048 * j + o + i : 2048 * j + 1024 + o + (i - 64);
  }
};

__global__ void __launch_bounds__(M1_THREADS)
moe_gateup_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                  const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
                  const __nv_bfloat16* __restrict__ bias, int8_t* __restrict__ yq,
                  float* __restrict__ sy, int K, int Ngu, int S, int xsb,
                  const int* __restrict__ ei,
                  const int* __restrict__ ti, const float* __restrict__ topw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float vals[TN];
  __shared__ float yv[64];
  const Slot sl(ei, ti);
  const int dff = Ngu / 2;
  const size_t wsc = (size_t)sl.e * (K / 32) * Ngu;
  x += (size_t)sl.row * K;
  sx += (size_t)sl.row * (K / 32);
  qs += (size_t)sl.e * (K / 2) * Ngu;
  sc += wsc;
  if (bias != nullptr) bias += wsc;
  yq += (size_t)sl.z * dff;
  sy += (size_t)sl.z * (dff / 32);
  const int tile = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const GUCols cols{tile / 16, (tile % 16) * 64};     // stripe pair, offset
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);
  if (!m1_tile(x, sx, qs, sc, bias, Ngu, cb, ce, S, s, cols, smem, xsb, vals)) return;
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
    const int i = 1024 * cols.j + cols.o + 32 * warp + lane;
    yq[i] = (int8_t)q;
    if (lane == 0) sy[i / 32] = (amax / 127.0f) * __ldg(topw + sl.z);
  }
}

// x int8 [M, K], sx f32 [M, K/32]; gate|up qs uint8 [E, K/2, 2 dff], sc and
// bias bf16 [E, K/32, 2 dff]; down qs uint8 [E, dff/2, Nd], sc and bias
// bf16 [E, dff/32, Nd]; ei, ti int32 and topw f32 [slots]; yq int8
// [slots, dff], sy f32 [slots, dff/32]; out f32 [slots, Nd]. K % 256 == 0,
// dff % 1024 == 0, Nd % 16 == 0, Sa <= min(K / 64, 8), Sb <= min(dff / 64,
// 8).
extern "C" int qmm_moe_m1(const void* x, const void* sx, const void* gu_qs,
                          const void* gu_sc, const void* gu_bias,
                          const void* dn_qs, const void* dn_sc,
                          const void* dn_bias, void* yq, void* sy, void* out,
                          const void* ei, const void* ti, const void* topw,
                          int K, int dff, int Nd, int Sa, int Sb, int slots,
                          void* stream) {
  if (K < 256 || K % 256 || dff < 1024 || dff % 1024 || Nd < 16 || Nd % 16 || Sa < 1
      || Sa > K / 64 || Sa > M1_MAX_SPLITS || Sb < 1 || Sb > dff / 64 || slots < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Ngu = 2 * dff;
  static bool smem_set = false;
  const int xsb = m1_xsb(K, Sa), smem = m1_smem(xsb);
  if (smem > M1_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = m1_allow_smem(moe_gateup_kernel, &smem_set);
  if (err != cudaSuccess) return (int)err;
  err = m1_cluster_launch(moe_gateup_kernel, dim3(Ngu / TN, Sa, slots), smem, st,
                          (const int8_t*)x, (const float*)sx, (const uint8_t*)gu_qs,
                          (const __nv_bfloat16*)gu_sc, (const __nv_bfloat16*)gu_bias,
                          (int8_t*)yq, (float*)sy, K, Ngu, Sa, xsb, (const int*)ei,
                          (const int*)ti, (const float*)topw);
  if (err != cudaSuccess) return (int)err;
  // stream order: phase A ends before phase B starts
  return (int)m1_gemv_launch(dim3((Nd + TN - 1) / TN, Sb, slots), st, yq, sy, dn_qs, dn_sc,
                             dn_bias, out, dff, Nd, (const int*)ei, nullptr);
}
