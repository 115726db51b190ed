// flash_prefill: causal GQA attention over the fresh prompt tokens on
// Hopper tensor cores (FlashAttention-2 on mma.sync).
//
// Replaces the upstream Pallas TPU kernel flash_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which the reference
// calls from flash_prefill (llamafile_tpu/ops/attention.py:57) for prompts of
// T >= 128 tokens. Numerics kept from it: q, k, v in bf16; scores in f32,
// scaled after the dot; masked scores get its mask value (-0.7 x FLT_MAX);
// an online softmax with f32 row max m and sum l; p rounded to bf16 before
// P.V with f32 accumulation; the output rounded to bf16 (q's dtype there)
// and stored as f32. The running output is kept unnormalized and divided by
// l once at the end (the upstream kernel renormalizes it each key block; the
// two differ by f32 rounding only).
//
// What bounds it on an H100: operations (2 T^2 D Hq FLOP causal, 3.4e10 at
// T = 2048: 0.035 ms at 989 TFLOP/s); the bytes are T (Hq + 2 Hkv) D bf16.
// Design: one block of 4 warps per (64-row query tile, query head, batch
// row), each warp owning 16 query rows. The query tile sits in shared
// memory; 64-key tiles of K and V are double-buffered with cp.async, so the
// next tile loads while the tensor cores run this one. S = Q K^T and O += P V
// run on mma.sync.m16n8k16 (K fragments by ldmatrix, V by ldmatrix.trans);
// the S accumulators become the A fragments of P V in registers. The KV head
// h / (Hq / Hkv) is read in place (no repeat copy, unlike the reference's
// jnp.repeat), key tiles above the diagonal are never visited, only the
// diagonal tile is masked, and the heaviest query tiles are scheduled first.
#include <float.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma;

constexpr int BQ = 64, BKV = 64, WARPS = 4;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <int D>
constexpr int smem_bytes() {
  return 5 * BQ * (D + 8) * (int)sizeof(__nv_bfloat16);   // Q, 2 x K, 2 x V
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int T,
                     int Hq, int Hkv, float scale) {
  constexpr int DP = D + 8;                // padded row stride (conflict-free ldmatrix)
  constexpr int CH = D / 8;                // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DP]
  __nv_bfloat16* Ks = Qs + BQ * DP;                                 // [2][BKV][DP]
  __nv_bfloat16* Vs = Ks + 2 * BKV * DP;                            // [2][BKV][DP]
  const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const __nv_bfloat16* qg = q + ((size_t)b * T + q0) * qstride + (size_t)h * D;
  const __nv_bfloat16* kg = k + (size_t)b * T * kstride + (size_t)hk * D;
  const __nv_bfloat16* vg = v + (size_t)b * T * kstride + (size_t)hk * D;

  for (int i = tid; i < BQ * CH; i += WARPS * 32) {
    const int r = i / CH, c = i % CH;
    cp_async16(Qs + r * DP + 8 * c, qg + r * qstride + 8 * c, true);
  }
  auto load_kv = [&](int kt, int buf) {
    for (int i = tid; i < BKV * CH; i += WARPS * 32) {
      const int r = i / CH, c = i % CH;
      const size_t off = (size_t)(kt * BKV + r) * kstride + 8 * c;
      cp_async16(Ks + (buf * BKV + r) * DP + 8 * c, kg + off, true);
      cp_async16(Vs + (buf * BKV + r) * DP + 8 * c, vg + off, true);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q0 + 16 * warp + g;          // this thread's rows: row0, row0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  const int nkv = qt + 1;                        // key tiles 0..qt (BKV == BQ)
  for (int kt = 0; kt < nkv; ++kt) {
    const int buf = kt & 1;
    cp_async_wait_all();
    __syncthreads();                             // tile kt visible; tile kt-1 done
    if (kt + 1 < nkv) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = Ks + buf * BKV * DP;
    const __nv_bfloat16* vs = Vs + buf * BKV * DP;

    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (16 * warp + (lane & 15)) * DP + 16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (16 * np + (lane & 7) + 8 * (lane >> 4)) * DP + 16 * kk +
                           8 * ((lane >> 3) & 1));
        mma_16816(s[2 * np], a, r[0], r[1]);
        mma_16816(s[2 * np + 1], a, r[2], r[3]);
      }
    }

    const bool diag = kt == qt;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * scale;
        if (diag) {
          const int key = kt * BKV + 8 * j + 2 * qd + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key > row) val += MASK_VALUE;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (16 * kk + (lane & 15)) * DP + 16 * dp + 8 * (lane >> 4));
        mma_16816(o[2 * dp], a, r[0], r[1]);
        mma_16816(o[2 * dp + 1], a, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
    float* orow = out + ((size_t)b * T + row0 + 8 * r) * qstride + (size_t)h * D + 2 * qd;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float v0 = __bfloat162float(__float2bfloat16_rn(o[i][2 * r] * inv));
      const float v1 = __bfloat162float(__float2bfloat16_rn(o[i][2 * r + 1] * inv));
      *reinterpret_cast<float2*>(orow + 8 * i) = make_float2(v0, v1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T, int Hq,
           int Hkv, float scale, cudaStream_t st) {
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes<D>());
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(T / BQ, Hq, B);
  flash_prefill_kernel<D><<<grid, WARPS * 32, smem_bytes<D>(), st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (float*)out, T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B, T, Hq, D]; k, v bf16 [B, T, Hkv, D]; out f32 [B, T, Hq, D].
// T % 64 == 0, Hq % Hkv == 0, D in (64, 128, 256).
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                             int T, int Hq, int Hkv, int D, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < BQ || T % BQ || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch<64>(q, k, v, out, B, T, Hq, Hkv, scale, st);
    case 128: return launch<128>(q, k, v, out, B, T, Hq, Hkv, scale, st);
    case 256: return launch<256>(q, k, v, out, B, T, Hq, Hkv, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
