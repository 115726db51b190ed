// flash_prefill: causal GQA attention over the fresh prompt tokens on
// Hopper tensor cores (wgmma).
//
// Replaces the upstream Pallas TPU kernel flash_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which the reference
// calls from flash_prefill (llamafile_tpu/ops/attention.py:57) for prompts of
// T >= 128 tokens. Numerics kept from it: q, k, v in bf16; scores in f32,
// scaled after the dot; masked keys get p = 0 (the exp of its mask value,
// -0.7 x FLT_MAX); an online softmax with f32 row max m and sum l, each
// e^(x - m) taken as 2^((x - m) log2 e) on the SFU (ex2.approx, 2^-22
// relative); p rounded to bf16 before P.V with f32 accumulation; the output
// rounded to bf16 (q's dtype there) and stored as f32. The running output is
// kept unnormalized and divided by l once at the end (the upstream kernel
// renormalizes it each key block; the two differ by f32 rounding only).
//
// What bounds it on an H100: operations (2 T^2 D Hq FLOP causal, 3.4e10 at
// T = 2048: 0.035 ms at 989 TFLOP/s); the bytes are T (Hq + 2 Hkv) D bf16.
// Design: one block per (query head, query tile of BQ rows, batch row);
// the grid's x is the head, so every head's heaviest query tile is issued
// before any head's lighter ones (issued tile by tile within a head, the
// light tiles of the first heads left the heavy ones of the last for a
// second wave: 1.3x the time at T = 1024). Each warpgroup of a block owns
// 64 query rows. The query tile and a ring of STAGES BKV-key K and V tiles
// sit in shared memory in the 128-byte swizzle (wgmma_bf16.cuh), loaded by
// cp.async STAGES - 1 tiles ahead (V a tile later than K), every staged K/V
// tile serving all the block's warpgroups. S = Q K^T is wgmma from shared
// memory (Q K-major, K a K-major B); the softmax runs on the S accumulators
// in registers, and p, rounded to bf16 there, is the register A operand of
// O += P V (V the MN-major B, read through the transpose bit), so S and P
// never touch shared memory. Tile kt issues S kt and P V of tile kt - 1
// together and runs its softmax while P V runs. BKV = BQ, so key tiles
// above a query tile's diagonal are never visited and only the diagonal
// tile is masked. The KV head h / (Hq / Hkv) is read in place (no repeat
// copy, unlike the reference's jnp.repeat). Tiles by head dim (the f32
// accumulators bound them: S is 64 x BKV and O 64 x D a warpgroup): D =
// 128 two warpgroups (BQ = BKV = 128), D = 64 one (64: two blocks an SM
// read 12% faster than one of two warpgroups) and D = 256 one (64; O alone
// 128 registers a thread, and ptxas spills some). scripts/probe_attn.py
// times the variants (one warpgroup at D = 128, a third stage, exp2f).
// A producer warp with TMA, and ping-pong of two warpgroups' softmax and
// products, are later steps.
#include <float.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace mma;

template <int D>
struct Tiles {
  static constexpr int NWG = D == 128 ? 2 : 1;          // warpgroups a block
  static constexpr int BQ = 64 * NWG, BKV = BQ;         // query rows, keys a tile
  static constexpr int THREADS = 128 * NWG;
  static constexpr int STAGES = 2;                      // K and V tiles a ring
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;
  // Q | K stages | V stages, + room to align the base to 1024
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
  static constexpr int ON = D < 128 ? D : 128;          // O columns a wgmma
  static constexpr int NOH = D / ON;                    // O wgmmas a k16 slice
};

// Byte offset of 16-byte chunk c (8 bf16, c < D / 8) of row r in a tile of
// ROWS rows: 64-column blocks of ROWS x 128 bytes, each 128-byte swizzled.
template <int ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ROWS rows of D bf16 at src (row stride `stride` elements) into a tile.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(unsigned char* dst, const __nv_bfloat16* src,
                                          size_t stride) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % NT == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = threadIdx.x + NT * it, r = i / CH, c = i % CH;
    cp_async16(dst + tile_off<ROWS>(r, c), src + r * stride + 8 * c, true);
  }
}

// S = Q K^T of warpgroup wg over one K tile: D / 16 wgmmas, the first
// overwriting s.
template <int D, int BQ, int BKV>
__device__ __forceinline__ void qk(float (&s)[BKV / 2], uint32_t sq, uint32_t sk, int wg) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = wgmma::desc_sw128(
        sq + (kk >> 2) * (BQ * 128) + wg * (64 * 128) + 32 * (kk & 3), 16, 1024);
    const uint64_t db = wgmma::desc_sw128(sk + (kk >> 2) * (BKV * 128) + 32 * (kk & 3), 16,
                                          1024);
    if constexpr (BKV == 128)
      wgmma::ss_m64n128k16<0>(s, da, db, kk > 0);
    else
      wgmma::ss_m64n64k16<0>(s, da, db, kk > 0);
  }
}

// O += P V over one V tile: k16 slice kk of P (registers) against V's keys
// 16 kk .. 16 kk + 15, NOH wgmmas of ON columns each.
template <int D, int BKV, int ON, int NOH>
__device__ __forceinline__ void pv(float (&o)[NOH][ON / 2], const uint32_t (&pa)[BKV / 16][4],
                                   uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int nh = 0; nh < NOH; ++nh) {
      const uint64_t db =
          wgmma::desc_sw128(sv + nh * (ON / 64) * (BKV * 128) + 2048 * kk, BKV * 128, 1024);
      if constexpr (ON == 128)
        wgmma::rs_m64n128k16(o[nh], pa[kk], db);
      else
        wgmma::rs_m64n64k16(o[nh], pa[kk], db);
    }
}

// 2^x on the SFU (ex2.approx.ftz: 2^-22 relative error; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile in registers (register 4 j + 2 hh + e
// of s: row row0 + 8 hh, key key0 + 8 j + 2 qd + e; the quad of lanes
// sharing a row reduces by shuffles). The row max m is kept scaled to base
// 2 (m = max(s) * scale * log2 e), so that each p = e^(s scale - max) is
// one fma and one ex2: p = 2^(s * sl2 - m); the diagonal tile's keys past
// the row get p = 0 (the mask value's exp). Then the rescale alpha of the
// running sums, l updated with the f32 p, and p rounded to bf16 as the A
// fragments of P V (slice kk: keys 16 kk ..).
template <int BKV>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pn)[BKV / 16][4],
                                             bool diag, int key0, int row0, int qd,
                                             float sl2) {
  float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (diag && key0 + 8 * j + 2 * qd + (e & 1) > row0 + 8 * (e >> 1))
        s[4 * j + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], sl2, -m[e >> 1]));
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = alpha[r] * l[r] + rs[r];
  }
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    pn[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    pn[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pn[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pn[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int T,
                     int Hq, int Hkv, float scale) {
  using C = Tiles<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NT = C::THREADS, ON = C::ON, NOH = C::NOH;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + C::Q_BYTES;                  // [S] stages
  unsigned char* Vs = Ks + S * C::KV_BYTES;             // [S] stages
  const uint32_t sq = smem_addr(Qs), sk = smem_addr(Ks), sv = smem_addr(Vs);
  // heaviest tiles first: the grid's x (head) runs fastest, so every head's
  // last query tile is issued before any head's second-to-last
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, w = (tid >> 5) & 3, wg = tid >> 7;
  const size_t qstride = (size_t)Hq * D, kstride = (size_t)Hkv * D;
  const __nv_bfloat16* qg = q + ((size_t)b * T + q0) * qstride + (size_t)h * D;
  const __nv_bfloat16* kg = k + (size_t)b * T * kstride + (size_t)hk * D;
  const __nv_bfloat16* vg = v + (size_t)b * T * kstride + (size_t)hk * D;

  // cp.async groups: {Q, K 0}, {K i, V i - 1} for i = 1 .. S - 2, then one
  // a tile kt: {K kt + S - 1, V kt + S - 2} (tiles past the last are not
  // loaded); the last tile's V is waited for alone
  const int nkv = qt + 1;                               // key tiles 0..qt (BKV == BQ)
  auto load_kv = [&](int kn, int vn) {                  // K tile kn and V tile vn, if any
    if (kn < nkv)
      load_tile<BKV, D, NT>(Ks + (kn % S) * C::KV_BYTES, kg + (size_t)kn * BKV * kstride,
                            kstride);
    if (vn >= 0 && vn < nkv)
      load_tile<BKV, D, NT>(Vs + (vn % S) * C::KV_BYTES, vg + (size_t)vn * BKV * kstride,
                            kstride);
    cp_async_commit();
  };
  load_tile<BQ, D, NT>(Qs, qg, qstride);
  load_kv(0, -1);
#pragma unroll
  for (int i = 1; i < S - 1; ++i) load_kv(i, i - 1);

  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * w + g;           // this thread's rows: row0, row0 + 8
  const float sl2 = scale * 1.4426950408889634f;        // the scale times log2 e
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[BKV / 2];
  float o[NOH][ON / 2];
  uint32_t pa[BKV / 16][4], pn[BKV / 16][4];            // p of tile kt - 1 (in P V), of kt
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int nh = 0; nh < NOH; ++nh)
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) o[nh][i] = 0.f;

  // Tile kt issues S kt = Q K kt and O += P kt-1 V kt-1 together, runs the
  // softmax of S kt while P V runs, then rescales O once P V is done; V kt
  // is loaded a tile later than K kt, when P V kt-2 has left its stage.
  auto start_tile = [&](int kt) {
    cp_async_wait<S - 2>();                             // K kt, V kt - 1 (and Q) landed here
    wgmma::fence_proxy_async();
    __syncthreads();                                    // ... everywhere; tile kt - 1's reads done
    load_kv(kt + S - 1, kt + S - 2);
  };
  start_tile(0);
  wgmma::fence_operands(s);
  wgmma::fence();
  qk<D, BQ, BKV>(s, sq, sk, wg);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operands(s);
  softmax_tile<BKV>(s, m, l, alpha, pa, qt == 0, 0, row0, qd, sl2);   // O is still 0
  for (int kt = 1; kt < nkv; ++kt) {
    start_tile(kt);
    wgmma::fence_operands(s);
#pragma unroll
    for (int nh = 0; nh < NOH; ++nh) wgmma::fence_operands(o[nh]);
    wgmma::fence_operands(pa);
    wgmma::fence();
    qk<D, BQ, BKV>(s, sq, sk + (kt % S) * C::KV_BYTES, wg);
    wgmma::commit();
    pv<D, BKV, ON, NOH>(o, pa, sv + ((kt - 1) % S) * C::KV_BYTES);
    wgmma::commit();
    wgmma::wait<1>();                                   // S kt done, P V may run on
    wgmma::fence_operands(s);
    softmax_tile<BKV>(s, m, l, alpha, pn, kt == qt, kt * BKV, row0, qd, sl2);
    wgmma::wait<0>();                                   // P V kt - 1 done
    wgmma::fence_operands(pa);                          // p stays put until its wgmmas end
#pragma unroll
    for (int nh = 0; nh < NOH; ++nh) {
      wgmma::fence_operands(o[nh]);
#pragma unroll
      for (int i = 0; i < ON / 2; ++i) o[nh][i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
  }
  cp_async_wait<0>();                                   // V of the last tile
  wgmma::fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int nh = 0; nh < NOH; ++nh) wgmma::fence_operands(o[nh]);
  wgmma::fence_operands(pa);
  wgmma::fence();
  pv<D, BKV, ON, NOH>(o, pa, sv + ((nkv - 1) % S) * C::KV_BYTES);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operands(pa);
#pragma unroll
  for (int nh = 0; nh < NOH; ++nh) wgmma::fence_operands(o[nh]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
    float* orow = out + ((size_t)b * T + row0 + 8 * r) * qstride + (size_t)h * D + 2 * qd;
#pragma unroll
    for (int nh = 0; nh < NOH; ++nh)
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const float v0 = __bfloat162float(__float2bfloat16_rn(o[nh][4 * j + 2 * r] * inv));
        const float v1 = __bfloat162float(__float2bfloat16_rn(o[nh][4 * j + 2 * r + 1] * inv));
        *reinterpret_cast<float2*>(orow + nh * ON + 8 * j) = make_float2(v0, v1);
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T, int Hq,
           int Hkv, float scale, cudaStream_t st) {
  using C = Tiles<D>;
  if (T % C::BQ) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid(Hq, T / C::BQ, B);
  flash_prefill_kernel<D><<<grid, C::THREADS, C::SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (float*)out, T, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [B, T, Hq, D]; k, v bf16 [B, T, Hkv, D]; out f32 [B, T, Hq, D].
// T a multiple of the query tile (128 at D = 128, else 64), Hq % Hkv == 0.
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                             int T, int Hq, int Hkv, int D, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 64 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch<64>(q, k, v, out, B, T, Hq, Hkv, scale, st);
    case 128: return launch<128>(q, k, v, out, B, T, Hq, Hkv, scale, st);
    case 256: return launch<256>(q, k, v, out, B, T, Hq, Hkv, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
