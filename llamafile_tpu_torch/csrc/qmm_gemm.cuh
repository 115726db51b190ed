// The bf16-dequant GEMM body shared by qmm_dequant.cu (f32 out, q4b and
// q8b) and qmm_planes.cu (q4b, f32 or bf16 out).
//
//   y[M, Ns] = x[M, K] bf16 @ W,  W[k, n] = bf16(code[k, n] * scale[k/g, n])
// The weight product is rounded once to bf16, as the TPU kernels' dequant
// multiplies in bf16: both factors are bf16 values, so their f32 product is
// exact and __float2bfloat16_rn of it gives the same bits. q4b codes are the
// planar nibbles (lo plane q, hi plane int8((p ^ 0x80) & 0xF0) = 16q - 128,
// the fold living in the stored scales); q8b codes are int8 with g 32 (Q8_0)
// or 16 (Q6_K). Accumulation is f32; the epilogue writes f32, or rounds
// each sum once to bf16.
//
// Design: 128 x 128 output tiles on mma.sync.m16n8k16 (bf16 in, f32 out),
// 8 warps of 64 x 32. Each 64-deep K step stages the bf16 activations with
// cp.async and dequantizes the (64 x 128) weight tile into shared memory
// once, where all 128 rows of the tile reuse it through ldmatrix; both are
// double-buffered, and the next step's raw codes and scales are loaded into
// registers while the tensor cores run the current step. A q4b K step is one
// "chunk": 32 packed rows give 32 lo-plane and 32 hi-plane K rows (each
// packed byte is read once and feeds both planes), so the A tile takes the
// matching two 32-column runs of x (the even and odd 128-wide K chunks of
// each 256-superblock). The grid walks M fastest, so the M tiles of one
// column tile run together and share its weight reads in L2. Rows past M are
// zero-filled and never stored; warps whose rows are all past M skip their
// products. wgmma/TMA are a later step.
#pragma once

#include "mma_bf16.cuh"

namespace {

using namespace mma;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int APAD = BK + 8;           // bf16 row stride of the A tile
constexpr int BPAD = BN + 8;           // bf16 row stride of the B tile
constexpr int A_STAGE = BM * APAD;     // bf16 elements a stage
constexpr int B_STAGE = BK * BPAD;
constexpr int SMEM_BYTES = 2 * (A_STAGE + B_STAGE) * (int)sizeof(__nv_bfloat16);

// Raw codes and scales of one K step for one thread: rows r and r + 32 of
// the dequantized tile (q4b: the lo and hi planes of packed row r), 16
// columns at 16 * seg.
struct Raw {
  uint4 code[2];
  uint4 sc[2][2];
};

template <bool Q4, int G>
__device__ __forceinline__ void load_raw(Raw& raw, const uint8_t* qs,
                                         const __nv_bfloat16* sc, int ks, int Ns,
                                         int col, bool valid) {
  const int r = threadIdx.x >> 3;
  int row0, row1, g0, g1;
  if (Q4) {
    const int sb = ks >> 2, j = ks & 3;
    row0 = 128 * sb + 32 * j + r;      // packed row: lo and hi planes
    row1 = row0;
    g0 = 8 * sb + j;
    g1 = g0 + 4;
  } else {
    row0 = BK * ks + r;
    row1 = row0 + 32;
    g0 = row0 / G;
    g1 = row1 / G;
  }
  const uint4 z = make_uint4(0, 0, 0, 0);
  raw.code[0] = valid ? __ldg(reinterpret_cast<const uint4*>(qs + (size_t)row0 * Ns + col)) : z;
  raw.code[1] = (!Q4 && valid)
                    ? __ldg(reinterpret_cast<const uint4*>(qs + (size_t)row1 * Ns + col))
                    : z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* s0 = sc + (size_t)(h ? g1 : g0) * Ns + col;
    raw.sc[h][0] = valid ? __ldg(reinterpret_cast<const uint4*>(s0)) : z;
    raw.sc[h][1] = valid ? __ldg(reinterpret_cast<const uint4*>(s0 + 8)) : z;
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Code c of byte i of a little-endian word.
template <bool Q4, int PLANE>
__device__ __forceinline__ float code_of(uint32_t w, int i) {
  const uint32_t b = (w >> (8 * i)) & 0xFFu;
  if (Q4) return PLANE == 0 ? (float)(b & 0x0Fu) : (float)(int8_t)((b ^ 0x80u) & 0xF0u);
  return (float)(int8_t)b;
}

// 16 codes times 16 scales, rounded to bf16, into 16 bf16 of shared memory.
template <bool Q4, int PLANE>
__device__ __forceinline__ void dequant16(uint4 code, uint4 s0, uint4 s1,
                                          __nv_bfloat16* dst) {
  const uint32_t cw[4] = {code.x, code.y, code.z, code.w};
  const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t out[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t w = cw[p >> 1];
    const int i = 2 * (p & 1);
    out[p] = pack_bf16x2(code_of<Q4, PLANE>(w, i) * bf16_lo(sw[p]),
                         code_of<Q4, PLANE>(w, i + 1) * bf16_hi(sw[p]));
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

template <bool Q4>
__device__ __forceinline__ void store_tile(const Raw& raw, __nv_bfloat16* Bs) {
  const int r = threadIdx.x >> 3, seg = threadIdx.x & 7;
  if (Q4) {
    dequant16<true, 0>(raw.code[0], raw.sc[0][0], raw.sc[0][1], Bs + r * BPAD + 16 * seg);
    dequant16<true, 1>(raw.code[0], raw.sc[1][0], raw.sc[1][1],
                       Bs + (r + 32) * BPAD + 16 * seg);
  } else {
    dequant16<false, 0>(raw.code[0], raw.sc[0][0], raw.sc[0][1], Bs + r * BPAD + 16 * seg);
    dequant16<false, 0>(raw.code[1], raw.sc[1][0], raw.sc[1][1],
                        Bs + (r + 32) * BPAD + 16 * seg);
  }
}

// Activations of K step ks for rows [m0, m0 + BM) into As (cp.async).
template <bool Q4>
__device__ __forceinline__ void load_a(const __nv_bfloat16* x, __nv_bfloat16* As,
                                       int ks, int m0, int M, int K) {
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int idx = threadIdx.x + THREADS * i;
    const int row = idx >> 3, seg = idx & 7;
    int k;
    if (Q4) {
      const int sb = ks >> 2, j = ks & 3;
      k = 256 * sb + (seg < 4 ? 0 : 128) + 32 * j + 8 * (seg & 3);
    } else {
      k = BK * ks + 8 * seg;
    }
    const bool valid = m0 + row < M;
    const __nv_bfloat16* src = valid ? x + (size_t)(m0 + row) * K + k : x;
    cp_async16(As + row * APAD + 8 * seg, src, valid);
  }
}

// One BK-deep step of the warp's 64 x 32 tile: acc += A_s @ B_s on the
// tensor cores (m16 tiles mt and up are past M and skipped).
__device__ __forceinline__ void mma_step(const __nv_bfloat16* a_s, const __nv_bfloat16* b_s,
                                         int mt, float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t bfr[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, b_s + (16 * kk + (lane & 15)) * BPAD + 32 * wn + 16 * np +
                               8 * (lane >> 4));
      bfr[2 * np][0] = r[0];
      bfr[2 * np][1] = r[1];
      bfr[2 * np + 1][0] = r[2];
      bfr[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mi < mt) {
        uint32_t afr[4];
        ldmatrix_x4(afr, a_s + (64 * wm + 16 * mi + (lane & 15)) * APAD + 16 * kk +
                             8 * (lane >> 4));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], afr, bfr[ni][0], bfr[ni][1]);
      }
    }
  }
}

// The fused bias term of the grouped planes product (qmm_planes_g): acc +=
// bx[rows, :] @ bias over the K/32 groups, bx the bf16 per-32 sums of the
// tile's rows [M, KG] and bias bf16 [KG, Ns] (one expert's), both exact in
// the f32 products; BK groups a step, ragged ends zero-filled.
__device__ __forceinline__ void bias_steps(const __nv_bfloat16* bx,
                                           const __nv_bfloat16* bias, __nv_bfloat16* As,
                                           __nv_bfloat16* Bs, int m0, int M, int KG, int Ns,
                                           int col, bool col_ok, int mt,
                                           float (&acc)[4][4][4]) {
  const int r = threadIdx.x >> 3, seg = threadIdx.x & 7;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int kb = 0; kb < KG; kb += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int idx = threadIdx.x + THREADS * i;
      const int row = idx >> 3, sg = idx & 7;
      const bool valid = m0 + row < M && kb + 8 * sg < KG;
      const __nv_bfloat16* src = valid ? bx + (size_t)(m0 + row) * KG + kb + 8 * sg : bx;
      cp_async16(As + row * APAD + 8 * sg, src, valid);
    }
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = kb + r + 32 * h;
      const bool valid = col_ok && gr < KG;
      const uint4* src = reinterpret_cast<const uint4*>(bias + (size_t)gr * Ns + col);
      uint4* dst = reinterpret_cast<uint4*>(Bs + (r + 32 * h) * BPAD + 16 * seg);
      dst[0] = valid ? __ldg(src) : z;
      dst[1] = valid ? __ldg(src + 1) : z;
    }
    cp_async_wait_all();
    __syncthreads();
    mma_step(As, Bs, mt, acc);
    __syncthreads();
  }
}

// y is f32 [M, Ns], or bf16 [M, Ns] when BF16_OUT.
template <bool Q4, int G, bool BF16_OUT>
__global__ void __launch_bounds__(THREADS)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
                const __nv_bfloat16* __restrict__ sc, void* __restrict__ y,
                int M, int K, int Ns, const int* __restrict__ te,
                const __nv_bfloat16* __restrict__ bx, const __nv_bfloat16* __restrict__ bias) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][BM][APAD]
  __nv_bfloat16* Bs = As + 2 * A_STAGE;                              // [2][BK][BPAD]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (te != nullptr) {               // grouped: row tile blockIdx.x on expert te[.]
    const int e = __ldg(te + blockIdx.x);
    qs += (size_t)e * (Q4 ? K / 2 : K) * Ns;
    sc += (size_t)e * (K / G) * Ns;
    if (bias != nullptr) bias += (size_t)e * (K / 32) * Ns;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;          // warp tile: rows 64wm, cols 32wn
  const int col = n0 + 16 * (threadIdx.x & 7);      // this thread's 16 raw columns
  const bool col_ok = col < Ns;
  // m16 tiles of this warp that hold rows below M (warp-uniform)
  const int mt = min(4, max(0, (M - m0 - 64 * wm + 15) / 16));
  const int nk = K / BK;

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  Raw raw;
  load_a<Q4>(x, As, 0, m0, M, K);
  cp_async_commit();
  load_raw<Q4, G>(raw, qs, sc, 0, Ns, col, col_ok);
  store_tile<Q4>(raw, Bs);
  cp_async_wait_all();
  __syncthreads();

  for (int ks = 0; ks < nk; ++ks) {
    const int cur = ks & 1;
    const bool more = ks + 1 < nk;
    if (more) {
      load_a<Q4>(x, As + (cur ^ 1) * A_STAGE, ks + 1, m0, M, K);
      cp_async_commit();
      load_raw<Q4, G>(raw, qs, sc, ks + 1, Ns, col, col_ok);
    }
    mma_step(As + cur * A_STAGE, Bs + cur * B_STAGE, mt, acc);
    if (more) {
      store_tile<Q4>(raw, Bs + (cur ^ 1) * B_STAGE);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  if (bias != nullptr)
    bias_steps(bx, bias, As, Bs, m0, M, K / 32, Ns, col, col_ok, mt, acc);

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * wm + 16 * mi + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + 32 * wn + 8 * ni + 2 * q;
        if (c >= Ns) continue;
        const size_t o = (size_t)row * Ns + c;
        if (BF16_OUT)
          *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(y) + o) =
              pack_bf16x2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        else
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(y) + o) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

template <bool Q4, int G, bool BF16_OUT>
int launch_gemm(const void* x, const void* qs, const void* sc, void* y, int M, int K,
                int Ns, cudaStream_t st, const void* te = nullptr, const void* bx = nullptr,
                const void* bias = nullptr) {
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(qmm_gemm_kernel<Q4, G, BF16_OUT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((M + BM - 1) / BM, (Ns + BN - 1) / BN);
  qmm_gemm_kernel<Q4, G, BF16_OUT><<<grid, THREADS, SMEM_BYTES, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)qs, (const __nv_bfloat16*)sc, y, M, K, Ns,
      (const int*)te, (const __nv_bfloat16*)bx, (const __nv_bfloat16*)bias);
  return (int)cudaGetLastError();
}

}  // namespace
