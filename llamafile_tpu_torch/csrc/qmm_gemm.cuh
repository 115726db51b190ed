// The bf16-dequant GEMM body shared by qmm_dequant.cu (f32 out, q4b and
// q8b), qmm_planes.cu (q4b, f32 or bf16 out) and qmm_planes_g.cu (grouped
// q4b with a fused bias term).
//
//   y[M, Ns] = x[M, K] bf16 @ W,  W[k, n] = bf16(code[k, n] * scale[k/g, n])
// The weight product is rounded once to bf16, as the TPU kernels' dequant
// multiplies in bf16 (_dequant_tile): both factors are exact bf16 values, so
// a bf16 multiply that rounds their exact product once gives the bits of
// __float2bfloat16_rn(code * scale). q4b codes are the planar nibbles (lo
// plane q, hi plane int8((p ^ 0x80) & 0xF0) = 16q - 128, the fold living in
// the stored scales); q8b codes are int8 with g 32 (Q8_0), 16 (Q6_K) or 8
// (IQ1_M).
// Accumulation is f32; the epilogue writes f32, or rounds each sum once to
// bf16.
//
// Design (Hopper): 128 x 128 output tiles, 256 threads as two warpgroups of
// 64 rows, each running wgmma.mma_async m64n128k16 (bf16 in, f32 out) from
// shared memory, four a 64-deep K step. The activations (A, K-major) and the
// raw codes and scales of the weights stream into two 3-stage rings in
// shared memory by cp.async, A two steps and the raw codes three steps
// ahead, one commit group a step; the weights are dequantized once a block
// and step into a 64 x 128 bf16 tile (B, n-contiguous, read as wgmma's
// MN-major operand; two stages), which both warpgroups read. A and B use the
// 128-byte swizzle (wgmma_bf16.cuh). In step ks the warpgroups issue their
// wgmmas on A ks and B ks, the threads issue the copies of A ks + 2 and raw
// ks + 3 and, while the tensor cores run, dequantize raw ks + 1 into the
// other B stage; then each warpgroup waits for its wgmmas and every thread
// for its copies but the newest group, and a proxy fence and a barrier
// publish the new stages. B is shared by both warpgroups, so a stage is
// rewritten only after both have waited for the wgmmas that read it. The
// dequant builds each code from its bits (dequant16), off the conversion
// pipe. A q4b K step is one "chunk": 32 packed rows give 32 lo-plane and 32
// hi-plane K rows (each packed byte is read once and feeds both planes), so
// the A tile takes the matching two 32-column runs of x (the even and odd
// 128-wide K chunks of each 256-superblock). The grid walks M fastest, so
// the M tiles of one column tile run together and share its weight reads in
// L2. Rows past M are zero-filled and never stored; a warpgroup whose 64
// rows all lie past M skips its wgmmas (it still dequantizes its share of
// B). Two blocks share an SM (at most 128 registers a thread, 109 KB of
// shared memory a block; 112 KB at q8b g 8, whose raw stages hold 8 scale
// rows). TMA loads, an mbarrier ring and warp specialisation are
// later steps.
#pragma once

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace mma;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;              // two warpgroups of 64 rows
constexpr int STAGES = 3;                 // ring of A tiles and of raw codes
constexpr int A_BYTES = BM * BK * 2;      // 128 rows of 128 bytes
constexpr int B_BYTES = BK * BN * 2;      // two 64-column halves of 64 rows
constexpr int RAW_SC = 8192;              // raw stage: codes, then scale rows
constexpr int B_BASE = STAGES * A_BYTES;                   // B tiles: 2 stages
constexpr int RAW_BASE = B_BASE + 2 * B_BYTES;             // raw stages
// Scale rows of a K step: q4b 2 (the lo and hi planes' groups), q8b BK / G.
template <bool Q4, int G>
constexpr int SC_ROWS = Q4 ? 2 : BK / G;
// A raw stage holds 4 scale rows of 256 bytes, or SC_ROWS when more (q8b
// g 8: 8), so every other instance keeps one stage size and one layout.
template <bool Q4, int G>
constexpr int RAW_BYTES_OF = RAW_SC + 256 * ((SC_ROWS<Q4, G>) > 4 ? (SC_ROWS<Q4, G>) : 4);
template <bool Q4, int G>
constexpr int SMEM_BYTES_OF = RAW_BASE + STAGES * RAW_BYTES_OF<Q4, G> + 1024;  // + alignment
static_assert(SMEM_BYTES_OF<true, 32> == 110592 && SMEM_BYTES_OF<false, 32> == 110592 &&
                  SMEM_BYTES_OF<false, 16> == 110592 && SMEM_BYTES_OF<false, 8> == 113664,
              "the q4b and q8b g 16 / 32 instances keep their 110592 bytes");

// Byte offset of 16-byte chunk c (8 bf16) of row `row` in the A tile.
__device__ __forceinline__ int a_off(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// Byte offset of columns 8c .. 8c + 7 (c < 16) of k row k in the B tile.
__device__ __forceinline__ int b_off(int k, int c) {
  return (c >> 3) * 8192 + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

// This thread's share of the dequantized tile: 16 columns at 16 * seg of
// the rows r and r + 32 (q4b: the lo and hi planes of packed row r). Each
// 8-thread phase of a warp's 16-byte stores covers rows r and r + 1, whose
// swizzles put the eight stores in eight distinct bank groups.
__device__ __forceinline__ int tile_row() {
  return 2 * (threadIdx.x >> 4) + ((threadIdx.x >> 2) & 1);
}
__device__ __forceinline__ int tile_seg() {
  return 4 * ((threadIdx.x >> 3) & 1) + (threadIdx.x & 3);
}

__device__ __forceinline__ void st16(unsigned char* p, uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// Byte offset of 16-byte chunk c of code row `row` in a raw stage: rows r
// and r + 1 swap their halves, so the eight 16-byte loads of a phase of
// store_tile hit eight distinct bank groups.
__device__ __forceinline__ int raw_off(int row, int c) {
  return row * 128 + ((c ^ ((row & 1) << 2)) << 4);
}

// cp.async the raw codes and scales of K step ks for columns [n0, n0 + 128)
// into the raw stage Rs: q4b 32 packed rows (lo and hi planes) and scale
// rows g_lo, g_hi; q8b 64 rows and their 64 / G scale rows. Columns past Ns
// are zero-filled.
template <bool Q4, int G>
__device__ __forceinline__ void load_raw(unsigned char* Rs, const uint8_t* qs,
                                         const __nv_bfloat16* sc, int ks, int Ns, int n0) {
  const int t = threadIdx.x;
  const int row = t >> 3, c = t & 7;
  const bool ok = n0 + 16 * c < Ns;
  const int sb = ks >> 2, j = ks & 3;
#pragma unroll
  for (int h = 0; h < (Q4 ? 1 : 2); ++h) {
    const int r = row + 32 * h;
    const int src_row = Q4 ? 128 * sb + 32 * j + r : BK * ks + r;
    const uint8_t* src = ok ? qs + (size_t)src_row * Ns + n0 + 16 * c : qs;
    cp_async16(Rs + raw_off(r, c), src, ok);
  }
  if (t < 16 * SC_ROWS<Q4, G>) {
    const int sr = t >> 4, sc8 = t & 15;
    const int g = Q4 ? 8 * sb + j + 4 * sr : (BK / G) * ks + sr;
    const bool sok = n0 + 8 * sc8 < Ns;
    const __nv_bfloat16* src = sok ? sc + (size_t)g * Ns + n0 + 8 * sc8 : sc;
    cp_async16(Rs + RAW_SC + 256 * sr + 16 * sc8, src, sok);
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 codes (the bytes of `code`) times 16 scales, each product rounded once
// to bf16: out[p] holds columns 2p (low half) and 2p + 1. Every code is
// built exactly from its bits, with no int-to-float conversion: a nibble q
// ORed into the mantissa of the bf16 128 (ulp 1) gives 128 + q, of the bf16
// 2048 (ulp 16) 2048 + 16 q, and one exact bf16 subtract leaves q (lo
// plane) or 16 q - 128 (hi plane); an int8 code c has 256 values, more
// than a bf16 mantissa holds, so it goes through the f32 2^23 (2^23 + 128 +
// c, less 2^23 + 128), whose low 16 bits are then zero: its high half is
// bf16(c). The bf16 multiply rounds the exact product once.
template <bool Q4, int PLANE>
__device__ __forceinline__ void dequant16(uint4 code, uint4 s0, uint4 s1, uint32_t (&out)[8]) {
  const uint32_t cw[4] = {code.x, code.y, code.z, code.w};
  const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t w = cw[p >> 1];
    __nv_bfloat162 c;
    if (Q4) {
      // bytes 2(p % 2) and 2(p % 2) + 1 into the low bytes of the two halves
      const uint32_t t = __byte_perm(PLANE == 0 ? w : w >> 4, 0, (p & 1) ? 0x4342 : 0x4140);
      const uint32_t magic = PLANE == 0 ? 0x43004300u : 0x45004500u;   // 128 | 2048
      c = __hsub2(as_bf162((t & 0x000F000Fu) | magic),
                  as_bf162(PLANE == 0 ? 0x43004300u : 0x45084508u));  // 128 | 2176
    } else {
      const uint32_t u = w ^ 0x80808080u;                                // c + 128
      const int i = 2 * (p & 1);
      const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388736.f;
      const float f1 =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | (i + 1))) - 8388736.f;
      c = as_bf162(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632));
    }
    out[p] = as_u32(__hmul2(c, as_bf162(sw[p])));
  }
}

// Dequantize this thread's share of the raw stage Rs into the B tile Bs.
template <bool Q4, int G>
__device__ __forceinline__ void store_tile(const unsigned char* Rs, unsigned char* Bs) {
  const int r = tile_row(), seg = tile_seg();
  const uint4* s = reinterpret_cast<const uint4*>(Rs + RAW_SC + 32 * seg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t o[8];
    const int sr = Q4 ? h : (r + 32 * h) / G;       // scale row of this K row
    const uint4 s0 = s[16 * sr], s1 = s[16 * sr + 1];
    if (Q4) {
      const uint4 code = *reinterpret_cast<const uint4*>(Rs + raw_off(r, seg));
      if (h == 0)
        dequant16<true, 0>(code, s0, s1, o);
      else
        dequant16<true, 1>(code, s0, s1, o);
    } else {
      const uint4 code = *reinterpret_cast<const uint4*>(Rs + raw_off(r + 32 * h, seg));
      dequant16<false, 0>(code, s0, s1, o);
    }
    st16(Bs + b_off(r + 32 * h, 2 * seg), o[0], o[1], o[2], o[3]);
    st16(Bs + b_off(r + 32 * h, 2 * seg + 1), o[4], o[5], o[6], o[7]);
  }
}

// Activations of K step ks for rows [m0, m0 + BM) into As (cp.async).
template <bool Q4>
__device__ __forceinline__ void load_a(const __nv_bfloat16* x, unsigned char* As, int ks,
                                       int m0, int M, int K) {
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
    cp_async16(As + a_off(row, seg), src, valid);
  }
}

// Issue one BK-deep step of warpgroup wg's 64 x 128 tile from the A and B
// tiles at shared addresses a and b: acc += A[64 wg .., :] @ B, four wgmmas
// in one commit group (not waited for here).
__device__ __forceinline__ void mma_stage(float (&acc)[64], uint32_t a, uint32_t b, int wg) {
  wgmma::fence_operands(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma::m64n128k16(acc, wgmma::desc_sw128(a + 8192 * wg + 32 * kk, 16, 1024),
                      wgmma::desc_sw128(b + 2048 * kk, 8192, 1024));
  wgmma::commit();
  wgmma::fence_operands(acc);
}

// Wait for this warpgroup's wgmmas, then for this thread's cp.async groups
// but the newest C; publish both kinds of shared-memory writes to the async
// proxy and meet at the block barrier.
template <int C>
__device__ __forceinline__ void end_step(float (&acc)[64]) {
  wgmma::wait<0>();
  wgmma::fence_operands(acc);
  cp_async_wait<C>();
  wgmma::fence_proxy_async();
  __syncthreads();
}

// The fused bias term of the grouped planes product (qmm_planes_g): acc +=
// bx[rows, :] @ bias over the K/32 groups, bx the bf16 per-32 sums of the
// tile's rows [M, KG] and bias bf16 [KG, Ns] (one expert's), both exact in
// the f32 products; BK groups a step on stage 0 (free once the main loop's
// last step has met at its barrier), ragged ends zero-filled.
__device__ __forceinline__ void bias_steps(const __nv_bfloat16* bx,
                                           const __nv_bfloat16* bias, unsigned char* smem,
                                           int m0, int M, int KG, int Ns, int n0,
                                           bool active, int wg, float (&acc)[64]) {
  const int r = tile_row(), seg = tile_seg();
  const int col = n0 + 16 * seg;     // this thread's 16 bias columns
  const bool col_ok = col < Ns;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int kb = 0; kb < KG; kb += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
      const int idx = threadIdx.x + THREADS * i;
      const int row = idx >> 3, sg = idx & 7;
      const bool valid = m0 + row < M && kb + 8 * sg < KG;
      const __nv_bfloat16* src = valid ? bx + (size_t)(m0 + row) * KG + kb + 8 * sg : bx;
      cp_async16(smem + a_off(row, sg), src, valid);
    }
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = kb + r + 32 * h;
      const bool valid = col_ok && gr < KG;
      const uint4* src = reinterpret_cast<const uint4*>(bias + (size_t)gr * Ns + col);
      const uint4 v0 = valid ? __ldg(src) : z, v1 = valid ? __ldg(src + 1) : z;
      st16(smem + B_BASE + b_off(r + 32 * h, 2 * seg), v0.x, v0.y, v0.z, v0.w);
      st16(smem + B_BASE + b_off(r + 32 * h, 2 * seg + 1), v1.x, v1.y, v1.z, v1.w);
    }
    end_step<0>(acc);                // stage 0 written and published
    if (active) mma_stage(acc, smem_addr(smem), smem_addr(smem + B_BASE), wg);
    end_step<0>(acc);                // and read before the next group rewrites it
  }
}

// y is f32 [M, Ns], or bf16 [M, Ns] when BF16_OUT.
template <bool Q4, int G, bool BF16_OUT>
__global__ void __launch_bounds__(THREADS, 2)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
                const __nv_bfloat16* __restrict__ sc, void* __restrict__ y,
                int M, int K, int Ns, const int* __restrict__ te,
                const __nv_bfloat16* __restrict__ bx, const __nv_bfloat16* __restrict__ bias) {
  constexpr int RAW_BYTES = RAW_BYTES_OF<Q4, G>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [A ring | B ring | raw ring], 1024-aligned for the swizzle
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (te != nullptr) {               // grouped: row tile blockIdx.x on expert te[.]
    const int e = __ldg(te + blockIdx.x);
    qs += (size_t)e * (Q4 ? K / 2 : K) * Ns;
    sc += (size_t)e * (K / G) * Ns;
    if (bias != nullptr) bias += (size_t)e * (K / 32) * Ns;
  }
  const int wg = threadIdx.x >> 7;                  // warpgroup: rows 64 wg ..
  const bool active = m0 + 64 * wg < M;             // warpgroup-uniform
  const int nk = K / BK;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // cp.async groups: the prologue's {A 0, raw 0, raw 1} and {A 1, raw 2},
  // then one a step ks: {A ks + 2, raw ks + 3} (empty past the end)
  unsigned char* raw_s = smem + RAW_BASE;
  load_a<Q4>(x, smem, 0, m0, M, K);
  load_raw<Q4, G>(raw_s, qs, sc, 0, Ns, n0);
  if (nk > 1) load_raw<Q4, G>(raw_s + RAW_BYTES, qs, sc, 1, Ns, n0);
  cp_async_commit();
  if (nk > 1) load_a<Q4>(x, smem + A_BYTES, 1, m0, M, K);
  if (nk > 2) load_raw<Q4, G>(raw_s + 2 * RAW_BYTES, qs, sc, 2, Ns, n0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  store_tile<Q4, G>(raw_s, smem + B_BASE);
  end_step<1>(acc);

  for (int ks = 0; ks < nk; ++ks) {
    if (active)
      mma_stage(acc, s0 + (ks % STAGES) * A_BYTES, s0 + B_BASE + (ks & 1) * B_BYTES, wg);
    if (ks + 2 < nk) load_a<Q4>(x, smem + ((ks + 2) % STAGES) * A_BYTES, ks + 2, m0, M, K);
    if (ks + 3 < nk) load_raw<Q4, G>(raw_s + (ks % STAGES) * RAW_BYTES, qs, sc, ks + 3, Ns, n0);
    cp_async_commit();
    // while the tensor cores run: step ks + 1's weights, dequantized
    if (ks + 1 < nk)
      store_tile<Q4, G>(raw_s + ((ks + 1) % STAGES) * RAW_BYTES,
                        smem + B_BASE + ((ks + 1) & 1) * B_BYTES);
    end_step<1>(acc);
  }
  if (bias != nullptr)
    bias_steps(bx, bias, smem, m0, M, K / 32, Ns, n0, active, wg, acc);

  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 64 * wg + 16 * w + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      if (c >= Ns) continue;
      const size_t o = (size_t)row * Ns + c;
      if (BF16_OUT)
        *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(y) + o) =
            pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(y) + o) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <bool Q4, int G, bool BF16_OUT>
int launch_gemm(const void* x, const void* qs, const void* sc, void* y, int M, int K,
                int Ns, cudaStream_t st, const void* te = nullptr, const void* bx = nullptr,
                const void* bias = nullptr) {
  constexpr int SMEM_BYTES = SMEM_BYTES_OF<Q4, G>;
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
