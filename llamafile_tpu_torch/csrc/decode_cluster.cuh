// The cluster body shared by the decode kernels (flash_decode_write.cu,
// flash_decode.cu, paged_attention.cu): a 16-row K/V slab of 2-byte
// elements (bf16 or f16, the element type E) staged by cp.async and run on
// mma.sync (the bf16 and f16 dense caches), a 32-row slab run in f32 on
// the CUDA cores (the int8 and f32 dense caches, and every page type of the
// paged pool: int8, bf16, f16, f32), and the merge of a rank's warp
// partials pushed through distributed shared memory to the other ranks of
// its thread-block cluster.
//
// Each (batch row, kv head, head chunk) is one cluster of CS blocks (the
// ranks). Rank r takes the rows [rank_lo(r, n), rank_lo(r + 1, n)) of the
// n visible rows, each of its warps streams its own slabs through a ring in
// shared memory, and the warps' partials (m, l, acc) merge in warp order
// into the rank's; push_partials then sends (m, l) to every rank and acc's
// dims [r * D / CS, (r + 1) * D / CS) to rank r with st.async, counted on
// that rank's mbarrier. Every sum runs in a fixed order, so two launches on
// the same inputs give the same bits.
#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace dcl {

using namespace mma;

constexpr int RW = 16;               // rows of a bf16 slab: one warp's mma tile
constexpr int CS = 8;                // blocks a cluster (the portable size)
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

// The 2-byte element types of the mma slab: E's pair of a 32-bit word as
// f32, two f32 rounded to an E pair (nearest even), and the m16n8k16
// product of E operands with f32 accumulators.
template <typename E>
struct Elt;

template <>
struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float lo(uint32_t v) { return bf16_lo(v); }
  static __device__ __forceinline__ float hi(uint32_t v) { return bf16_hi(v); }
  static __device__ __forceinline__ uint32_t pack(float a, float b) { return pack_bf16x2(a, b); }
  static __device__ __forceinline__ __nv_bfloat16 round(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    mma_16816(c, a, b0, b1);
  }
};

template <>
struct Elt<__half> {
  static __device__ __forceinline__ float lo(uint32_t v) {
    return __half2float(__ushort_as_half((unsigned short)(v & 0xffffu)));
  }
  static __device__ __forceinline__ float hi(uint32_t v) {
    return __half2float(__ushort_as_half((unsigned short)(v >> 16)));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ __half round(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Elt<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
};

// first row of rank r of CS over n rows (testing.fdw_rank_ranges is the same rule)
__device__ __forceinline__ int rank_lo(int r, int n) {
  return (int)((long long)r * n / CS);
}

// rows j0 .. j0 + nr - 1 of K and V (row stride HD elements of the 2-byte
// E) into one slab [K rows | V rows] of row stride D + 8, by the 32 lanes
// of a warp; the slab's rows nr .. RW - 1 are zero-filled, so P.V over
// them adds 0
template <int D, typename E>
__device__ __forceinline__ void load_slab(E* slab, const E* kb, const E* vb, int j0, int nr,
                                          int HD) {
  static_assert(sizeof(E) == 2, "the mma slab holds 2-byte elements");
  constexpr int DP = D + 8, CH = D / 8;        // 16-byte chunks a row
  const int lane = threadIdx.x & 31, col = 8 * (lane % CH), r = lane / CH;
#pragma unroll
  for (int i = 0; i < RW; i += 32 / CH) {
    const int row = r + i;
    const bool ok = row < nr;
    const size_t off = (size_t)(j0 + (ok ? row : 0)) * HD + col;
    cp_async16(slab + row * DP + col, kb + off, ok);
    cp_async16(slab + (RW + row) * DP + col, vb + off, ok);
  }
}

// The TPU kernels' score softcap, s -> cap * tanh(s / cap), after the scale
// and before the mask; SC false leaves s as it is (no code).
template <bool SC>
__device__ __forceinline__ float soft_cap(float s, float cap) {
  if constexpr (SC) return cap * tanhf(s / cap);
  return s;
}

// One slab of a warp (nrw of its RW rows valid, the rest zero) on the
// tensor cores, "swap AB": the query heads are the n = 8 side of
// mma.m16n8k16, NTL tiles of 8. Scores S^T = K Q^T (K by ldmatrix, qb the
// q fragments rounded to E: head 8t + gq) times scale (then softcapped
// when SC), the slab's max and rescale of heads
// 8t + 2qd, 8t + 2qd + 1 (l summing the f32 p), then O^T += V^T P^T (V by
// ldmatrix.trans; p rounded to E, moved from the S^T accumulators into the
// B fragment by movmatrix.trans): acc[t][mt] holds dims 16mt + gq (+8) of
// those two heads. E is bf16 or f16: the same bytes, another rounding and
// product.
template <int D, int NTL, bool SC = false, typename E = __nv_bfloat16>
__device__ __forceinline__ void attend_slab(const E* ks, int nrw,
                                            const uint32_t (&qb)[NTL][D / 16][2], float scale,
                                            float (&m2)[NTL][2], float (&l2)[NTL][2],
                                            float (&acc)[NTL][D / 16][4], float cap = 0.f) {
  constexpr int DP = D + 8;
  const int lane = threadIdx.x & 31, gq = lane >> 2;
  const E* vs = ks + RW * DP;
  float c[NTL][2][4] = {};           // S^T: rows gq (+8), heads 2qd (+1); two chains
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, ks + (lane & 15) * DP + 16 * kk + 8 * (lane >> 4));
#pragma unroll
    for (int t = 0; t < NTL; ++t) Elt<E>::mma(c[t][kk & 1], a, qb[t][kk][0], qb[t][kk][1]);
  }
  const bool v0 = gq < nrw, v1 = gq + 8 < nrw;
  float pr[NTL][4], corr[NTL][2];
#pragma unroll
  for (int t = 0; t < NTL; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s0 = v0 ? soft_cap<SC>((c[t][0][j] + c[t][1][j]) * scale, cap) : NEG;
      const float s1 = v1 ? soft_cap<SC>((c[t][0][j + 2] + c[t][1][j + 2]) * scale, cap) : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m2[t][j], mx);
      corr[t][j] = expf(m2[t][j] - mn);
      pr[t][j] = v0 ? expf(s0 - mn) : 0.f;
      pr[t][j + 2] = v1 ? expf(s1 - mn) : 0.f;
      float rs = pr[t][j] + pr[t][j + 2];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l2[t][j] = l2[t][j] * corr[t][j] + rs;
      m2[t][j] = mn;
    }
  uint32_t pb[NTL][2];
#pragma unroll
  for (int t = 0; t < NTL; ++t) {
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      acc[t][mt][0] *= corr[t][0];
      acc[t][mt][1] *= corr[t][1];
      acc[t][mt][2] *= corr[t][0];
      acc[t][mt][3] *= corr[t][1];
    }
    // P^T as the B operand (k = row, n = head): rows 2qd (+1) and 8 + 2qd
    // (+1) of head gq, in E
    pb[t][0] = movmatrix_trans(Elt<E>::pack(pr[t][0], pr[t][1]));
    pb[t][1] = movmatrix_trans(Elt<E>::pack(pr[t][2], pr[t][3]));
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    uint32_t a[4];                   // V^T: dims 16mt.., the warp's 16 rows
    ldmatrix_x4_trans(a, vs + ((lane & 7) + 8 * (lane >> 4)) * DP + 16 * mt +
                             8 * ((lane >> 3) & 1));
#pragma unroll
    for (int t = 0; t < NTL; ++t) Elt<E>::mma(acc[t][mt], a, pb[t][0], pb[t][1]);
  }
}

// The warp's partial from attend_slab into the block's [NW][D][HP] acc
// (HP = 8 * NTL heads a dim) and its (m, l) of each head into wm, wl.
template <int D, int NTL, int HP>
__device__ __forceinline__ void store_warp_partial(float* wacc, float (*wm)[HP],
                                                   float (*wl)[HP], const float (&m2)[NTL][2],
                                                   const float (&l2)[NTL][2],
                                                   const float (&acc)[NTL][D / 16][4]) {
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, qd = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < NTL; ++t) {
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(wacc + (warp * D + 16 * mt + 8 * hf + gq) * HP + 8 * t +
                                   2 * qd) = make_float2(acc[t][mt][2 * hf], acc[t][mt][2 * hf + 1]);
    if (gq == 0) {
      wm[warp][8 * t + 2 * qd] = m2[t][0];
      wm[warp][8 * t + 2 * qd + 1] = m2[t][1];
      wl[warp][8 * t + 2 * qd] = l2[t][0];
      wl[warp][8 * t + 2 * qd + 1] = l2[t][1];
    }
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The start of a rank: thread 0 sets up the mbarrier that counts the
// `bytes` the other ranks push here, then every thread arrives on the
// cluster barrier that push_partials waits on before its first remote store.
__device__ __forceinline__ void rank_start(uint64_t* in_bar, uint32_t bytes) {
  if (threadIdx.x == 0) {
    mbar_init(in_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(in_bar, bytes);
  }
  cluster_arrive_relaxed();
}

// the shared::cluster address of p's counterpart in rank r's shared memory
__device__ __forceinline__ uint32_t map_rank(const void* p, int r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(r));
  return a;
}

// stores into another rank's shared memory that count their bytes on its
// mbarrier `bar` when they land
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// The bytes every rank receives from push_partials<D, HP, GPU, ...>.
template <int D, int HP, int GPU>
__host__ __device__ constexpr uint32_t pushed_bytes() {
  return CS * (2 * HP + GPU * (D / CS)) * 4;
}

// The rank's partial from its NW warps' (wm, wl [NW][HP], wacc [NW][D][HP]),
// merged in warp order, pushed to the cluster: (m, l) of the HP heads to
// every rank at m_in, l_in [CS][HP], and dims [r * DL, (r + 1) * DL) of acc,
// heads 0 .. GPU - 1 (GPU % 4 == 0, GPU <= HP), to rank r at acc_in
// [CS][DL][HP]. (Every dim merges all HP heads: at GPU = 4 of HP = 8 that
// keeps flash_decode_write's registers and times of its own merge.) Call
// after a block barrier that follows the warps' stores; the caller then
// waits on its own in_bar for what the ranks pushed to it.
template <int D, int NW, int HP, int GPU>
__device__ __forceinline__ void push_partials(const float* wacc, const float (*wm)[HP],
                                              const float (*wl)[HP], float (*wf)[HP],
                                              float* m_in, float* l_in, float* acc_in,
                                              uint64_t* in_bar, int rank) {
  constexpr int DL = D / CS;
  const int tid = threadIdx.x;
  cluster_wait();                      // every rank has started: remote stores may begin
  if (tid < HP) {                      // head g: the warps' weights, in warp order
    const int g = tid;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w][g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w][g] - mx);
      wf[w][g] = f;
      L += wl[w][g] * f;
    }
    for (int r = 0; r < CS; ++r) {     // (m, l) of head g to every rank
      const uint32_t bar = map_rank(in_bar, r);
      st_async(map_rank(m_in + rank * HP + g, r), mx, bar);
      st_async(map_rank(l_in + rank * HP + g, r), L, bar);
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += NW * 32) {   // dim d of the rank's acc to rank d / DL
    float a[HP];
#pragma unroll
    for (int g = 0; g < HP; ++g) a[g] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < HP / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(wacc + (w * D + d) * HP + 4 * i);
        a[4 * i] += x.x * wf[w][4 * i];
        a[4 * i + 1] += x.y * wf[w][4 * i + 1];
        a[4 * i + 2] += x.z * wf[w][4 * i + 2];
        a[4 * i + 3] += x.w * wf[w][4 * i + 3];
      }
    const int r = d / DL;
    const uint32_t bar = map_rank(in_bar, r);
    const uint32_t dst = map_rank(acc_in + (rank * DL + d % DL) * HP, r);
#pragma unroll
    for (int i = 0; i < GPU / 4; ++i)
      st_async(dst + 16 * i, make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]),
               bar);
  }
}

// ---- The f32 slab of flash_decode's int8 and f32 forms, of
// flash_decode_write's f32 form and of paged_attention ----
// RQ rows of K and V (int8 codes with their f32 scales, bf16, f16 or f32)
// staged in shared memory, computed on in f32 on the CUDA cores: lane i
// takes row i's scores for every head against q in shared memory
// (broadcast reads, no shuffle in the dot), the slab's max is a warp
// reduction a head, and in P.V lane i owns dims [i * D / 32, (i + 1) * D /
// 32) of every head, each K and V element converted to f32 once.

constexpr int RQ = 32;               // rows of an f32 slab: one a lane

// g heads rounded up to 4 (float4 rows)
__host__ __device__ constexpr int heads4(int g) { return g < 4 ? 4 : g; }

// The byte stride of an f32 slab's rows of D elements of T: 16 bytes past
// the row, so that 32 lanes reading 32 rows hit distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int slab_stride() {
  return D * (int)sizeof(T) + 16;
}

// A slab's bytes: K rows | V rows | int8 only: K scales | V scales (f32).
template <typename T, int D>
__host__ __device__ constexpr int slab_bytes() {
  return 2 * RQ * slab_stride<T, D>() + (sizeof(T) == 1 ? 2 * RQ * 4 : 0);
}

// 4-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// rows j0 .. j0 + nr - 1 of a dense cache's K and V (row stride HD
// elements of T) and, for int8, of their scales (row stride Hkv floats)
// into one f32 slab; rows nr .. RQ - 1 are zero-filled (scales too), so
// P.V over them adds 0
template <typename T, int D>
__device__ __forceinline__ void load_slab_rows(unsigned char* slab, const T* kb, const T* vb,
                                               const float* ksb, const float* vsb, int j0,
                                               int nr, int HD, int Hkv) {
  constexpr int KS = slab_stride<T, D>(), RB = D * (int)sizeof(T), CH = RB / 16;
  const int lane = threadIdx.x & 31;
  const unsigned char* kc = reinterpret_cast<const unsigned char*>(kb);
  const unsigned char* vc = reinterpret_cast<const unsigned char*>(vb);
#pragma unroll
  for (int it = 0; it < RQ * CH / 32; ++it) {
    const int i = lane + 32 * it, row = i / CH, col = 16 * (i % CH);
    const bool ok = row < nr;
    const size_t off = (size_t)(j0 + (ok ? row : 0)) * HD * sizeof(T) + col;
    cp_async16(slab + row * KS + col, kc + off, ok);
    cp_async16(slab + (RQ + row) * KS + col, vc + off, ok);
  }
  if constexpr (sizeof(T) == 1) {
    const bool ok = lane < nr;
    const size_t so = (size_t)(j0 + (ok ? lane : 0)) * Hkv;
    float* sc = reinterpret_cast<float*>(slab + 2 * RQ * KS);
    cp_async4(sc + lane, ksb + so, ok);
    cp_async4(sc + RQ + lane, vsb + so, ok);
  }
}

// the 2-byte pair of w (bf16 or f16) as f32
template <typename T>
__device__ __forceinline__ void pair_f32(uint32_t w, float* f) {
  if constexpr (std::is_same<T, __half>::value) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = x.x;
    f[1] = x.y;
  } else {
    f[0] = bf16_lo(w);
    f[1] = bf16_hi(w);
  }
}

// The four int8 codes packed in w as f32, exactly: each byte, offset to
// unsigned, becomes the low mantissa byte of 2^23 (one prmt), and 2^23 +
// 128 comes off (one add). A cvt from an integer runs at 1/8 of the f32
// rate on this card.
__device__ __forceinline__ void codes4(int w, float* f) {
  const uint32_t u = (uint32_t)w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// One f32 slab of a warp (nrw of its RQ rows valid; rows past them zero)
// of T = int8_t (codes times their row's scale), __nv_bfloat16, __half or
// float (each element as it is, in f32): the
// scores of row `lane` for heads 0 .. GP - 1 (q_s [GP][D] f32, heads past
// the chunk zero) times scale (then softcapped when SC), the slab's max and
// rescale of each head, p
// into the warp's rows p_s [RQ][PS], then acc[g][e] += p * v over the valid
// rows for dims D / 32 * lane + e. lp: this lane's share of l (the lanes'
// sum is l).
template <typename T, int D, int GP, bool SC = false>
__device__ __forceinline__ void attend_slab_f32(const unsigned char* slab, int nrw,
                                                const float* q_s, float* p_s, float scale,
                                                float (&m)[GP], float (&lp)[GP],
                                                float (&acc)[GP][D / 32], float cap = 0.f) {
  constexpr bool Q8 = sizeof(T) == 1, H2 = sizeof(T) == 2;
  constexpr int KS = slab_stride<T, D>(), DPL = D / 32, PS = heads4(GP);
  constexpr int EC = 16 / (int)sizeof(T);      // elements a 16-byte chunk
  const int lane = threadIdx.x & 31;
  const unsigned char* kc = slab;
  const unsigned char* vc = kc + RQ * KS;
  const float* ksc = reinterpret_cast<const float*>(vc + RQ * KS);   // int8 only
  const float* vsc = ksc + RQ;
  float s0[GP], s1[GP];                // two chains a head
#pragma unroll
  for (int g = 0; g < GP; ++g) s0[g] = s1[g] = 0.f;
  const unsigned char* kr = kc + lane * KS;
  const float ksl = Q8 ? ksc[lane] : 1.f;
#pragma unroll
  for (int cc = 0; cc < D / EC; ++cc) {
    const int4 raw = *reinterpret_cast<const int4*>(kr + 16 * cc);
    float kf[EC];
    if constexpr (H2) {
      const uint32_t wd[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z,
                              (uint32_t)raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) pair_f32<T>(wd[i], kf + 2 * i);
    } else if constexpr (!Q8) {
      kf[0] = __int_as_float(raw.x);
      kf[1] = __int_as_float(raw.y);
      kf[2] = __int_as_float(raw.z);
      kf[3] = __int_as_float(raw.w);
    } else {
      codes4(raw.x, kf);
      codes4(raw.y, kf + 4);
      codes4(raw.z, kf + 8);
      codes4(raw.w, kf + 12);
#pragma unroll
      for (int e = 0; e < 16; ++e) kf[e] *= ksl;
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float4* qv = reinterpret_cast<const float4*>(q_s + g * D + EC * cc);
#pragma unroll
      for (int i = 0; i < EC / 4; ++i) {
        const float4 x = qv[i];
        s0[g] = fmaf(x.x, kf[4 * i], s0[g]);
        s1[g] = fmaf(x.y, kf[4 * i + 1], s1[g]);
        s0[g] = fmaf(x.z, kf[4 * i + 2], s0[g]);
        s1[g] = fmaf(x.w, kf[4 * i + 3], s1[g]);
      }
    }
  }
  const bool ok = lane < nrw;
  float corr[GP];
  float* prow = p_s + lane * PS;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    const float sc = ok ? soft_cap<SC>((s0[g] + s1[g]) * scale, cap) : NEG;
    float mx = sc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m[g], mx);
    corr[g] = expf(m[g] - mn);
    const float pg = ok ? expf(sc - mn) : 0.f;
    lp[g] = lp[g] * corr[g] + pg;
    m[g] = mn;
    prow[g] = pg;
  }
#pragma unroll
  for (int g = GP; g < PS; ++g) prow[g] = 0.f;
  __syncwarp();                        // every row's p is in p_s
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] *= corr[g];
  const unsigned char* vcol = vc + DPL * lane * (int)sizeof(T);
#pragma unroll 2
  for (int r = 0; r < nrw; ++r) {
    float vf[DPL];
    if constexpr (H2) {
      if constexpr (DPL == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(vcol + r * KS);
        pair_f32<T>(w.x, vf);
        pair_f32<T>(w.y, vf + 2);
      } else {
        const uint4 w = *reinterpret_cast<const uint4*>(vcol + r * KS);
        const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) pair_f32<T>(wd[i], vf + 2 * i);
      }
    } else if constexpr (!Q8) {
#pragma unroll
      for (int i = 0; i < DPL / 4; ++i) {
        const float4 w = reinterpret_cast<const float4*>(vcol + r * KS)[i];
        vf[4 * i] = w.x;
        vf[4 * i + 1] = w.y;
        vf[4 * i + 2] = w.z;
        vf[4 * i + 3] = w.w;
      }
    } else {
      const float vsr = vsc[r];
      if constexpr (DPL == 4) {
        codes4(*reinterpret_cast<const int*>(vcol + r * KS), vf);
      } else {
        const int2 w = *reinterpret_cast<const int2*>(vcol + r * KS);
        codes4(w.x, vf);
        codes4(w.y, vf + 4);
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) vf[e] *= vsr;
    }
    float pv[PS];
#pragma unroll
    for (int i = 0; i < PS / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p_s + r * PS)[i];
      pv[4 * i] = x.x;
      pv[4 * i + 1] = x.y;
      pv[4 * i + 2] = x.z;
      pv[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pv[g], vf[e], acc[g][e]);
  }
}

// The f32 warp's partial into the block's [NW][D][HP] acc and its (m, l)
// of each head into wm, wl (heads GP .. HP - 1 neutral).
template <int D, int GP, int HP>
__device__ __forceinline__ void store_warp_partial_f32(float* wacc, float (*wm)[HP],
                                                       float (*wl)[HP], const float (&m)[GP],
                                                       float (&lp)[GP],
                                                       const float (&acc)[GP][D / 32]) {
  constexpr int DPL = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lp[g] += __shfl_xor_sync(0xffffffffu, lp[g], off);
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    float* row = wacc + (warp * D + DPL * lane + e) * HP;
#pragma unroll
    for (int i = 0; i < HP / 4; ++i) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = 4 * i + j < GP ? acc[(4 * i + j) % GP][e] : 0.f;
      *reinterpret_cast<float4*>(row + 4 * i) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < HP; ++g) {
      wm[warp][g] = g < GP ? m[g % GP] : NEG;
      wl[warp][g] = g < GP ? lp[g % GP] : 0.f;
    }
}

// The last step of a rank, after push_partials and the wait on its in_bar:
// dims [rank * DL, (rank + 1) * DL) of heads 0 .. gn - 1 merged over the CS
// rank partials in rank order, out[(qh0 + g) * D + d] = acc / max(l, 1e-30);
// output o = (g, dl), the weights of head g computed by each of its threads.
template <int D, int HP, int NT>
__device__ __forceinline__ void merge_ranks(float* out, size_t qh0, int gn, const float* m_in,
                                            const float* l_in, const float* acc_in,
                                            int rank) {
  constexpr int DL = D / CS;
  for (int o = threadIdx.x; o < gn * DL; o += NT) {
    const int g = o / DL, dl = o % DL, d = rank * DL + dl;
    float mr[CS], mx = NEG;
#pragma unroll
    for (int r = 0; r < CS; ++r) {
      mr[r] = m_in[r * HP + g];
      mx = fmaxf(mx, mr[r]);
    }
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int r = 0; r < CS; ++r) {
      const float w = expf(mr[r] - mx);
      L += l_in[r * HP + g] * w;
      a += acc_in[(r * DL + dl) * HP + g] * w;
    }
    out[(qh0 + g) * D + d] = a / fmaxf(L, 1e-30f);
  }
}

}  // namespace dcl
