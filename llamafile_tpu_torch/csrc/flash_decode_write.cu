// flash_decode_write: T=1 GQA attention over the layer-stacked flat bf16 KV
// cache [L, B, S, Hkv*D], with the new token's K/V row written in place.
//
// Replaces the TPU kernel _flash_decode_write_kernel
// (llamafile_tpu/ops/attention.py:217), called by flash_decode_write_stacked
// (:317). Numerics kept from it: q rounded to bf16; scores in f32 times
// `scale`; p rounded to bf16 before P.V while l sums the f32 p; cache rows
// j <= pos-1 and j < s_eff are streamed (the stale row at pos is excluded)
// and the new token, whose k/v arrive in f32, is merged last; the output is
// divided by max(l, 1e-30). Its new K/V land as bf16 at [li, b, pos] in the
// cache tensor itself.
//
// What bounds it on an H100: device-memory bytes of the visible cache rows,
// 2 * n_vis * Hkv * D * 2 bytes a layer (2.9 MB at llama3-8b widths and
// pos 700); the arithmetic is about 2 flops a byte, far under the ridge.
// One block per (batch row, kv head) would be 8 blocks at B = 1, Hkv = 8: 8
// of the 132 SMs, each bound by the latency of its own loads. So each
// (b, h, head chunk) is one thread-block cluster of CS = 8 blocks (64
// blocks at B = 1, G <= 8), all in one launch, with no scratch in device
// memory:
// - rank r takes the rows [r * n_vis / CS, (r + 1) * n_vis / CS), n_vis =
//   min(pos, s_eff): a split fixed by (n_vis, CS) alone, and every sum
//   below runs in a fixed order, so the result is the same from run to run;
//   a rank with no rows leaves the neutral partial m = -1e30, l = 0;
// - warp w of a rank streams the 16-row slabs w, w + NW, ... of its rows
//   through its own ring of NS slots in shared memory, cp.async 16 bytes a
//   lane (rows past the end zero-filled), NS slabs in flight from the
//   start; the warps need no block barrier while they stream;
// - a slab runs on the tensor cores, "swap AB" so that the GC <= 8 query
//   heads of a chunk are the n = 8 side of mma.sync.m16n8k16 (columns
//   GC..7 zero, never stored): S^T = K Q^T
//   (K by ldmatrix, q rounded to bf16 in registers), one max and one
//   rescale of acc a slab and head (the TPU kernel's per-block online
//   softmax), then O^T += V^T P^T (V by ldmatrix.trans; bf16 p moved from
//   the S^T accumulators into the B fragment by movmatrix.trans). Every
//   K/V row loaded serves the chunk's heads;
// - the warps' partials merge in warp order into the rank's (m, l, acc);
//   the rank then pushes (m, l) to every rank and acc's dims [r * D / CS,
//   (r + 1) * D / CS) to rank r, with st.async into that rank's shared
//   memory, counted on its mbarrier; rank r waits for the CS pushes, merges
//   its dims over the ranks in rank order, the new token last, and writes
//   them to out and, in chunk 0 only, into the new K/V row (no visible row
//   is the row at pos, so no chunk reads it). A cluster barrier at the
//   start (arrived at once, waited on before the first push) makes sure
//   every rank has started and set up its mbarrier; no rank reads another's
//   shared memory, so none has to wait for the others before it exits.
// A group of G <= 8 query heads is one chunk, an instance of its own (GC =
// G, a constant: nothing masked); a larger group runs as NC = ceil(G / 8)
// chunks of GC = ceil(G / NC) heads, one cluster each on
// the grid's y axis beside the KV head (the last chunk masks heads past G),
// each reading the K/V rows again.
// Clusters of 8 blocks are the portable size; 16 (non-portable) read slower
// on an H100 at every context length measured (PERF.md).
// The window and softcap options of the TPU kernel are not in this kernel;
// its wrapper raises for them (llama3 uses neither).
// llamafile_tpu_torch/testing.py mirrors CS, RW, NW and rank_lo in its
// emulation of this schedule (fdw_split_emulate): change both together.
#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma;

constexpr int D = 128;
constexpr int DP = D + 8;            // padded row stride: conflict-free ldmatrix
constexpr int NW = 4;                // warps a block
constexpr int NT = NW * 32;
constexpr int RW = 16;               // rows of a slab: one warp's tile
constexpr int NS = 3;                // slabs in flight a warp
constexpr int SLAB = 2 * RW * DP;    // bf16 elements of a slab: K rows, then V rows
constexpr int HN = 8;                // query heads a group, padded: the mma's n
constexpr int CS = 8;                // blocks a cluster: one cluster per (batch row, kv head)
constexpr int DL = D / CS;           // output dims each rank merges
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

// first row of rank r of CS over n rows (testing.fdw_rank_ranges is the same rule)
__device__ __forceinline__ int rank_lo(int r, int n) {
  return (int)((long long)r * n / CS);
}

// rows j0 .. j0 + nr - 1 of this rank's K and V slices into one slab, by
// the 32 lanes of a warp; the slab's rows nr .. RW - 1 are zero-filled, so
// P.V over them adds 0
__device__ __forceinline__ void load_slab(__nv_bfloat16* slab, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int j0, int nr, int HD) {
  constexpr int CH = D / 8;          // 16-byte chunks a row
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

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
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

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One slab of a warp (nrw of its RW rows valid, the rest zero): scores
// S^T = K Q^T, the slab's max and rescale of heads 2qd, 2qd + 1, then
// O^T += V^T P^T.
__device__ __forceinline__ void attend_slab(const __nv_bfloat16* ks, int nrw,
                                            const uint32_t (&qb)[D / 16][2], float scale,
                                            float (&m2)[2], float (&l2)[2],
                                            float (&acc)[D / 16][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2;
  const __nv_bfloat16* vs = ks + RW * DP;
  float c[2][4] = {};                // S^T: rows gq (+8), heads 2qd (+1); two chains
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, ks + (lane & 15) * DP + 16 * kk + 8 * (lane >> 4));
    mma_16816(c[kk & 1], a, qb[kk][0], qb[kk][1]);
  }
  const bool v0 = gq < nrw, v1 = gq + 8 < nrw;
  float pr[4], corr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float s0 = v0 ? (c[0][j] + c[1][j]) * scale : NEG;
    const float s1 = v1 ? (c[0][j + 2] + c[1][j + 2]) * scale : NEG;
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

// shared memory: each warp's ring of NS slabs (after the loop: the warps'
// acc [NW][D][HN]) | the rank partials pushed here: m, l [CS][HN] and
// acc [CS][DL][HN]
constexpr int SMEM = NW * NS * SLAB * 2 + (2 * CS * HN + D * HN) * 4;

// GC: query heads a chunk (compile time); G: the group, Hq = Hkv * G;
// ONE: the group is one chunk (G = GC <= 8), so G and the chunk are
// known at compile time and no head is masked
template <int GC, bool ONE>
__global__ void __launch_bounds__(NT)
fdw_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ k3,
           __nv_bfloat16* __restrict__ v3, const float* __restrict__ kn,
           const float* __restrict__ vn, const int* __restrict__ pos,
           float* __restrict__ out, int li, int B, int S, int Hkv, int G, int s_eff,
           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* rings = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* m_in = reinterpret_cast<float*>(rings + NW * NS * SLAB);
  float* l_in = m_in + CS * HN;
  float* acc_in = l_in + CS * HN;
  __shared__ float wm[NW][HN], wl[NW][HN], wf[NW][HN];
  __shared__ float sn_t[HN], vn_t[D];
  __shared__ __align__(8) uint64_t in_bar;   // the partials pushed here have landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int GP = GC > 4 ? HN : 4;  // heads pushed a dim
  if (threadIdx.x == 0) {              // every rank sends (m, l) of HN heads and GP x DL acc
    mbar_init(&in_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&in_bar, CS * (2 * HN + GP * DL) * 4);
  }
  cluster_arrive_relaxed();            // waited on before the first remote store
  if (ONE) G = GC;
  const int b = blockIdx.z;
  const int c = ONE ? 0 : blockIdx.y / Hkv, h = blockIdx.y - c * Hkv;   // head chunk, KV head
  const int gn = min(GC, G - c * GC);  // the chunk's heads below G
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, qd = lane & 3;
  const int HD = Hkv * D;
  // query head of the chunk's head 0: heads h * G + c * GC + g, g < gn
  const size_t qh0 = (size_t)b * Hkv * G + (size_t)h * G + c * GC;
  const int p = pos[b];
  const int n_vis = max(0, min(p, s_eff));
  const int lo = rank_lo(rank, n_vis);
  const int n = rank_lo(rank + 1, n_vis) - lo;
  // warp w takes the slabs w, w + NW, ... of the rank's rows
  const int n_slabs = (n + RW - 1) / RW;
  const int nk = n_slabs > warp ? (n_slabs - warp + NW - 1) / NW : 0;
  const size_t row0 = ((size_t)li * B + b) * S;
  const __nv_bfloat16* kb = k3 + (row0 + lo) * HD + h * D;
  const __nv_bfloat16* vb = v3 + (row0 + lo) * HD + h * D;
  __nv_bfloat16* ring = rings + warp * NS * SLAB;

#pragma unroll
  for (int k = 0; k < NS; ++k) {       // the warp's first NS slabs in flight at once
    const int j0 = RW * (warp + NW * k);
    if (k < nk) load_slab(ring + k * SLAB, kb, vb, j0, min(RW, n - j0), HD);
    cp_async_commit();
  }
  // this rank's dims of the new token's k and v, for the merge and the row write
  float kn_d = 0.f, vn_d = 0.f;
  if (tid < DL) {
    kn_d = kn[(size_t)b * HD + h * D + rank * DL + tid];
    vn_d = vn[(size_t)b * HD + h * D + rank * DL + tid];
    vn_t[tid] = vn_d;
  }

  // q as the B operand (k = dim, n = head): head gq, dims 16kk + 2qd (+8),
  // rounded to bf16; heads gn..7 are zero (and not read)
  uint32_t qb[D / 16][2];
  const float* qr = q + (qh0 + min(gq, gn - 1)) * D + 2 * qd;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qb[kk][0] = gq < gn ? pack_bf16x2(qr[16 * kk], qr[16 * kk + 1]) : 0u;
    qb[kk][1] = gq < gn ? pack_bf16x2(qr[16 * kk + 8], qr[16 * kk + 9]) : 0u;
  }
  if (warp == 0) {                     // the new token's scores, from its f32 k
    const float* kr = kn + (size_t)b * HD + h * D + 2 * qd;
    float sc = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sc += bf16_lo(qb[kk][0]) * kr[16 * kk] + bf16_hi(qb[kk][0]) * kr[16 * kk + 1] +
            bf16_lo(qb[kk][1]) * kr[16 * kk + 8] + bf16_hi(qb[kk][1]) * kr[16 * kk + 9];
    sc += __shfl_xor_sync(0xffffffffu, sc, 1);
    sc += __shfl_xor_sync(0xffffffffu, sc, 2);
    if (qd == 0) sn_t[gq] = sc * scale;
  }

  // this warp's online softmax of heads 2qd, 2qd + 1, and O^T: acc[mt] holds
  // dims 16mt + gq (+8) of those two heads. Each warp streams its own slabs:
  // no block barrier in the loop.
  float m2[2] = {NEG, NEG}, l2[2] = {0.f, 0.f};
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<NS - 1>();           // slab k has landed (this lane's part)
    __syncwarp();                      // and every lane's
    const int j0 = RW * (warp + NW * k);
    attend_slab(ring + (k % NS) * SLAB, min(RW, n - j0), qb, scale, m2, l2, acc);
    __syncwarp();                      // the slot is free again
    const int jn = RW * (warp + NW * (k + NS));
    if (k + NS < nk) load_slab(ring + (k % NS) * SLAB, kb, vb, jn, min(RW, n - jn), HD);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                     // every warp is done: the rings are free

  // the rank's partial: the warps' merged in warp order
  float* wacc = reinterpret_cast<float*>(rings);                   // [NW][D][HN]
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(wacc + (warp * D + 16 * mt + 8 * hf + gq) * HN + 2 * qd) =
          make_float2(acc[mt][2 * hf], acc[mt][2 * hf + 1]);
  if (gq == 0) {
    wm[warp][2 * qd] = m2[0];
    wm[warp][2 * qd + 1] = m2[1];
    wl[warp][2 * qd] = l2[0];
    wl[warp][2 * qd + 1] = l2[1];
  }
  __syncthreads();
  cluster_wait();                      // every rank has started: remote stores may begin
  if (tid < HN) {                      // head g: the warps' weights, in warp order
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
      const uint32_t bar = map_rank(&in_bar, r);
      st_async(map_rank(m_in + rank * HN + g, r), mx, bar);
      st_async(map_rank(l_in + rank * HN + g, r), L, bar);
    }
  }
  __syncthreads();
  if (tid < D) {                       // dim tid of the rank's acc to rank tid / DL
    const int d = tid;
    float a[HN];
#pragma unroll
    for (int g = 0; g < HN; ++g) a[g] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 x0 = *reinterpret_cast<const float4*>(wacc + (w * D + d) * HN);
      const float4 x1 = *reinterpret_cast<const float4*>(wacc + (w * D + d) * HN + 4);
      a[0] += x0.x * wf[w][0];
      a[1] += x0.y * wf[w][1];
      a[2] += x0.z * wf[w][2];
      a[3] += x0.w * wf[w][3];
      a[4] += x1.x * wf[w][4];
      a[5] += x1.y * wf[w][5];
      a[6] += x1.z * wf[w][6];
      a[7] += x1.w * wf[w][7];
    }
    const int r = d / DL;
    const uint32_t bar = map_rank(&in_bar, r);
    const uint32_t dst = map_rank(acc_in + (rank * DL + d % DL) * HN, r);
    st_async(dst, make_float4(a[0], a[1], a[2], a[3]), bar);
    if (GC > 4) st_async(dst + 16, make_float4(a[4], a[5], a[6], a[7]), bar);
  }
  mbar_wait(&in_bar, 0);               // every rank's partial has landed here

  // merge dims [rank * DL, (rank + 1) * DL) over the CS rank partials in rank
  // order, the new token last; output o = (g, dl), the weights of head g
  // computed by each of its threads
  for (int o = tid; o < gn * DL; o += NT) {
    const int g = o / DL, dl = o % DL, d = rank * DL + dl;
    float mr[CS], mx = sn_t[g];
#pragma unroll
    for (int r = 0; r < CS; ++r) {
      mr[r] = m_in[r * HN + g];
      mx = fmaxf(mx, mr[r]);
    }
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int r = 0; r < CS; ++r) {
      const float w = expf(mr[r] - mx);
      L += l_in[r * HN + g] * w;
      a += acc_in[(r * DL + dl) * HN + g] * w;
    }
    const float pn = expf(sn_t[g] - mx);
    out[(qh0 + g) * D + d] = (a + pn * vn_t[dl]) / fmaxf(L + pn, 1e-30f);
  }
  if (c == 0 && tid < DL && p < S) {   // this rank's dims of the new row, in place, once
    const size_t o = (row0 + p) * HD + h * D + rank * DL + tid;
    k3[o] = __float2bfloat16_rn(kn_d);
    v3[o] = __float2bfloat16_rn(vn_d);
  }
}

// fdw_kernel<GC, ONE>'s launch: a cluster of CS blocks a (batch row, kv head,
// head chunk). Its shared-memory limit is set once, so that later launches
// can be captured in a CUDA graph.
template <int GC, bool ONE>
int launch(const void* q, void* k3, void* v3, const void* kn, const void* vn,
           const void* pos, void* out, int li, int B, int S, int Hkv, int G, int s_eff,
           float scale, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fdw_kernel<GC, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, Hkv * ((G + GC - 1) / GC), B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fdw_kernel<GC, ONE>, (const float*)q, (__nv_bfloat16*)k3, (__nv_bfloat16*)v3,
      (const float*)kn, (const float*)vn, (const int*)pos, (float*)out, li, B, S, Hkv, G,
      s_eff, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// G = Hq / Hkv <= 8 is one chunk of G heads, a larger group ceil(G / 8)
// chunks of gc = ceil(G / ceil(G / 8)) heads, 5 <= gc <= 8.
extern "C" int flash_decode_write(const void* q, void* k3, void* v3,
                                  const void* kn, const void* vn,
                                  const void* pos, void* out, int li, int B,
                                  int S, int Hq, int Hkv, int s_eff,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq < Hkv || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv, nc = (G + 7) / 8, gc = (G + nc - 1) / nc;
#define FDW_CASE(L, N, ONE) \
  case L:                    \
    return launch<N, ONE>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, G, s_eff, scale, st);
  switch (G <= 8 ? G : -gc) {
    FDW_CASE(1, 1, true) FDW_CASE(2, 2, true) FDW_CASE(3, 3, true) FDW_CASE(4, 4, true)
    FDW_CASE(5, 5, true) FDW_CASE(6, 6, true) FDW_CASE(7, 7, true) FDW_CASE(8, 8, true)
    FDW_CASE(-5, 5, false) FDW_CASE(-6, 6, false) FDW_CASE(-7, 7, false) FDW_CASE(-8, 8, false)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FDW_CASE
}
