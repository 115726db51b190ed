// flash_decode_write: T=1 GQA attention over the layer-stacked flat bf16,
// f16 or f32 KV cache [L, B, S, Hkv*D], with the new token's K/V row
// written in place.
//
// Replaces the TPU kernel _flash_decode_write_kernel
// (llamafile_tpu/ops/attention.py:217), called by flash_decode_write_stacked
// (:317). Numerics kept from it: q rounded to the cache's dtype (bf16 or
// f16; an f32 cache rounds nothing); scores in f32 times
// `scale`, then, with the softcap option (cap > 0), cap * tanh(s / cap) in
// f32 (tanhf), the new token's score too; p rounded to the cache's dtype
// before P.V while l sums the f32 p; cache rows j <= pos-1 and j < s_eff
// are streamed
// (the stale row at pos is excluded), with the window option (win > 0)
// only those with j > pos - win, and the new token, whose k/v arrive in
// f32, is always visible and merged last; the output is divided by max(l,
// 1e-30). Its new K/V land rounded to the cache's dtype at [li, b, pos]
// in the cache tensor itself.
//
// What bounds it on an H100: device-memory bytes of the visible cache rows,
// 2 * n_vis * Hkv * D * 2 bytes a layer (2.9 MB at llama3-8b widths and
// pos 700; twice that for f32); the arithmetic is about 2 flops a byte,
// far under the ridge.
// One block per (batch row, kv head) would be 8 blocks at B = 1, Hkv = 8: 8
// of the 132 SMs, each bound by the latency of its own loads. So each
// (b, h, head chunk) is one thread-block cluster of CS = 8 blocks (64
// blocks at B = 1, G <= 8), all in one launch, with no scratch in device
// memory:
// - rank r takes the rows vis_lo + [r * n_vis / CS, (r + 1) * n_vis / CS)
//   of the visible range [vis_lo, min(pos, s_eff)), vis_lo = max(0, pos -
//   win + 1) under a window, else 0, n_vis its length (a window layer at
//   pos 6000 reads 4096 rows, not 6000): a split fixed by (n_vis, CS)
//   alone, and every sum
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
// each reading the K/V rows again. (The f16 and f32 caches: see dispatch.)
// Clusters of 8 blocks are the portable size; 16 (non-portable) read slower
// on an H100 at every context length measured (PERF.md).
// The head dim D is 128 or 256 (an instance each; the reference takes any
// D % 128 == 0): at 256 a row is 32 16-byte chunks, one lane's copy each,
// and a rank merges 32 dims, with two slabs in flight a warp (135,168
// bytes of shared memory; three would take 202,752).
// The slab load, the slab's product and softmax, and the rank's push are
// decode_cluster.cuh's, shared with flash_decode.cu. The cache's element
// type E is a template parameter: bf16 and f16 run the mma slab above
// (the same bytes, another rounding and product); f32 runs the f32 slab
// (attend_slab_f32, as flash_decode's int8 and f32 forms: 32 rows a slab,
// lane i row i's scores, each lane 4 or 8 dims of P.V, q and p in f32),
// one slab in flight a warp, 4 warps a block at D = 128 and 2 at D = 256
// (a row of D + 4 floats takes twice a bf16 row's bytes: 148 and 152 KB
// of shared memory), the new token's score a warp reduction per head.
// The softcap is a template flag (SC): the instances without it compile to
// the code they had before the option. The window moves vis_lo alone.
// llamafile_tpu_torch/testing.py mirrors CS, RW (decode_cluster.cuh), NW,
// rank_lo and the visible range in its emulation of this schedule
// (fdw_split_emulate): change both together.
#include <cooperative_groups.h>

#include <type_traits>

#include "decode_cluster.cuh"

// The cache's element type of this library: bf16 by default; the f16 and
// f32 caches' instances are this file built again with FDW_ELEM defined
// (ops/_build.py VARIANTS), libraries of their own.
#ifndef FDW_ELEM
#define FDW_ELEM __nv_bfloat16
#endif

namespace cg = cooperative_groups;

namespace {

using namespace dcl;

// mma slabs in flight a warp: at D = 256 two read 0-4% faster than three
// (scripts/probe_attn.py, PERF.md), and take 68 KB less shared memory
template <int D>
constexpr int fdw_slabs = D == 128 ? 3 : 2;

// warps a block and slabs in flight a warp, by the element type and D:
// the f32 slab keeps one in flight (see above)
template <typename E, int D>
struct Fdw {
  static constexpr bool MMA = sizeof(E) == 2;
  static constexpr int NW = !MMA && D == 256 ? 2 : 4;
  static constexpr int NS = MMA ? fdw_slabs<D> : 1;
  static constexpr int ROWS = MMA ? RW : RQ;
  // bytes of a slab: K rows, then V rows
  static constexpr int BYTES = MMA ? 2 * RW * (D + 8) * 2 : slab_bytes<E, D>();
};
constexpr int HN = 8;                // query heads a group, padded: the mma's n

// shared memory: each warp's ring of NS slabs (after the loop: the warps'
// acc [NW][D][HN]) | the rank partials pushed here: m, l [CS][HN] and acc
// [CS][D / CS][HN] | the f32 slab only: q [HN][D] f32 and each warp's p
// [RQ][HN]
template <typename E, int D>
constexpr int smem_bytes() {
  using F = Fdw<E, D>;
  return F::NW * F::NS * F::BYTES + (2 * CS * HN + D * HN) * 4 +
         (F::MMA ? 0 : (HN * D + F::NW * RQ * HN) * 4);
}

// E: the cache's element type (__nv_bfloat16, __half, float); D: head dim
// (128 or 256); GC: query heads a chunk (compile time); G: the group, Hq =
// Hkv * G; ONE: the group is one chunk (G = GC <= 8), so G and the chunk
// are known at compile time and no head is masked; SC: the scores are
// softcapped by cap; win > 0: the sliding window
template <typename E, int D, int GC, bool ONE, bool SC>
__global__ void __launch_bounds__(32 * Fdw<E, D>::NW)
fdw_kernel(const float* __restrict__ q, E* __restrict__ k3, E* __restrict__ v3,
           const float* __restrict__ kn, const float* __restrict__ vn,
           const int* __restrict__ pos, float* __restrict__ out, int li, int B, int S,
           int Hkv, int G, int s_eff, int win, float scale, float cap) {
  using F = Fdw<E, D>;
  constexpr bool MMA = F::MMA;
  constexpr int NW = F::NW, NT = 32 * NW, NS = F::NS, ROWS = F::ROWS;
  constexpr int DL = D / CS;               // output dims each rank merges
  static_assert(NW * D * HN * 4 <= NW * NS * F::BYTES, "the warps' acc fits the rings");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* rings = smem_raw;
  float* m_in = reinterpret_cast<float*>(rings + NW * NS * F::BYTES);
  float* l_in = m_in + CS * HN;
  float* acc_in = l_in + CS * HN;
  float* q_s = acc_in + D * HN;            // the f32 slab only
  float* p_s = q_s + HN * D;               // the f32 slab only
  __shared__ float wm[NW][HN], wl[NW][HN], wf[NW][HN];
  __shared__ float sn_t[HN], vn_t[DL];
  __shared__ __align__(8) uint64_t in_bar;   // the partials pushed here have landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int GP = GC > 4 ? HN : 4;  // heads pushed a dim
  // every rank sends (m, l) of HN heads and GP x DL acc; waited on before
  // the first remote store
  rank_start(&in_bar, pushed_bytes<D, HN, GP>());
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
  const int vis_lo = win > 0 ? max(0, p - win + 1) : 0;
  const int n_vis = max(0, min(p, s_eff) - vis_lo);
  const int lo = vis_lo + rank_lo(rank, n_vis);
  const int n = vis_lo + rank_lo(rank + 1, n_vis) - lo;
  // warp w takes the slabs w, w + NW, ... of the rank's rows
  const int n_slabs = (n + ROWS - 1) / ROWS;
  const int nk = n_slabs > warp ? (n_slabs - warp + NW - 1) / NW : 0;
  const size_t row0 = ((size_t)li * B + b) * S;
  const E* kb = k3 + (row0 + lo) * HD + h * D;
  const E* vb = v3 + (row0 + lo) * HD + h * D;
  unsigned char* ring = rings + warp * NS * F::BYTES;
  auto load = [&](int slot, int j0) {
    if constexpr (MMA)
      load_slab<D>(reinterpret_cast<E*>(ring + slot * F::BYTES), kb, vb, j0, min(RW, n - j0),
                   HD);
    else
      load_slab_rows<E, D>(ring + slot * F::BYTES, kb, vb, nullptr, nullptr, j0,
                           min(RQ, n - j0), HD, Hkv);
  };

#pragma unroll
  for (int k = 0; k < NS; ++k) {       // the warp's first NS slabs in flight at once
    if (k < nk) load(k, ROWS * (warp + NW * k));
    cp_async_commit();
  }
  // this rank's dims of the new token's k and v, for the merge and the row write
  float kn_d = 0.f, vn_d = 0.f;
  if (tid < DL) {
    kn_d = kn[(size_t)b * HD + h * D + rank * DL + tid];
    vn_d = vn[(size_t)b * HD + h * D + rank * DL + tid];
    vn_t[tid] = vn_d;
  }

  float* wacc = reinterpret_cast<float*>(rings);                   // [NW][D][HN]
  if constexpr (MMA) {
    // q as the B operand (k = dim, n = head): head gq, dims 16kk + 2qd (+8),
    // rounded to E; heads gn..7 are zero (and not read)
    uint32_t qb[1][D / 16][2];
    const float* qr = q + (qh0 + min(gq, gn - 1)) * D + 2 * qd;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qb[0][kk][0] = gq < gn ? Elt<E>::pack(qr[16 * kk], qr[16 * kk + 1]) : 0u;
      qb[0][kk][1] = gq < gn ? Elt<E>::pack(qr[16 * kk + 8], qr[16 * kk + 9]) : 0u;
    }
    if (warp == 0) {                   // the new token's scores, from its f32 k
      const float* kr = kn + (size_t)b * HD + h * D + 2 * qd;
      float sc = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sc += Elt<E>::lo(qb[0][kk][0]) * kr[16 * kk] + Elt<E>::hi(qb[0][kk][0]) * kr[16 * kk + 1] +
              Elt<E>::lo(qb[0][kk][1]) * kr[16 * kk + 8] +
              Elt<E>::hi(qb[0][kk][1]) * kr[16 * kk + 9];
      sc += __shfl_xor_sync(0xffffffffu, sc, 1);
      sc += __shfl_xor_sync(0xffffffffu, sc, 2);
      if (qd == 0) sn_t[gq] = soft_cap<SC>(sc * scale, cap);
    }

    // this warp's online softmax of heads 2qd, 2qd + 1, and O^T: acc[0][mt]
    // holds dims 16mt + gq (+8) of those two heads. Each warp streams its own
    // slabs: no block barrier in the loop.
    float m2[1][2] = {{NEG, NEG}}, l2[1][2] = {{0.f, 0.f}};
    float acc[1][D / 16][4];
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][mt][e] = 0.f;
    for (int k = 0; k < nk; ++k) {
      cp_async_wait<NS - 1>();         // slab k has landed (this lane's part)
      __syncwarp();                    // and every lane's
      const int j0 = RW * (warp + NW * k);
      attend_slab<D, 1, SC>(reinterpret_cast<const E*>(ring + (k % NS) * F::BYTES),
                            min(RW, n - j0), qb, scale, m2, l2, acc, cap);
      __syncwarp();                    // the slot is free again
      if (k + NS < nk) load(k % NS, RW * (warp + NW * (k + NS)));
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();                   // every warp is done: the rings are free

    // the rank's partial: the warps' merged in warp order, pushed to the ranks
    store_warp_partial<D, 1, HN>(wacc, wm, wl, m2, l2, acc);
  } else {
    for (int i = tid; i < HN * D; i += NT) {   // q in f32, heads past gn zero
      const int g = i / D;
      q_s[i] = g < gn ? q[(qh0 + g) * D + i % D] : 0.f;
    }
    __syncthreads();
    // the new token's scores, from its f32 k: head g on warp g % NW
    const float* kr = kn + (size_t)b * HD + h * D;
    for (int g = warp; g < gn; g += NW) {
      float sc = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32) sc = fmaf(q_s[g * D + d], kr[d], sc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, off);
      if (lane == 0) sn_t[g] = soft_cap<SC>(sc * scale, cap);
    }
    float m[GC], lp[GC], acc[GC][D / 32];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      m[g] = NEG;
      lp[g] = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) acc[g][e] = 0.f;
    }
    float* pw = p_s + warp * RQ * HN;
    for (int k = 0; k < nk; ++k) {
      cp_async_wait<NS - 1>();
      __syncwarp();
      const int j0 = RQ * (warp + NW * k);
      attend_slab_f32<E, D, GC, SC>(ring + (k % NS) * F::BYTES, min(RQ, n - j0), q_s, pw,
                                    scale, m, lp, acc, cap);
      __syncwarp();                    // the slot and the warp's p rows are free again
      if (k + NS < nk) load(k % NS, RQ * (warp + NW * (k + NS)));
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();                   // every warp is done: the rings are free
    store_warp_partial_f32<D, GC, HN>(wacc, wm, wl, m, lp, acc);
  }
  __syncthreads();
  push_partials<D, NW, HN, GP>(wacc, wm, wl, wf, m_in, l_in, acc_in, &in_bar, rank);
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
    k3[o] = Elt<E>::round(kn_d);
    v3[o] = Elt<E>::round(vn_d);
  }
}

// fdw_kernel<E, D, GC, ONE, SC>'s launch: a cluster of CS blocks a (batch
// row, kv head, head chunk). Its shared-memory limit is set once, so that
// later launches can be captured in a CUDA graph.
template <typename E, int D, int GC, bool ONE, bool SC>
int launch(const void* q, void* k3, void* v3, const void* kn, const void* vn,
           const void* pos, void* out, int li, int B, int S, int Hkv, int G, int s_eff,
           int win, float scale, float cap, cudaStream_t st) {
  constexpr int SMEM = smem_bytes<E, D>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fdw_kernel<E, D, GC, ONE, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, Hkv * ((G + GC - 1) / GC), B);
  cfg.blockDim = dim3(32 * Fdw<E, D>::NW);
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
      &cfg, fdw_kernel<E, D, GC, ONE, SC>, (const float*)q, (E*)k3, (E*)v3, (const float*)kn, (const float*)vn, (const int*)pos, (float*)out, li,
      B, S, Hkv, G, s_eff, win, scale, cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// G = Hq / Hkv <= 8 is one chunk of G heads, a larger group ceil(G / 8)
// chunks of gc = ceil(G / ceil(G / 8)) heads, 5 <= gc <= 8; bf16 and f16
// (the same slab, another conversion) alike.
// The f32 cache takes fewer instances, as its f32 slab's instances take
// ptxas several times a bf16 one's: chunks of up to 8 heads on instances
// of 4 or 8 heads with the group at run time (heads past it masked), a
// larger group chunks of 8 (the last one masked).
template <typename E, int D, bool SC>
int dispatch(const void* q, void* k3, void* v3, const void* kn, const void* vn,
             const void* pos, void* out, int li, int B, int S, int Hkv, int G, int s_eff,
             int win, float scale, float cap, cudaStream_t st) {
  if constexpr (std::is_same<E, float>::value) {
#define FDW_RUN(N)                                                                       \
    return launch<E, D, N, false, SC>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, G, s_eff, \
                                      win, scale, cap, st)
    if (G <= 4) FDW_RUN(4);
    FDW_RUN(8);
#undef FDW_RUN
  } else {
    const int nc = (G + 7) / 8, gc = (G + nc - 1) / nc;
#define FDW_CASE(L, N, ONE)                                                                \
  case L:                                                                                  \
    return launch<E, D, N, ONE, SC>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, G, s_eff, win, \
                                    scale, cap, st);
    switch (G <= 8 ? G : -gc) {
      FDW_CASE(1, 1, true) FDW_CASE(2, 2, true) FDW_CASE(3, 3, true) FDW_CASE(4, 4, true)
      FDW_CASE(5, 5, true) FDW_CASE(6, 6, true) FDW_CASE(7, 7, true) FDW_CASE(8, 8, true)
      FDW_CASE(-5, 5, false) FDW_CASE(-6, 6, false) FDW_CASE(-7, 7, false)
      FDW_CASE(-8, 8, false)
      default: return (int)cudaErrorInvalidValue;
    }
#undef FDW_CASE
  }
}

}  // namespace

// D: the head dim, 128 or 256; win > 0: the sliding window (0: none);
// softcap > 0: the score softcap (0: none). The cache's element type is
// this library's FDW_ELEM.
extern "C" int flash_decode_write(const void* q, void* k3, void* v3,
                                  const void* kn, const void* vn,
                                  const void* pos, void* out, int li, int B,
                                  int S, int Hq, int Hkv, int D, int s_eff,
                                  int win, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq < Hkv || Hq % Hkv || win < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
#define FDW_DISPATCH(DD, SC) \
  return dispatch<FDW_ELEM, DD, SC>(q, k3, v3, kn, vn, pos, out, li, B, S, Hkv, G, s_eff, \
                                    win, scale, softcap, st)
  if (D == 128 && softcap == 0.f) FDW_DISPATCH(128, false);
  if (D == 128) FDW_DISPATCH(128, true);
  if (D == 256 && softcap == 0.f) FDW_DISPATCH(256, false);
  if (D == 256) FDW_DISPATCH(256, true);
#undef FDW_DISPATCH
  return (int)cudaErrorInvalidValue;
}
