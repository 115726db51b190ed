// paged_attention: batched T=1 GQA decode attention over a paged KV pool,
// one layer, bf16, f16 or f32 pages, or int8 pages with per-(head,
// position) f32 scales.
//
// Replaces the upstream Pallas TPU kernel paged_attention
// (jax/experimental/pallas/ops/tpu/paged_attention/paged_attention_kernel.py,
// online softmax :261-287), which llamafile_tpu/runtime/paged.py paged_attend
// (:253) calls at :277. Its math is all f32: q arrives in f32 already scaled
// by 1/sqrt(D), K and V are promoted to f32 (int8 codes times their f32
// scale), and so is the softmax. Inputs:
//   q       [R, Hq, D] f32
//   k, v    one layer of the pool, [Hkv, P, ps, D] bf16, f16, f32 or int8 (the
//           caller passes the layer's pointer: no slice is copied)
//   ks, vs  [Hkv, P, ps] f32 scales (int8 only)
//   lengths [R] int32 (>= 1), tables [R, MAXP] int32 page ids
// Output [R, Hq, D] f32. Query head h reads KV head h / G (G = Hq / Hkv);
// key j of row r is visible when j < lengths[r] and lives at page
// tables[r, j / ps], offset j % ps.
//
// What bounds it on an H100: device-memory bytes, sum over rows of
// length_r * Hkv * D * 2 (K and V) * (2 B for bf16 and f16 | 4 B for f32 |
// 1 B + 4 B / D of scale for int8); about G flops a byte for bf16 (2 G for
// int8, G / 2 for f32), all f32 on the
// CUDA cores, so a group of 16 comes near the f32 issue rate (67 TFLOP/s
// against 3.35 TB/s). The design is flash_decode.cu's int8 form on
// decode_cluster.cuh, one launch a call with no scratch in device memory:
// - each (row, kv head, head chunk) is one thread-block cluster of CS = 8
//   blocks; rank r takes the keys [r * n / CS, (r + 1) * n / CS) of the
//   row's n = lengths[r] visible ones (rank_lo), a split read on the device
//   from lengths, so the caller never reads them on the host;
// - the block first stages the page ids of its keys (tables read once a
//   rank) in shared memory; warp w then streams the 32-row slabs w, w + NW,
//   ... of the rank's keys through its own ring of NS slots (cp.async, rows
//   past the end zero-filled; a slab may span two pages: each lane finds
//   its row's page, and the copies take the row index from that lane by a
//   shuffle), NS slabs in flight from the start, no block barrier while it
//   streams;
// - every page type runs decode_cluster.cuh's f32 slab (attend_slab_f32):
//   lane i takes row i's scores for every head against q in shared memory,
//   and in P.V owns dims [i * D / 32, (i + 1) * D / 32) of every head, each
//   K and V element converted to f32 (an int8 code times its scale) once;
//   no tensor core touches q or p, so the result keeps the reference's f32;
// - one max and one rescale a slab and head (the TPU kernel's online
//   softmax over blocks); the warps' partials merge in warp order, the
//   ranks' through distributed shared memory in rank order (push_partials,
//   merge_ranks), rank r writing the output dims [r * D / CS, (r + 1) * D /
//   CS).
// The page table is why the slab load is this file's own (load_slab_paged)
// beside decode_cluster.cuh's dense ones: the rows of a slab are not one
// strided run. Every K/V row is read once for all the heads of its chunk:
// a chunk is the whole group up to 16 query heads; a larger group runs as
// ceil(G / 16) chunks of ceil(G / chunks) heads on the grid's y axis beside
// the KV head, each reading the rows again. Instances by the heads a chunk
// holds: 1, 2, 4, 8, 16 (f16 and f32 pages: 4, 16; heads past the
// chunk's are zero rows of q). Every
// sum runs in a fixed order, so two launches on the same inputs give the
// same bits.
#include <cooperative_groups.h>

#include "decode_cluster.cuh"

// The float page type of this library and whether it holds the int8
// pages: bf16 and int8 by default; f16 and f32 pages are this file built
// again with PA_FLOAT and PA_INT8=0 defined (ops/_build.py VARIANTS),
// libraries of their own.
#ifndef PA_FLOAT
#define PA_FLOAT __nv_bfloat16
#define PA_INT8 1
#endif

namespace cg = cooperative_groups;

namespace {

using namespace dcl;

// a warp's ring: NS slots of one f32 slab each (decode_cluster.cuh), NW
// warps a block; sized so that two blocks fit an SM. At 8 rows of 1024
// keys (scripts/probe_attn.py) one block an SM read 1.5x slower (two bf16
// slabs a warp, or 8 warps); two warps a block 9-15% faster at G = 3 and
// 4, and 12% slower at phase 8's four served rows (7% in int8 at G = 16).
template <typename T, int D>
struct Ring {
  static constexpr int NW = 4;                                      // warps a block
  static constexpr int NS = sizeof(T) == 1 && D == 128 ? 2 : 1;     // slabs in flight a warp
  static constexpr int BYTES = slab_bytes<T, D>();
};

// An f32 slab row takes twice a bf16 one's bytes: one block an SM, and 2
// warps a block at D = 256 (133 KB of rings; 4 would take 266 KB).
template <>
struct Ring<float, 256> {
  static constexpr int NW = 2, NS = 1, BYTES = slab_bytes<float, 256>();
};

// rows j0 .. j0 + nr - 1 of the rank's keys into one f32 slab: `row`, this
// lane's key's row of the layer (row index (h * P + page) * ps + offset of
// k, v and the scales) when lane < nr; rows nr .. RQ - 1 are zero-filled
// (scales too), so P.V over them adds 0
template <typename T, int D>
__device__ __forceinline__ void load_slab_paged(unsigned char* slab, const T* kp, const T* vp,
                                                const float* ks, const float* vs, int row,
                                                int nr) {
  constexpr int KS = slab_stride<T, D>(), RB = D * (int)sizeof(T), CH = RB / 16;
  const int lane = threadIdx.x & 31;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(kp);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vp);
#pragma unroll
  for (int it = 0; it < RQ * CH / 32; ++it) {
    const int i = lane + 32 * it, r = i / CH, col = 16 * (i % CH);
    const int src = __shfl_sync(0xffffffffu, row, r);
    const bool ok = r < nr;
    const size_t off = (size_t)(ok ? src : 0) * RB + col;
    cp_async16(slab + r * KS + col, kb + off, ok);
    cp_async16(slab + (RQ + r) * KS + col, vb + off, ok);
  }
  if constexpr (sizeof(T) == 1) {
    const bool ok = lane < nr;
    float* sc = reinterpret_cast<float*>(slab + 2 * RQ * KS);
    cp_async4(sc + lane, ks + (ok ? row : 0), ok);
    cp_async4(sc + RQ + lane, vs + (ok ? row : 0), ok);
  }
}

// the rings (after the loop: the warps' acc [NW][D][HP]) | the rank
// partials pushed here: m, l [CS][HP] and acc [CS][D / CS][HP] | q [GP][D]
// f32 | each warp's p [RQ][HP] | the rank's page ids (pt ints)
template <typename T, int D, int GP>
__host__ __device__ constexpr int smem_base() {
  using R = Ring<T, D>;
  constexpr int HP = heads4(GP);
  return R::NW * R::NS * R::BYTES + (2 * CS * HP + D * HP + GP * D + R::NW * RQ * HP) * 4;
}

// T: __nv_bfloat16, __half, float or int8_t; D: 128 or 256; GP: the heads the instance
// holds; gc: the heads a chunk (the last one has gn = G - c * gc <= gc);
// pt: room for the page ids of a rank (maxp / CS + 2)
template <typename T, int D, int GP>
__global__ void __launch_bounds__(32 * Ring<T, D>::NW)
pa_kernel(const float* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
          const float* __restrict__ ks, const float* __restrict__ vs,
          const int* __restrict__ lengths, const int* __restrict__ tables,
          float* __restrict__ out, int Hkv, int G, int gc, int P, int ps, int maxp) {
  using R = Ring<T, D>;
  constexpr int NW = R::NW, NT = 32 * NW, NS = R::NS, HP = heads4(GP);
  static_assert(NW * D * HP * 4 <= NW * NS * R::BYTES, "the warps' acc fits the rings");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* rings = smem_raw;
  float* m_in = reinterpret_cast<float*>(rings + NW * NS * R::BYTES);
  float* l_in = m_in + CS * HP;
  float* acc_in = l_in + CS * HP;
  float* q_s = acc_in + D * HP;
  float* p_s = q_s + GP * D;
  int* pt_s = reinterpret_cast<int*>(p_s + NW * RQ * HP);
  __shared__ float wm[NW][HP], wl[NW][HP], wf[NW][HP];
  __shared__ __align__(8) uint64_t in_bar;   // the partials pushed here have landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  rank_start(&in_bar, pushed_bytes<D, HP, HP>());
  const int r = blockIdx.z;
  const int c = blockIdx.y / Hkv, h = blockIdx.y - c * Hkv;   // head chunk, KV head
  const int gn = min(gc, G - c * gc);  // the chunk's heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // query head of the chunk's head 0: heads h * G + c * gc + g, g < gn
  const size_t qh0 = (size_t)r * Hkv * G + (size_t)h * G + (size_t)c * gc;
  const int len = max(0, min(lengths[r], maxp * ps));
  const int lo = rank_lo(rank, len);
  const int n = rank_lo(rank + 1, len) - lo;
  // the rank's page ids: pages p0 .. p0 + np - 1 hold its keys
  const int p0 = lo / ps, np = n > 0 ? (lo + n - 1) / ps - p0 + 1 : 0;
  const int* trow = tables + (size_t)r * maxp;
  for (int i = tid; i < np; i += NT) pt_s[i] = trow[p0 + i];
  __syncthreads();
  // warp w takes the slabs w, w + NW, ... of the rank's keys
  const int n_slabs = (n + RQ - 1) / RQ;
  const int nk = n_slabs > warp ? (n_slabs - warp + NW - 1) / NW : 0;
  unsigned char* ring = rings + warp * NS * R::BYTES;
  auto load = [&](int slot, int j0) {  // the slab of the rank's keys j0 ..
    const int j = lo + j0 + lane, pg = j / ps;
    const int row = j0 + lane < n ? (int)(((size_t)h * P + pt_s[pg - p0]) * ps + (j - pg * ps))
                                  : 0;
    load_slab_paged<T, D>(ring + slot * R::BYTES, kp, vp, ks, vs, row, min(RQ, n - j0));
  };
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {    // the warp's first NS slabs in flight at once
    if (kk < nk) load(kk, RQ * (warp + NW * kk));
    cp_async_commit();
  }
  for (int i = tid; i < GP * D; i += NT) {   // q in f32, heads past gn zero
    const int g = i / D;
    q_s[i] = g < gn ? q[(qh0 + g) * D + i % D] : 0.f;
  }
  __syncthreads();

  float m[GP], lp[GP], acc[GP][D / 32];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG;
    lp[g] = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) acc[g][e] = 0.f;
  }
  float* pw = p_s + warp * RQ * HP;
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<NS - 1>();           // slab kk has landed (this lane's part)
    __syncwarp();                      // and every lane's
    const int j0 = RQ * (warp + NW * kk);
    attend_slab_f32<T, D, GP>(ring + (kk % NS) * R::BYTES, min(RQ, n - j0), q_s, pw, 1.f, m,
                              lp, acc);
    __syncwarp();                      // the slot and the warp's p rows are free again
    if (kk + NS < nk) load(kk % NS, RQ * (warp + NW * (kk + NS)));
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                     // every warp is done: the rings are free
  float* wacc = reinterpret_cast<float*>(rings);                   // [NW][D][HP]
  store_warp_partial_f32<D, GP, HP>(wacc, wm, wl, m, lp, acc);
  __syncthreads();
  push_partials<D, NW, HP, HP>(wacc, wm, wl, wf, m_in, l_in, acc_in, &in_bar, rank);
  mbar_wait(&in_bar, 0);               // every rank's partial has landed here
  merge_ranks<D, HP, NT>(out, qh0, gn, m_in, l_in, acc_in, rank);
}

// pa_kernel<T, D, GP>'s launch: a cluster of CS blocks a (row, kv head,
// head chunk). Its shared-memory limit is raised only when a wider table
// needs more room, so that later launches can be captured in a CUDA graph.
template <typename T, int D, int GP>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* lengths, const void* tables, void* out, int R, int Hkv, int G, int gc,
           int P, int ps, int maxp, cudaStream_t st) {
  const int smem = smem_base<T, D, GP>() + 4 * (maxp / CS + 2);
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(pa_kernel<T, D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, Hkv * ((G + gc - 1) / gc), R);
  cfg.blockDim = dim3(32 * Ring<T, D>::NW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, pa_kernel<T, D, GP>, (const float*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)tables, (float*)out, Hkv, G, gc, P, ps,
      maxp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instance of the group: ceil(G / 16) chunks of gc = ceil(G / chunks)
// heads (ops/attention.py PA_CHUNK_HEADS), on the smallest instance that
// holds gc heads
template <typename T, int D>
int dispatch(int G, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lengths, const void* tables, void* out, int R,
             int Hkv, int P, int ps, int maxp, cudaStream_t st) {
  const int nc = (G + 15) / 16, gc = (G + nc - 1) / nc;
#define PA_LAUNCH(N)                                                                       \
  return launch<T, D, N>(q, k, v, ks, vs, lengths, tables, out, R, Hkv, G, gc, P, ps, maxp, \
                         st)
  // bf16, f16 and int8 pages: 1, 2, 4, 8, 16 heads held; f32 4 and 16
  // (fewer instances to build)
  constexpr bool ALL = sizeof(T) != 4;
  if constexpr (ALL) {
    if (gc == 1) PA_LAUNCH(1);
    if (gc == 2) PA_LAUNCH(2);
  }
  if (gc <= 4) PA_LAUNCH(4);
  if constexpr (ALL) {
    if (gc <= 8) PA_LAUNCH(8);
  }
  PA_LAUNCH(16);
#undef PA_LAUNCH
}

}  // namespace

// int8 != 0: k/v hold int8 codes and ks/vs their scales (this library
// only: PA_INT8); else pages of PA_FLOAT (bf16 here, f16 and f32 in the
// paged_attention_f16 and _f32 libraries) and ks = vs = NULL.
// D: the head dim, 128 or 256.
extern "C" int paged_attention(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* lengths, const void* tables,
                               void* out, int R, int Hq, int Hkv, int D, int P, int ps,
                               int maxp, int int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq < Hkv || Hq % Hkv || R <= 0 || ps <= 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
#define PA_DISPATCH(T, DD, KS, VS) \
  return dispatch<T, DD>(G, q, k, v, KS, VS, lengths, tables, out, R, Hkv, P, ps, maxp, st)
#if PA_INT8
  if (int8 && D == 128) PA_DISPATCH(int8_t, 128, ks, vs);
  if (int8 && D == 256) PA_DISPATCH(int8_t, 256, ks, vs);
#endif
  if (!int8 && D == 128) PA_DISPATCH(PA_FLOAT, 128, nullptr, nullptr);
  if (!int8 && D == 256) PA_DISPATCH(PA_FLOAT, 256, nullptr, nullptr);
#undef PA_DISPATCH
  return (int)cudaErrorInvalidValue;
}
