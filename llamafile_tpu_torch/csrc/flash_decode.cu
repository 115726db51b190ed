// flash_decode: T=1 GQA decode attention over one layer of a dense KV cache,
// bf16, f16, f32, or int8 codes with per-(position, head) f32 scales.
//
// Replaces the TPU kernels _flash_decode_kernel (llamafile_tpu/ops/
// attention.py:117, via flash_decode :403) and _flash_decode_qt_kernel
// (:161, via flash_decode_stacked :460); the second computes the first's
// function on layer li of the flat stacked cache, and here both are one
// kernel given layer li's pointer. Inputs:
//   q       [B, Hq, D] f32, D = 128 or 256
//   k, v    [B, S, Hkv, D] (element (b, j, h, d) at b * sb + (j * Hkv + h) *
//           D + d: a bf16, f16 or f32 flat [L, B, S, Hkv*D] cache's layer
//           li, or an int8 [L, B, S, Hkv, D] cache's, sliced to s_eff
//           positions, no copy)
//   ks, vs  [B, S, Hkv] f32 scales at b * ssb + j * Hkv + h (int8 only)
//   pos     [B] int32: key j is visible iff j <= pos[b], j < s_eff, and
//           j > pos[b] - win when win > 0.
// Numerics of the TPU kernel: scores are f32 dots times `scale`, then, with
// the softcap option (cap > 0), cap * tanh(s / cap) in f32 (tanhf), softmax
// in f32 with its -1e30 mask, the output acc / max(l, 1e-30). A bf16 or
// f16 cache rounds q and p to its dtype (the TPU kernel's
// q2.astype(k.dtype) and p.astype(v.dtype)) while l sums the f32 p; an f32
// cache rounds neither, and computes in f32 as the int8 one does; an int8
// cache computes on the
// dequantized f32 K/V, as the reference hands the kernel f32 K/V: each code
// is multiplied by its f32 scale here, in registers, the same f32 product,
// so no f32 copy of the layer is made, and every product and sum after it
// is f32 on the CUDA cores.
//
// What bounds it on an H100: device-memory bytes of the visible rows, B *
// n_visible * Hkv * D * 2 (K and V) * (2 B for bf16 and f16 | 4 B for f32
// | 1 B + 4 B / D for int8); about 2 G flops a byte, so the int8 form's
// f32 work comes near the f32 ridge (about 20 flops a byte) at G = 16.
// The design is
// flash_decode_write.cu's (decode_cluster.cuh), one launch a call with no
// scratch in device memory:
// - each (batch row, kv head, head chunk) is one thread-block cluster of
//   CS = 8 blocks; rank r takes the rows [r * n / CS, (r + 1) * n / CS) of
//   the n visible ones, a split fixed by n alone;
// - warp w of a rank streams the slabs w, w + NW, ... of its rows through
//   its own ring of NS slots in shared memory (cp.async, rows past the end
//   zero-filled), NS slabs in flight from the start, no block barrier
//   while it streams;
// - bf16 and f16: a slab of 16 rows runs on mma.sync, "swap AB", the
//   chunk's heads the n side in tiles of 8 (decode_cluster.cuh attend_slab,
//   bf16 or f16 operands), three slabs in flight a warp, 4 warps a block;
// - int8: a slab of 32 rows (codes at a row stride of D + 16 bytes, so
//   that 32 lanes reading 32 rows hit distinct banks, and the rows'
//   scales), two in flight a warp, 8 warps a block at D = 128 and 4 at
//   256 (q8_warps); lane i dequantizes row i's K codes and takes its
//   scores for every head against q held in shared memory (no shuffle in
//   the dot), the slab's max is a warp reduction a head, and in P.V lane
//   i owns dims [i * D / 32, (i + 1) * D / 32) of every head, each V code
//   dequantized once, p read back from the warp's rows in shared memory
//   (decode_cluster.cuh attend_slab_f32, shared with paged_attention.cu);
// - f32: the int8 form's slab without scales, rows of D + 4 floats; a
//   slab takes twice a bf16 slab's bytes a row, so one slab is in flight a
//   warp, 4 warps a block at D = 128 and 2 at 256 (135 and 133 KB of
//   rings, under the 227 KB a block may use);
// - one max and one rescale a slab and head (the TPU kernel's online
//   softmax over blocks); the warps' partials merge in warp order, the
//   ranks' through distributed shared memory in rank order, rank r writing
//   the output dims [r * D / CS, (r + 1) * D / CS).
// Every K/V row is read once for all the heads of its chunk: a chunk is
// the whole group up to 16 query heads (two n tiles; at D = 256 that reads
// 0.0177 ms against chunks of 8's 0.0255 in bf16 at G = 16, s_eff 2048,
// and the same within 1% in int8, PERF.md); a larger group runs as
// ceil(G / 16) chunks of ceil(G / chunks) heads on the grid's y axis
// beside the KV head, each reading the rows again. Instances by the heads
// a chunk holds: bf16 4, 8, 16 and f16 8, 16 (heads past the chunk's are
// zero columns of the tile, never stored), int8 1, 2, 4, 8, 16 and f32 4,
// 16 (heads past the chunk's are zero rows of q).
// Every sum runs in a fixed order, so two launches on the same inputs give
// the same bits. The softcap is a template flag (SC): the instances without
// it compile to the code they had before the option.
#include <cooperative_groups.h>

#include "decode_cluster.cuh"

// The float element type of this library and whether it holds the int8
// form: bf16 and int8 by default; the f16 and f32 caches' instances are
// this file built again with FD_FLOAT and FD_INT8=0 defined
// (ops/_build.py VARIANTS), libraries of their own.
#ifndef FD_FLOAT
#define FD_FLOAT __nv_bfloat16
#define FD_INT8 1
#endif

namespace cg = cooperative_groups;

namespace {

using namespace dcl;

constexpr int NWB = 4;               // warps a block (bf16, f16)

// int8: warps a block and slabs in flight a warp, by D. At D = 128 eight
// warps of two slabs read 17-20% faster than four of three at s_eff 2048
// and 4-8% slower at 1024 (scripts/probe_attn.py fd_q8_nw4, PERF.md); at
// D = 256 eight would need 282 KB of shared memory.
__host__ __device__ constexpr int q8_warps(int D) { return D == 128 ? 8 : 4; }
__host__ __device__ constexpr int q8_slabs(int D) { return 2; }

// a warp's ring: NS slots of one slab each; the mma slab for the 2-byte
// caches, the f32 slab (decode_cluster.cuh) for int8 and f32
template <typename T, int D>
struct Ring {
  static constexpr bool MMA = sizeof(T) == 2, F32 = sizeof(T) == 4;
  static constexpr int NW = MMA ? NWB : F32 ? (D == 128 ? 4 : 2) : q8_warps(D);
  static constexpr int NS = MMA ? 3 : F32 ? 1 : q8_slabs(D);   // slabs in flight a warp
  static constexpr int ROWS = MMA ? RW : RQ;              // rows a slab
  // 2-byte: K rows | V rows at a stride of D + 8 elements; int8: K codes |
  // V codes at a stride of D + 16 bytes | K scales | V scales; f32: K | V
  // rows at a stride of 4 D + 16 bytes
  static constexpr int BYTES = MMA ? 2 * RW * (D + 8) * 2 : slab_bytes<T, D>();
};

// heads a dim of the warps' acc (HP: whole mma tiles for the mma slab)
template <bool MMA, int GP>
__host__ __device__ constexpr int heads_held() {
  return MMA ? 8 * ((GP + 7) / 8) : heads4(GP);
}

// the rings (after the loop: the warps' acc [NW][D][HP]) | the rank
// partials pushed here: m, l [CS][HP] and acc [CS][D / CS][HP] | the f32
// slab only: q [GP][D] f32 and each warp's p [RQ][heads4(GP)]
template <typename T, int D, int GP>
__host__ __device__ constexpr int smem_bytes() {
  using R = Ring<T, D>;
  constexpr int HP = heads_held<R::MMA, GP>();
  return R::NW * R::NS * R::BYTES + (2 * CS * HP + D * HP) * 4 +
         (R::MMA ? 0 : (GP * D + R::NW * RQ * heads4(GP)) * 4);
}

// T: __nv_bfloat16, __half, float or int8_t; D: 128 or 256; GP: the heads the instance
// holds; gc: the heads a chunk (the last one has gn = G - c * gc <= gc);
// SC: the scores are softcapped by cap
template <typename T, int D, int GP, bool SC>
__global__ void __launch_bounds__(32 * Ring<T, D>::NW)
fd_kernel(const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ ks, const float* __restrict__ vs,
          const int* __restrict__ pos, float* __restrict__ out, int Hkv, int G, int gc,
          int s_eff, long long sb, long long ssb, int win, float scale, float cap) {
  using R = Ring<T, D>;
  constexpr bool MMA = R::MMA, Q8 = sizeof(T) == 1;
  static_assert(R::NW * D * heads_held<MMA, GP>() * 4 <= R::NW * R::NS * R::BYTES,
                "the warps' acc fits the rings");
  constexpr int NW = R::NW, NT = 32 * NW, NS = R::NS, ROWS = R::ROWS, NTL = (GP + 7) / 8;
  // heads a dim of the warps' acc, pushed a dim, of a row of p
  constexpr int HP = heads_held<MMA, GP>(), GPU = heads4(GP), PS = heads4(GP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* rings = smem_raw;
  float* m_in = reinterpret_cast<float*>(rings + NW * NS * R::BYTES);
  float* l_in = m_in + CS * HP;
  float* acc_in = l_in + CS * HP;
  float* q_s = acc_in + D * HP;        // the f32 slab only
  float* p_s = q_s + GP * D;           // the f32 slab only
  __shared__ float wm[NW][HP], wl[NW][HP], wf[NW][HP];
  __shared__ __align__(8) uint64_t in_bar;   // the partials pushed here have landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  rank_start(&in_bar, pushed_bytes<D, HP, GPU>());
  const int b = blockIdx.z;
  const int c = blockIdx.y / Hkv, h = blockIdx.y - c * Hkv;   // head chunk, KV head
  const int gn = min(gc, G - c * gc);  // the chunk's heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // query head of the chunk's head 0: heads h * G + c * gc + g, g < gn
  const size_t qh0 = (size_t)b * Hkv * G + (size_t)h * G + (size_t)c * gc;
  const int p = pos[b];
  const int vis_lo = win > 0 ? max(0, p - win + 1) : 0;
  const int n_vis = max(0, min(p + 1, s_eff) - vis_lo);
  const int lo = vis_lo + rank_lo(rank, n_vis);
  const int n = vis_lo + rank_lo(rank + 1, n_vis) - lo;
  // warp w takes the slabs w, w + NW, ... of the rank's rows
  const int n_slabs = (n + ROWS - 1) / ROWS;
  const int nk = n_slabs > warp ? (n_slabs - warp + NW - 1) / NW : 0;
  const int HD = Hkv * D;
  const T* kb = k + (size_t)b * sb + (size_t)lo * HD + h * D;
  const T* vb = v + (size_t)b * sb + (size_t)lo * HD + h * D;
  const float* ksb = Q8 ? ks + (size_t)b * ssb + (size_t)lo * Hkv + h : nullptr;
  const float* vsb = Q8 ? vs + (size_t)b * ssb + (size_t)lo * Hkv + h : nullptr;
  unsigned char* ring = rings + warp * NS * R::BYTES;
  auto load = [&](int slot, int j0) {
    if constexpr (MMA)
      load_slab<D>(reinterpret_cast<T*>(ring + slot * R::BYTES), kb, vb, j0, min(RW, n - j0),
                   HD);
    else
      load_slab_rows<T, D>(ring + slot * R::BYTES, kb, vb, ksb, vsb, j0, min(RQ, n - j0), HD,
                           Hkv);
  };
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {    // the warp's first NS slabs in flight at once
    if (kk < nk) load(kk, ROWS * (warp + NW * kk));
    cp_async_commit();
  }

  float* wacc = reinterpret_cast<float*>(rings);                   // [NW][D][HP]
  if constexpr (MMA) {
    // q as the B operand (k = dim, n = head): head 8t + gq, dims 16kk + 2qd
    // (+8), rounded to T; heads past gn are zero (and not read)
    const int gq = lane >> 2, qd = lane & 3;
    uint32_t qb[NTL][D / 16][2];
#pragma unroll
    for (int t = 0; t < NTL; ++t) {
      const int g = 8 * t + gq;
      const float* qr = q + (qh0 + min(g, gn - 1)) * D + 2 * qd;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qb[t][kk][0] = g < gn ? Elt<T>::pack(qr[16 * kk], qr[16 * kk + 1]) : 0u;
        qb[t][kk][1] = g < gn ? Elt<T>::pack(qr[16 * kk + 8], qr[16 * kk + 9]) : 0u;
      }
    }
    float m2[NTL][2], l2[NTL][2], acc[NTL][D / 16][4];
#pragma unroll
    for (int t = 0; t < NTL; ++t) {
      m2[t][0] = m2[t][1] = NEG;
      l2[t][0] = l2[t][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][mt][e] = 0.f;
    }
    for (int kk = 0; kk < nk; ++kk) {
      cp_async_wait<NS - 1>();         // slab kk has landed (this lane's part)
      __syncwarp();                    // and every lane's
      const int j0 = RW * (warp + NW * kk);
      attend_slab<D, NTL, SC>(reinterpret_cast<const T*>(ring + (kk % NS) * R::BYTES),
                              min(RW, n - j0), qb, scale, m2, l2, acc, cap);
      __syncwarp();                    // the slot is free again
      if (kk + NS < nk) load(kk % NS, RW * (warp + NW * (kk + NS)));
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();                   // every warp is done: the rings are free
    store_warp_partial<D, NTL, HP>(wacc, wm, wl, m2, l2, acc);
  } else {
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
    float* pw = p_s + warp * RQ * PS;
    for (int kk = 0; kk < nk; ++kk) {
      cp_async_wait<NS - 1>();
      __syncwarp();
      const int j0 = RQ * (warp + NW * kk);
      attend_slab_f32<T, D, GP, SC>(ring + (kk % NS) * R::BYTES, min(RQ, n - j0), q_s, pw,
                                    scale, m, lp, acc, cap);
      __syncwarp();                    // the slot and the warp's p rows are free again
      if (kk + NS < nk) load(kk % NS, RQ * (warp + NW * (kk + NS)));
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    store_warp_partial_f32<D, GP, HP>(wacc, wm, wl, m, lp, acc);
  }
  __syncthreads();
  push_partials<D, NW, HP, GPU>(wacc, wm, wl, wf, m_in, l_in, acc_in, &in_bar, rank);
  mbar_wait(&in_bar, 0);               // every rank's partial has landed here

  merge_ranks<D, HP, NT>(out, qh0, gn, m_in, l_in, acc_in, rank);
}

// fd_kernel<T, D, GP, SC>'s launch: a cluster of CS blocks a (batch row, kv
// head, head chunk). Its shared-memory limit is set once, so that later
// launches can be captured in a CUDA graph.
template <typename T, int D, int GP, bool SC>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* out, int B, int Hkv, int G, int gc, int s_eff, long long sb,
           long long ssb, int win, float scale, float cap, cudaStream_t st) {
  constexpr int SMEM = smem_bytes<T, D, GP>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fd_kernel<T, D, GP, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, Hkv * ((G + gc - 1) / gc), B);
  cfg.blockDim = dim3(32 * Ring<T, D>::NW);
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
      &cfg, fd_kernel<T, D, GP, SC>, (const float*)q, (const T*)k, (const T*)v,
      (const float*)ks, (const float*)vs, (const int*)pos, (float*)out, Hkv, G, gc, s_eff, sb,
      ssb, win, scale, cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instance of the group: ceil(G / 16) chunks of gc = ceil(G / chunks)
// heads, on the smallest instance that holds gc heads
template <typename T, int D, bool SC>
int dispatch(int G, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, int B, int Hkv, int s_eff,
             long long sb, long long ssb, int win, float scale, float cap, cudaStream_t st) {
  // chunks of up to 16 heads (ops/attention.py FD_CHUNK_HEADS)
  const int nc = (G + 15) / 16, gc = (G + nc - 1) / nc;
#define FD_LAUNCH(N)                                                                    \
  return launch<T, D, N, SC>(q, k, v, ks, vs, pos, out, B, Hkv, G, gc, s_eff, sb, ssb, win, \
                             scale, cap, st)
  // int8: the f32 slab's work scales with the heads held; bf16 and f16
  // take 4, 8 and 16, f32 4 and 16 (its f32 slab's instances take ptxas
  // several times a bf16 one's)
  constexpr bool Q8 = sizeof(T) == 1;
  if constexpr (Q8) {
    if (gc == 1) FD_LAUNCH(1);
    if (gc == 2) FD_LAUNCH(2);
  }
  if (gc <= 4) FD_LAUNCH(4);
  if constexpr (sizeof(T) != 4) {
    if (gc <= 8) FD_LAUNCH(8);
  }
  FD_LAUNCH(16);
#undef FD_LAUNCH
}

}  // namespace

// int8 != 0: k/v hold int8 codes and ks/vs their f32 scales (this
// library only: FD_INT8); else elements of FD_FLOAT (bf16 here, f16 and
// f32 in the flash_decode_f16 and _f32 libraries) and ks = vs = NULL.
// sb / ssb: batch strides of k, v and of ks, vs in elements. D: the head
// dim, 128 or 256; win > 0: the sliding window (0: none); softcap > 0: the
// score softcap (0: none).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* ks,
                            const void* vs, const void* pos, void* out, int B, int Hq,
                            int Hkv, int D, int s_eff, long long sb, long long ssb, int win,
                            int int8, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq < Hkv || Hq % Hkv || B <= 0 || win < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const bool sc = softcap > 0.f;
#define FD_DISPATCH(T, DD, SC, KS, VS)                                                        \
  return dispatch<T, DD, SC>(G, q, k, v, KS, VS, pos, out, B, Hkv, s_eff, sb, ssb, win, scale, \
                             softcap, st)
#if FD_INT8
  if (int8 && D == 128 && !sc) FD_DISPATCH(int8_t, 128, false, ks, vs);
  if (int8 && D == 128) FD_DISPATCH(int8_t, 128, true, ks, vs);
  if (int8 && D == 256 && !sc) FD_DISPATCH(int8_t, 256, false, ks, vs);
  if (int8 && D == 256) FD_DISPATCH(int8_t, 256, true, ks, vs);
#endif
  if (!int8 && D == 128 && !sc) FD_DISPATCH(FD_FLOAT, 128, false, nullptr, nullptr);
  if (!int8 && D == 128) FD_DISPATCH(FD_FLOAT, 128, true, nullptr, nullptr);
  if (!int8 && D == 256 && !sc) FD_DISPATCH(FD_FLOAT, 256, false, nullptr, nullptr);
  if (!int8 && D == 256) FD_DISPATCH(FD_FLOAT, 256, true, nullptr, nullptr);
#undef FD_DISPATCH
  return (int)cudaErrorInvalidValue;
}
