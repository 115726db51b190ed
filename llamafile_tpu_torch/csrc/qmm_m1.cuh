// The M = 1 q4b GEMV body, shared by qmm_txn_m1.cu (one weight),
// qmm_routed.cu (one expert a slot) and qmm_moe_m1.cu (both phases of the
// fused FFN).
//
// Per group and column the math is qmm_common.cuh's, the TPU kernels'
// (_qmm_kernel_txn_m1, _m1_r, _moe_m1): an exact int32 group dot on __dp4a
// after a 4x4 byte transpose, times the bf16 group scale and the activation
// scale, plus the fused bias on the bf16-rounded activation group sums. At
// M = 1 an mma tile would waste 7 of its 8 rows, so the math stays on the
// CUDA cores.
//
// What bounds it on an H100: device-memory bytes (4.5 bits a weight plus
// the bf16 scale and bias rows; 2 int8 operations a weight). Short of them,
// on small grids (qkv, o: 32-48 column tiles) the fixed cost of a launch:
// the first copies' latency and the split-K combine's dependent round trips.
//
// Design. A block of M1_WARPS warps owns a tile of TN = 128 columns and one
// K split [cb, ce) of the chunks (qmm_common.cuh: 32 packed rows, one lo and
// one hi group). Warp w takes chunks cb + w, cb + w + M1_WARPS, ... through
// a ring of its own M1_STAGES stages in dynamic shared memory, filled with
// 16-byte cp.async copies issued M1_STAGES - 1 chunks ahead (each lane's
// offsets worked out once, M1Copy). A stage holds the chunk's 32 weight rows
// and its two scale and two bias rows, so the scales are no second round
// trip, and a warp waits only on its own copies (cp.async.wait_group and
// __syncwarp: no block barrier in the loop). The block's K range of
// activation codes and scales is staged once, beside the first chunks, and
// the bias term's activation side bf16(sum of a group's codes x its scale)
// is made there once a group. A lane owns 4 adjacent columns and reads one
// 4-byte word of each of the 32 rows: a warp reads whole 128-byte rows, 32
// banks, so the layout needs no swizzle. The warps' partials are summed in
// warp order. The S <= 8 blocks of a column tile's K splits are one
// thread-block cluster: each pushes its values into split 0's shared memory
// and split 0 sums them in split order (m1_cluster_sum), with no partials
// in device memory, no fence and no counter; a float4 combine through
// device memory (qmm_txn.cuh's txn_combine) pays a chain of round trips
// instead (scripts/probe_gemv.py:
// 0.0024-0.0029 ms of a 0.011 ms qkv). Two launches give the same bits. The
// split comes from ops.qmatmul.m1_split: the fewest that put enough bytes
// in flight to fill the card, each warp's ring full, at most 8.
#pragma once

#include <cooperative_groups.h>

#include "mma_bf16.cuh"
#include "qmm_common.cuh"

namespace qmm {

constexpr int M1_WARPS = 4;
constexpr int M1_THREADS = 32 * M1_WARPS;
constexpr int M1_STAGES = 2;
constexpr int M1_MAX_SPLITS = 8;      // a tile's splits are one cluster: the portable size

// Byte layout of one ring stage.
struct M1Stage {
  static constexpr int W = 0;                       // [32 rows][TN] packed bytes
  static constexpr int SC = W + CHUNK_ROWS * TN;    // [2][TN] bf16: lo row, hi row
  static constexpr int BI = SC + 2 * TN * 2;        // [2][TN] bf16
  static constexpr int BYTES = BI + 2 * TN * 2;
};
constexpr int M1_RING = M1_WARPS * M1_STAGES * M1Stage::BYTES;

// The activation stage holds XSB superblocks: codes [XSB][256], scales
// [XSB][8] f32, bias sums [XSB][8] f32.
constexpr int M1_SB_BYTES = 256 + 8 * 4 + 8 * 4;

// Superblocks that a split of at most len chunks spans.
__host__ __device__ constexpr int m1_stage_sb(int len) { return (len + 3) / 4 + 1; }

// The global column of tile column i (i a multiple of 4; a copy piece never
// straddles a run of the map).
struct M1Cols {
  int n_base;
  __device__ int operator()(int i) const { return n_base + i; }
};

// This lane's share of a chunk's copies, offsets worked out once: eight
// 16-byte weight pieces (rows lane / 8 + 4i, piece lane % 8 of the row),
// one of a scale row and one of a bias row (row lane / 16: lo, hi; piece
// lane % 16). Pieces past Ns are zero-filled.
struct M1Copy {
  size_t w_off;
  int w_dst, s_off, s_dst, h;
  bool w_ok, s_ok;

  template <typename Cols>
  __device__ M1Copy(Cols cols, int Ns) {
    const int lane = threadIdx.x & 31;
    const int wc = cols(16 * (lane & 7));
    w_ok = wc < Ns;
    w_off = (size_t)(lane >> 3) * Ns + (w_ok ? wc : 0);
    w_dst = M1Stage::W + (lane >> 3) * TN + 16 * (lane & 7);
    const int scol = cols(8 * (lane & 15));
    s_ok = scol < Ns;
    s_off = s_ok ? scol : 0;
    h = lane >> 4;
    s_dst = M1Stage::SC + h * 2 * TN + 16 * (lane & 15);
  }

  // Issue this lane's copies of chunk c (group j of superblock sb) into the
  // stage at p.
  __device__ __forceinline__ void issue(const uint8_t* qs, const __nv_bfloat16* sc,
                                        const __nv_bfloat16* bias, int Ns, int c,
                                        unsigned char* p) const {
    const int sb = c >> 2, j = c & 3;
    const uint8_t* w = qs + (size_t)(128 * sb + 32 * j) * Ns + w_off;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mma::cp_async16(p + w_dst + 4 * TN * i, w + (size_t)(4 * i) * Ns, w_ok);
    const size_t g = (size_t)(8 * sb + 4 * h + j) * Ns + s_off;
    mma::cp_async16(p + s_dst, sc + g, s_ok);
    if (bias != nullptr)
      mma::cp_async16(p + s_dst + (M1Stage::BI - M1Stage::SC), bias + g, s_ok);
  }
};

// The math of one chunk (group j of a superblock) from the stage at p into
// this lane's acc[4]: xs, sxs and bss are the superblock's 256 codes, 8
// scales and 8 bias sums in the activation stage.
__device__ __forceinline__ void m1_math(const unsigned char* p, const unsigned char* xs,
                                        const float* sxs, const float* bss, int j,
                                        bool has_bias, float* acc) {
  const int lane = threadIdx.x & 31;
  uint32_t w[CHUNK_ROWS];
#pragma unroll
  for (int r = 0; r < CHUNK_ROWS; ++r)
    w[r] = *reinterpret_cast<const uint32_t*>(p + M1Stage::W + r * TN + 4 * lane);
  const int4* xl = reinterpret_cast<const int4*>(xs + 32 * j);
  const int4* xh = reinterpret_cast<const int4*>(xs + 128 + 32 * j);
  const int4 l0 = xl[0], l1 = xl[1], h0 = xh[0], h1 = xh[1];
  const int xlo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
  const int xhi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  int dlo[4] = {0, 0, 0, 0}, dhi[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    uint32_t col[4];
    transpose4x4(&w[4 * t], col);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      dlo[cc] = __dp4a(lo_plane(col[cc]), xlo[t], dlo[cc]);
      dhi[cc] = __dp4a(hi_plane(col[cc]), xhi[t], dhi[cc]);
    }
  }
  const float sxl = sxs[j], sxh = sxs[4 + j];
  const __nv_bfloat16* scs = reinterpret_cast<const __nv_bfloat16*>(p + M1Stage::SC);
  float scl[4], sch[4];
  load_bf16x4(scs + 4 * lane, scl);
  load_bf16x4(scs + TN + 4 * lane, sch);
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    acc[cc] += ((float)dlo[cc] * scl[cc]) * sxl;
    acc[cc] += ((float)dhi[cc] * sch[cc]) * sxh;
  }
  if (has_bias) {
    const float bl = bss[j], bh = bss[4 + j];
    const __nv_bfloat16* bis = reinterpret_cast<const __nv_bfloat16*>(p + M1Stage::BI);
    float bbl[4], bbh[4];
    load_bf16x4(bis + 4 * lane, bbl);
    load_bf16x4(bis + TN + 4 * lane, bbh);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[cc] += bl * bbl[cc] + bh * bbh[cc];
  }
}

// The cluster barrier (PTX barrier.cluster): every thread of the cluster's
// blocks arrives, and a wait returns once all have arrived at the phase.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The split-K sum of a tile: its S blocks are one thread-block cluster
// (1, S, 1), so block rank s is split s. Every block arrived on the cluster
// barrier when it started (m1_tile); waiting on that phase here proves that
// every block of the cluster runs. Each stores its vals into row s of split
// 0's sums through distributed shared memory and arrives again with release
// semantics; the other splits are then done, and split 0 alone waits and
// sums the rows in split order, split 0 first, into its vals (one barrier
// phase at the end). Returns true in split 0.
__device__ __forceinline__ bool m1_cluster_sum(float* vals, int S, int s) {
  __shared__ float sums[M1_MAX_SPLITS][TN];
  cluster_wait();
  float* dst = cooperative_groups::this_cluster().map_shared_rank(&sums[0][0], 0) + s * TN;
  for (int i = threadIdx.x; i < TN; i += M1_THREADS) dst[i] = vals[i];
  cluster_arrive_release();
  if (s != 0) return false;
  cluster_wait();
  for (int i = threadIdx.x; i < TN; i += M1_THREADS) {
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += sums[r][i];
    vals[i] = v;
  }
  __syncthreads();
  return true;
}

// The M = 1 product of one block over chunks [cb, ce) for the TN tile
// columns of cols, left in vals[TN] (shared) summed over the S splits:
// returns true in the block that holds the final values (m1_cluster_sum).
// x [K] int8 and sx [K/32] f32 are the activation row; smem the dynamic
// shared memory (the activation stage of xsb superblocks, then the rings).
template <typename Cols>
__device__ __forceinline__ bool m1_tile(const int8_t* x, const float* sx, const uint8_t* qs,
                                        const __nv_bfloat16* sc, const __nv_bfloat16* bias,
                                        int Ns, int cb, int ce, int S, int s, Cols cols,
                                        unsigned char* smem, int xsb, float* vals) {
  __shared__ float red[M1_WARPS][TN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool has_bias = bias != nullptr;
  unsigned char* xs = smem;                                        // codes [xsb][256]
  float* sxs = reinterpret_cast<float*>(smem + 256 * xsb);         // [xsb][8]
  float* bss = sxs + 8 * xsb;                                      // [xsb][8]
  unsigned char* ring = smem + M1_SB_BYTES * xsb + warp * M1_STAGES * M1Stage::BYTES;
  const int sb0 = cb >> 2, nsb = ce > cb ? ((ce - 1) >> 2) - sb0 + 1 : 0;
  cluster_arrive_relaxed();             // this block runs (m1_cluster_sum)

  // the activation stage, in the first copy group
  for (int i = threadIdx.x; i < 18 * nsb; i += M1_THREADS) {
    if (i < 16 * nsb)
      mma::cp_async16(xs + 16 * i, x + 256 * sb0 + 16 * i, true);
    else
      mma::cp_async16(sxs + 4 * (i - 16 * nsb), sx + 8 * sb0 + 4 * (i - 16 * nsb), true);
  }
  // this warp's chunks: cb + warp + M1_WARPS * t, t < nt
  const int c0 = cb + warp;
  const int nt = c0 < ce ? (ce - c0 + M1_WARPS - 1) / M1_WARPS : 0;
  const M1Copy cp(cols, Ns);
  auto stage = [&](int t) { return ring + (t % M1_STAGES) * M1Stage::BYTES; };
#pragma unroll
  for (int t = 0; t < M1_STAGES - 1; ++t) {
    if (t < nt) cp.issue(qs, sc, bias, Ns, c0 + M1_WARPS * t, stage(t));
    mma::cp_async_commit();
  }
  mma::cp_async_wait<M1_STAGES - 2>();     // the activation stage and chunk 0
  __syncthreads();
  if (has_bias) {
    for (int g = threadIdx.x; g < 8 * nsb; g += M1_THREADS) {
      const int4* xg = reinterpret_cast<const int4*>(xs + 32 * g);
      const int4 v0 = xg[0], v1 = xg[1];
      int t = 0;
      t = __dp4a(v0.x, 0x01010101, t);
      t = __dp4a(v0.y, 0x01010101, t);
      t = __dp4a(v0.z, 0x01010101, t);
      t = __dp4a(v0.w, 0x01010101, t);
      t = __dp4a(v1.x, 0x01010101, t);
      t = __dp4a(v1.y, 0x01010101, t);
      t = __dp4a(v1.z, 0x01010101, t);
      t = __dp4a(v1.w, 0x01010101, t);
      bss[g] = bf16_round((float)t * sxs[g]);
    }
    __syncthreads();
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    // chunk t has landed; the warp barrier publishes every lane's copies
    // and frees the stage read at t - 1
    mma::cp_async_wait<M1_STAGES - 2>();
    __syncwarp();
    if (t + M1_STAGES - 1 < nt)
      cp.issue(qs, sc, bias, Ns, c0 + M1_WARPS * (t + M1_STAGES - 1), stage(t + M1_STAGES - 1));
    mma::cp_async_commit();
    const int c = c0 + M1_WARPS * t, q = (c >> 2) - sb0;
    m1_math(stage(t), xs + 256 * q, sxs + 8 * q, bss + 8 * q, c & 3, has_bias, acc);
  }
  mma::cp_async_wait_all();

#pragma unroll
  for (int cc = 0; cc < 4; ++cc) red[warp][4 * lane + cc] = acc[cc];
  __syncthreads();
  for (int i = threadIdx.x; i < TN; i += M1_THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < M1_WARPS; ++w) v += red[w][i];
    vals[i] = v;
  }
  return m1_cluster_sum(vals, S, s);
}

// M = 1 q4b GEMV: y[Ns] = x @ W. Grid (tiles, S, slots): block (tile, s, z)
// covers columns [128 tile, 128 tile + 128) and chunk split s of S for slot
// z, which multiplies activation row ti[z] by expert ei[z] of the
// expert-stacked weights [E, K/2, Ns] (one slot with ei and ti null: the
// plain GEMV). y [slots, Ns]. Launched in clusters of (1, S, 1).
__global__ void __launch_bounds__(M1_THREADS)
m1_gemv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
               const __nv_bfloat16* __restrict__ bias, float* __restrict__ y, int K, int Ns,
               int S, int xsb, const int* __restrict__ ei, const int* __restrict__ ti) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float vals[TN];
  const Slot sl(ei, ti);
  const size_t wsc = (size_t)sl.e * (K / 32) * Ns;
  x += (size_t)sl.row * K;
  sx += (size_t)sl.row * (K / 32);
  qs += (size_t)sl.e * (K / 2) * Ns;
  sc += wsc;
  if (bias != nullptr) bias += wsc;
  y += (size_t)sl.z * Ns;
  const int s = blockIdx.y;
  const M1Cols cols{(int)blockIdx.x * TN};
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);
  if (!m1_tile(x, sx, qs, sc, bias, Ns, cb, ce, S, s, cols, smem, xsb, vals)) return;
  if (threadIdx.x < TN / 4) {
    const int col = cols(4 * threadIdx.x);
    if (col < Ns)
      *reinterpret_cast<float4*>(y + col) = reinterpret_cast<const float4*>(vals)[threadIdx.x];
  }
}

// Superblocks of a launch's activation stage, and its dynamic shared memory.
inline int m1_xsb(int K, int S) { return m1_stage_sb((K / 64 + S - 1) / S); }
inline int m1_smem(int xsb) { return M1_RING + M1_SB_BYTES * xsb; }

// The most dynamic shared memory a launch may take (an activation stage of
// up to 384 superblocks: K up to 98048 at one split), allowed once a kernel
// and library, so that later launches can be captured into a graph.
constexpr int M1_SMEM_MAX = 160 * 1024;

// Allow kernel f M1_SMEM_MAX bytes of dynamic shared memory unless *set.
// Internal linkage: every library that includes this header keeps its own
// flag for its own copy of the kernel (a static local of an inline function
// would be one object for the whole process).
template <typename F>
static cudaError_t m1_allow_smem(F f, bool* set) {
  if (*set) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, M1_SMEM_MAX);
  if (err == cudaSuccess) *set = true;
  return err;
}

// A launch of kernel f on grid in clusters of (1, grid.y, 1): the S splits
// of a column tile. A refused launch returns its error.
template <typename... P, typename... A>
static cudaError_t m1_cluster_launch(void (*f)(P...), dim3 grid, int smem, cudaStream_t st,
                                     A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(M1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = grid.y;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, f, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One launch of m1_gemv_kernel on grid (tiles, S, slots), S <= M1_MAX_SPLITS.
static cudaError_t m1_gemv_launch(dim3 grid, cudaStream_t st, const void* x, const void* sx,
                                  const void* qs, const void* sc, const void* bias, void* y,
                                  int K, int Ns, const int* ei, const int* ti) {
  static bool smem_set = false;
  const int S = grid.y, xsb = m1_xsb(K, S), smem = m1_smem(xsb);
  if (S > M1_MAX_SPLITS || smem > M1_SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = m1_allow_smem(m1_gemv_kernel, &smem_set);
  if (err != cudaSuccess) return err;
  return m1_cluster_launch(m1_gemv_kernel, grid, smem, st, (const int8_t*)x, (const float*)sx,
                           (const uint8_t*)qs, (const __nv_bfloat16*)sc,
                           (const __nv_bfloat16*)bias, (float*)y, K, Ns, S, xsb, ei, ti);
}

}  // namespace qmm
