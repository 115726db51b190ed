// qmm_i8p: the int8 prefill GEMM on Hopper s8 tensor cores.
//
// Replaces the TPU kernel _qmm_kernel_i8p (llamafile_tpu/ops/qmatmul.py:1808,
// called by _qmm_call_i8p :1871) and its layer-indexed form
// _qmm_kernel_i8p_l (:1904, called by _qmm_call_i8p_stacked :1911): a
// stacked caller passes the pointers of layer li's companion, so no slice
// is copied.
//
//   y[m, n] = sum over the 256-blocks b of K, in K order, of
//             (float(sum_{k in b} xq[m, k] * w8[n, k]) * sxa[m, b]) * sw[b, n]
// xq int8 [M, K] and sxa f32 [M, K/256] are the activations (ops/qmatmul.py
// i8p_prep); w8 int8 [Ns, K] and sw f32 [K/256, Ns] the companion
// (ops/repack.py attach_int8_prefill, which stores w8 K-contiguous, the
// transpose of the reference's [K, Ns]); y f32 [M, Ns]. A block's dot is
// exact in int32 (256 * 127^2 < 2^31) and in its conversion to f32 (< 2^24).
// The f32 update runs in the reference's order with __fmul_rn / __fadd_rn,
// so nvcc contracts nothing into an FMA, and the blocks run serially in K
// order with no split-K: the same roundings in the same order as the plain
// version (qmm_i8p_plain).
//
// Design: 128 x 128 output tiles, 8 warps of 64 x 32, on
// mma.sync.m16n8k32 (s8 in, s32 out). Both operands are K-contiguous, so
// each 64-deep K step copies its A (xq rows) and B (w8 rows) tiles straight
// into shared memory with 16-byte cp.async, in a ring of 4 stages, and
// ldmatrix loads the fragments (mma_s8.cuh). Four steps make a 256-block:
// its int32 sums are then scaled into the f32 accumulators and restart
// from zero. Rows past M (a ragged bucket or admission slice) and columns
// past Ns are zero-filled and never stored; warps whose rows all lie past
// M skip their products. The grid walks M fastest, so the M tiles of one
// column tile share its weight reads in L2. wgmma/TMA are a later step.
//
// What bounds it on an H100: int8 operations at prefill sizes (gate|up at
// M = 1024 is 2.4e11 operations, 0.1215 ms at 1979 TOP/s), weight bytes at
// small M.
#include "mma_s8.cuh"

namespace {

using namespace mma;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 256;
constexpr int PAD = BK + 16;                 // byte row stride: ldmatrix conflict-free
constexpr int TILE_BYTES = 128 * PAD;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // A tile, then B tile
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
constexpr int STEPS_PER_BLOCK = 256 / BK;

// K step ks of rows [r0, r0 + 128) of the K-contiguous int8 matrix src
// [rows, K] into the tile dst (cp.async; rows past `rows` zero-filled).
__device__ __forceinline__ void load_tile(const int8_t* src, int8_t* dst, int ks, int r0,
                                          int rows, int K) {
#pragma unroll
  for (int i = 0; i < 128 * BK / 16 / THREADS; ++i) {
    const int idx = threadIdx.x + THREADS * i;
    const int row = idx >> 2, seg = idx & 3;
    const bool valid = r0 + row < rows;
    const int8_t* s = valid ? src + (size_t)(r0 + row) * K + BK * ks + 16 * seg : src;
    cp_async16(dst + row * PAD + 16 * seg, s, valid);
  }
}

__device__ __forceinline__ void load_stage(const int8_t* xq, const int8_t* w8, int8_t* st,
                                           int ks, int m0, int n0, int M, int K, int Ns) {
  load_tile(xq, st, ks, m0, M, K);
  load_tile(w8, st + TILE_BYTES, ks, n0, Ns, K);
}

__global__ void __launch_bounds__(THREADS, 1)
qmm_i8p_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sxa,
               const int8_t* __restrict__ w8, const float* __restrict__ sw,
               float* __restrict__ y, int M, int K, int Ns) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);   // [STAGES][A | B][128][PAD]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;           // warp tile: rows 64wm, cols 32wn
  const int g = lane >> 2, q = lane & 3;
  // m16 tiles of this warp that hold rows below M (warp-uniform)
  const int mt = min(4, max(0, (M - m0 - 64 * wm + 15) / 16));
  const int nk = K / BK, nb = K / 256;

  float acc[4][4][4];
  int p[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][b][c] = 0.f;
        p[a][b][c] = 0;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(xq, w8, smem + s * STAGE_BYTES, s, m0, n0, M, K, Ns);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();     // step ks has landed
    __syncthreads();                 // ... for every thread; step ks - 1's slot is free
    const int pre = ks + STAGES - 1;
    if (pre < nk) load_stage(xq, w8, smem + (pre % STAGES) * STAGE_BYTES, pre, m0, n0, M, K, Ns);
    cp_async_commit();
    const int8_t* a_s = smem + (ks % STAGES) * STAGE_BYTES;
    const int8_t* b_s = a_s + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (32 * wn + 16 * np + (lane & 7) + 8 * (lane >> 4)) * PAD +
                           32 * kk + 16 * ((lane >> 3) & 1));
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi < mt) {
          // matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
          uint32_t afr[4];
          ldmatrix_x4(afr, a_s + (64 * wm + 16 * mi + (lane & 15)) * PAD + 32 * kk +
                               16 * (lane >> 4));
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_16832_s8(p[mi][ni], afr, bfr[ni][0], bfr[ni][1]);
        }
      }
    }
    if (ks % STEPS_PER_BLOCK == STEPS_PER_BLOCK - 1) {
      // 256-block b is summed: acc += (float(p) * sxa[m, b]) * sw[b, n]
      const int b = ks / STEPS_PER_BLOCK;
      float swc[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + 32 * wn + 8 * ni + 2 * q + j;
          swc[ni][j] = c < Ns ? __ldg(sw + (size_t)b * Ns + c) : 0.f;
        }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi < mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 64 * wm + 16 * mi + g + 8 * h;
            const float sx = row < M ? __ldg(sxa + (size_t)row * nb + b) : 0.f;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int e = 2 * h + j;
                acc[mi][ni][e] = __fadd_rn(
                    acc[mi][ni][e],
                    __fmul_rn(__fmul_rn(__int2float_rn(p[mi][ni][e]), sx), swc[ni][j]));
                p[mi][ni][e] = 0;
              }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

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
        *reinterpret_cast<float2*>(y + (size_t)row * Ns + c) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// xq int8 [M, K]; sxa f32 [M, K/256]; w8 int8 [Ns, K]; sw f32 [K/256, Ns];
// y f32 [M, Ns]. K % 256 == 0, Ns % 16 == 0.
extern "C" int qmm_i8p(const void* xq, const void* sxa, const void* w8, const void* sw,
                       void* y, int M, int K, int Ns, void* stream) {
  if (M < 1 || K < 256 || K % 256 || Ns < 16 || Ns % 16) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_i8p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((M + BM - 1) / BM, (Ns + BN - 1) / BN);
  qmm_i8p_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)sxa, (const int8_t*)w8, (const float*)sw, (float*)y, M,
      K, Ns);
  return (int)cudaGetLastError();
}
