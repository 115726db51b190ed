// qmm_i8p: the int8 prefill GEMM on Hopper s8 warpgroup tensor cores.
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
// exact in int32 (256 * 128^2 < 2^31) and in its conversion to f32 (< 2^24).
// The f32 update ("the fold") runs in the reference's order with
// __fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA, and the
// blocks run serially in K order with no split-K: the same roundings in the
// same order as the plain version (qmm_i8p_plain), so the output is equal
// to it bit for bit at every tiling.
//
// What bounds it on an H100: int8 operations at prefill sizes (gate|up at
// M = 1024 is 2.4e11 operations, 0.1215 ms at 1979 TOP/s), weight bytes at
// small M.
//
// Design: BM x BN output tiles (BM = 128, BN = 128, or 64 where the wrapper
// finds too few 128-wide tiles to fill the SMs), 256 threads as two
// warpgroups of 64 rows, each issuing wgmma.mma_async m64nBNk32 (s8 in, s32
// out) from 128-byte-swizzled shared memory (wgmma_s8.cuh): both operands
// are K-major, as xq and w8 are stored, so a K step of 128 is one swizzle
// row of A (xq rows) and of B (w8 rows), four k32 wgmmas, and a 256-block
// is two steps. The tiles stream through a ring of STAGES stages by 16-byte
// cp.async, DIST = STAGES - 2 steps ahead, one commit group and one block
// barrier a step; the last step of a 256-block also brings the block's
// scales (sxa of the tile's rows, sw of its columns) into its stage. A
// block's wgmmas go into one s32 accumulator set (the first with scale-d
// 0, which also clears it); its int32 sums can be read only once they have
// completed, so after the block's last step the warpgroup waits for all its
// wgmmas and folds the set into its f32 accumulators, scales read from
// shared memory, while the loads of the next steps are in flight. Folding
// block b from a second set beside block b + 1's wgmmas (two sets, the fold
// overlapped) is the probe's `overlap` variant (scripts/probe_i8p.py): it
// measured slower, as the kernel is bound by its operand traffic, not by
// the tensor cores. At BN = 128 a thread holds 64 f32 and 64 s32
// accumulators (N = 256 would need 256 and does not fit the 255 registers
// a thread). Rows past M and columns past Ns are
// zero-filled, multiplied and never stored: every warpgroup issues its
// wgmmas, as ptxas serializes wgmmas behind a branch it cannot prove
// uniform (its warning C7518). The grid walks M fastest, so the M tiles of
// one column tile run together and share its weight reads in L2. TMA and
// warp specialisation are later steps.
#include "mma_bf16.cuh"
#include "wgmma_s8.cuh"

namespace {

using namespace mma;

constexpr int BM = 128, BK = 128;           // a K step: one 128-byte swizzle row of int8
constexpr int THREADS = 256;                // two warpgroups of 64 rows
constexpr int STAGES = 6;
constexpr int DIST = STAGES - 2;            // steps a load runs ahead of its wgmmas
constexpr int STEPS = 256 / BK;             // K steps of a 256-block
constexpr int A_BYTES = BM * BK;

// A stage: [A tile | B tile | sxa of the BM rows | sw of the BN columns],
// 1024-aligned for the swizzle.
template <int BN>
struct Stage {
  static constexpr int B = A_BYTES;
  static constexpr int SX = B + BN * BK;
  static constexpr int SW = SX + 4 * BM;
  static constexpr int BYTES = (SW + 4 * BN + 1023) / 1024 * 1024;
  static constexpr int SMEM = STAGES * BYTES + 1024;   // + alignment room
};

// 4-byte global -> shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Byte offset of 16-byte chunk c of row `row` in a swizzled tile.
__device__ __forceinline__ int sw128(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// cp.async the rows [r0, r0 + ROWS) of K step ks of the K-contiguous int8
// matrix src [rows, K] into the tile dst (rows past `rows` zero-filled).
template <int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const int8_t* src, int ks, int r0,
                                          int rows, int K) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int idx = threadIdx.x + THREADS * i;
    const int row = idx >> 3, c = idx & 7;
    const bool valid = r0 + row < rows;
    const int8_t* s = valid ? src + (size_t)(r0 + row) * K + BK * ks + 16 * c : src;
    cp_async16(dst + sw128(row, c), s, valid);
  }
}

// K step ks into the stage st; the last step of a 256-block also brings
// the block's scales of the tile's rows and columns.
template <int BN>
__device__ __forceinline__ void load_stage(unsigned char* st, const int8_t* xq,
                                           const float* sxa, const int8_t* w8,
                                           const float* sw, int ks, int m0, int n0, int M,
                                           int K, int Ns) {
  load_tile<BM>(st, xq, ks, m0, M, K);
  load_tile<BN>(st + Stage<BN>::B, w8, ks, n0, Ns, K);
  if (ks % STEPS == STEPS - 1) {
    const int b = ks / STEPS, t = threadIdx.x;
    if (t < BM) {
      const bool valid = m0 + t < M;
      cp_async4(st + Stage<BN>::SX + 4 * t,
                valid ? sxa + (size_t)(m0 + t) * (K / 256) + b : sxa, valid);
    } else if (t < BM + BN / 4) {            // Ns % 16 == 0: a chunk is all in or out
      const int c = t - BM;
      const bool valid = n0 + 4 * c < Ns;
      cp_async16(st + Stage<BN>::SW + 16 * c,
                 valid ? sw + (size_t)b * Ns + n0 + 4 * c : sw, valid);
    }
  }
}

template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128)
    wgmma::m64n128k32(d, da, db, scale_d);
  else
    wgmma::m64n64k32(d, da, db, scale_d);
}

// Issue one K step of warpgroup wg's 64 x BN tile into the s32 set d, from
// the stage at shared address st: four k32 wgmmas in one commit group (not
// waited for here); the first step of a block starts d from its product.
template <int BN>
__device__ __forceinline__ void mma_step(int (&d)[BN / 2], uint32_t st, int wg, bool first) {
  wgmma::fence_operands(d);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    mma<BN>(d, wgmma::desc_sw128(st + 8192 * wg + 32 * kk, 16, 1024),
            wgmma::desc_sw128(st + Stage<BN>::B + 32 * kk, 16, 1024),
            first && kk == 0 ? 0 : 1);
  wgmma::commit();
  wgmma::fence_operands(d);
}

// acc += (float(p) * sxa[row, b]) * sw[b, col] for this thread's fragment,
// the block's scales read from the stage st that brought them.
template <int BN>
__device__ __forceinline__ void fold(float (&acc)[BN / 2], const int (&p)[BN / 2],
                                     const unsigned char* st, int wg) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const float* sx = reinterpret_cast<const float*>(st + Stage<BN>::SX) + 64 * wg + 16 * w +
                    (lane >> 2);
  const float* swc = reinterpret_cast<const float*>(st + Stage<BN>::SW) + 2 * (lane & 3);
  const float x[2] = {sx[0], sx[8]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(swc + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(__int2float_rn(p[i]), x[h]), s.x));
      acc[i + 1] =
          __fadd_rn(acc[i + 1], __fmul_rn(__fmul_rn(__int2float_rn(p[i + 1]), x[h]), s.y));
    }
  }
}

struct Args {
  const int8_t* xq;
  const float* sxa;
  const int8_t* w8;
  const float* sw;
  int M, K, Ns, m0, n0, wg;
  unsigned char* smem;
};

// The STEPS K steps of 256-block b into the s32 set p, then its fold.
template <int BN>
__device__ __forceinline__ void run_block(const Args& a, int b, float (&acc)[BN / 2],
                                          int (&p)[BN / 2]) {
  const int nk = a.K / BK;
  const uint32_t s0 = smem_addr(a.smem);
#pragma unroll
  for (int h = 0; h < STEPS; ++h) {
    const int ks = STEPS * b + h;
    cp_async_wait<DIST - 1>();               // step ks has landed (this thread's part)
    wgmma::fence_proxy_async();
    __syncthreads();                         // every part; step ks - 2's slot is free
    mma_step<BN>(p, s0 + (ks % STAGES) * Stage<BN>::BYTES, a.wg, h == 0);
    if (ks + DIST < nk)
      load_stage<BN>(a.smem + ((ks + DIST) % STAGES) * Stage<BN>::BYTES, a.xq, a.sxa, a.w8,
                     a.sw, ks + DIST, a.m0, a.n0, a.M, a.K, a.Ns);
    cp_async_commit();
    if (h < STEPS - 1) wgmma::wait<1>();     // step ks - 1's slot may be refilled
  }
  wgmma::wait<0>();                          // the block's sums are complete
  wgmma::fence_operands(p);
  fold<BN>(acc, p, a.smem + ((STEPS * b + STEPS - 1) % STAGES) * Stage<BN>::BYTES, a.wg);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
qmm_i8p_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sxa,
               const int8_t* __restrict__ w8, const float* __restrict__ sw,
               float* __restrict__ y, int M, int K, int Ns) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Args a{xq, sxa, w8, sw, M, K, Ns, (int)blockIdx.x * BM, (int)blockIdx.y * BN,
               (int)threadIdx.x >> 7, smem};
  const int nk = K / BK, nb = K / 256;

  float acc[BN / 2];
  int p[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < DIST; ++s) {
    if (s < nk) load_stage<BN>(smem + s * Stage<BN>::BYTES, xq, sxa, w8, sw, s, a.m0, a.n0, M,
                               K, Ns);
    cp_async_commit();
  }
  for (int b = 0; b < nb; ++b) run_block<BN>(a, b, acc, p);
  cp_async_wait<0>();

  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = a.m0 + 64 * a.wg + 16 * w + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = a.n0 + 8 * j + 2 * q;
      if (c >= Ns) continue;
      *reinterpret_cast<float2*>(y + (size_t)row * Ns + c) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN>
int launch(const void* xq, const void* sxa, const void* w8, const void* sw, void* y, int M,
           int K, int Ns, cudaStream_t st) {
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        qmm_i8p_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Stage<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((M + BM - 1) / BM, (Ns + BN - 1) / BN);
  qmm_i8p_kernel<BN><<<grid, THREADS, Stage<BN>::SMEM, st>>>(
      (const int8_t*)xq, (const float*)sxa, (const int8_t*)w8, (const float*)sw, (float*)y, M,
      K, Ns);
  return (int)cudaGetLastError();
}

}  // namespace

// xq int8 [M, K]; sxa f32 [M, K/256]; w8 int8 [Ns, K]; sw f32 [K/256, Ns];
// y f32 [M, Ns]. K % 256 == 0, Ns % 16 == 0; bn the n tile, 128 or 64.
extern "C" int qmm_i8p(const void* xq, const void* sxa, const void* w8, const void* sw,
                       void* y, int M, int K, int Ns, int bn, void* stream) {
  if (M < 1 || K < 256 || K % 256 || Ns < 16 || Ns % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 128) return launch<128>(xq, sxa, w8, sw, y, M, K, Ns, st);
  if (bn == 64) return launch<64>(xq, sxa, w8, sw, y, M, K, Ns, st);
  return (int)cudaErrorInvalidValue;
}
