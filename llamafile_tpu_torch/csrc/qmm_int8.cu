// qmm_int8: the q4b product for 1 <= M <= 32 rows under the int8 flavour
// (LLAMAFILE_TPU_Q4B=int8), on Hopper s8 tensor cores.
//
// Replaces the TPU kernel _qmm_kernel_int8 (llamafile_tpu/ops/qmatmul.py:224,
// called by _qmm_call_int8 :1581) and its layer-indexed form
// _qmm_kernel_int8_l (:1698, called by _qmm_call_int8_stacked :1706): a
// stacked caller passes the pointers of layer li's slices, so no slice is
// copied.
//
//   y[m, n] = sum_g (float(sum_{k in g} xq[m, k] * w[k, n]) * scale[g, n]) * sx[m, g]
// xq int8 [M, K] and sx f32 [M, K/32] are the per-32 codes of the normed x
// (ops/qmatmul.py quantize_activations_g32); qs uint8 [K/2, Ns] and scales
// bf16 [K/32, Ns] one layer's q4b weights (qmm_common.cuh: lo plane q, hi
// plane 16q - 128, the fold in the scales); y f32 [M, Ns]. The bias term is
// the caller's (qmatmul adds it outside, as the reference does). The TPU
// kernel fed the MXU one batched int8 dot over the even/odd 128-chunk planes
// of x; here one mma.sync.m16n8k32.s8 is exactly one 32-group dot, and x
// keeps its natural [M, K] order.
//
// Design ("swap AB"): A is 16 weight columns x 32 k of one group, B is 32 k x
// 8 activation rows, so M <= 32 is one to four n8 tiles (NT). A block owns 32
// columns; its 8 warps share them and take the 64-row chunks of its K split
// in turn (chunk c: 32 packed rows, one lo group and the hi group 128 k
// later). A lane reads, straight from device memory, rows 4q..4q+3 and
// 16+4q..16+4q+3 of a chunk at columns 4g..4g+3 (g = lane / 4, q = lane % 4):
// eight 32-bit loads, each warp load 4 rows x 32 contiguous bytes. A 4x4
// byte transpose turns them into per-column words of 4 consecutive k, which
// are the A fragments of two m16 tiles when A-row i of tile t stands for
// column 4(i % 8) + 2t + i / 8. The same bytes feed the lo group (b & 0x0F)
// and the hi group ((b ^ 0x80) & 0xF0) against activations 128 k apart. The
// int32 group dot is scaled into f32 right after its mma: per chunk the lo
// group, then the hi group, in chunk order per warp; the 8 warps are summed
// in warp order and the S splits of K in split order (qmm_common.cuh's
// fixed-order combine), so results do not vary run to run. Rows past M read
// zero codes with sx 0 and are never stored; columns past Ns read zeros.
// The next chunk's weights are loaded before this chunk's mmas run.
//
// What bounds it on an H100: device-memory bytes. Each weight byte is read
// once for all M <= 32 rows (64 int8 operations a byte at M = 32, far under
// the ~590 ops/byte ridge), so the kernel is a stream of qs and scales.
#include "mma_s8.cuh"
#include "qmm_common.cuh"

namespace {

using mma::mma_16832_s8;
using qmm::hi_plane;
using qmm::lo_plane;
using qmm::load_bf16x4;
using qmm::split_range;
using qmm::splitk_combine;
using qmm::transpose4x4;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TC = 32;               // columns a block

struct Int8Off {
  int M, Ns, n_base;
  __device__ long long operator()(int i) const {
    const int m = i / TC, c = n_base + i % TC;
    return (m < M && c < Ns) ? (long long)m * Ns + c : -1;
  }
};

// The eight weight words of chunk c for this lane: w[r] = packed row 4q + r,
// w[4 + r] = packed row 16 + 4q + r of the chunk, columns col..col+3.
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ qs, int Ns, int c,
                                           int q, int col, bool ok, uint32_t* w) {
  const uint8_t* p = qs + (size_t)(128 * (c >> 2) + 32 * (c & 3) + 4 * q) * Ns + col;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    w[r] = ok ? __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)r * Ns)) : 0u;
    w[4 + r] = ok ? __ldg(reinterpret_cast<const uint32_t*>(p + (size_t)(16 + r) * Ns)) : 0u;
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
qmm_int8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
                float* __restrict__ y, float* partial, int* counters, int M, int K,
                int Ns, int S) {
  constexpr int NV = NT * 8 * TC;    // block outputs: rows x columns
  __shared__ float red[WARPS][NV];
  __shared__ float vals[NV];
  const int tile = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int n_base = tile * TC;
  const int col = n_base + 4 * g;    // this lane's four columns
  const bool ok = col < Ns;
  const int KG = K / 32;
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);

  float acc[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][u][e] = 0.f;

  uint32_t cur[8];
  int c = cb + warp;
  if (c < ce) load_chunk(qs, Ns, c, q, col, ok, cur);
  for (; c < ce; c += WARPS) {
    uint32_t nxt[8];
    if (c + WARPS < ce) load_chunk(qs, Ns, c + WARPS, q, col, ok, nxt);
    const int sb = c >> 2, j = c & 3;
    uint32_t cw[8];                  // cw[cc] k 4q.., cw[4 + cc] k 16+4q.., column col+cc
    transpose4x4(cur, cw);
    transpose4x4(cur + 4, cw + 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {    // lo group, then hi group
      const int gi = 8 * sb + 4 * h + j;
      const int k0 = 256 * sb + 128 * h + 32 * j;
      float scv[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok) load_bf16x4(sc + (size_t)gi * Ns + col, scv);
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t w4[4] = {cw[2 * t], cw[2 * t + 1], cw[4 + 2 * t], cw[5 + 2 * t]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[t][e] = (uint32_t)(h ? hi_plane(w4[e]) : lo_plane(w4[e]));
      }
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int row = 8 * u + g;   // B fragment: activation row of column g
        uint32_t b0 = 0u, b1 = 0u;
        if (row < M) {
          const int8_t* xr = x + (size_t)row * K + k0 + 4 * q;
          b0 = __ldg(reinterpret_cast<const uint32_t*>(xr));
          b1 = __ldg(reinterpret_cast<const uint32_t*>(xr + 16));
        }
        const int r0 = 8 * u + 2 * q;  // C rows r0, r0 + 1
        const float s0 = r0 < M ? __ldg(sx + (size_t)r0 * KG + gi) : 0.f;
        const float s1 = r0 + 1 < M ? __ldg(sx + (size_t)(r0 + 1) * KG + gi) : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          int d[4] = {0, 0, 0, 0};
          mma_16832_s8(d, a[t], b0, b1);
          acc[t][u][0] += ((float)d[0] * scv[2 * t]) * s0;
          acc[t][u][1] += ((float)d[1] * scv[2 * t]) * s1;
          acc[t][u][2] += ((float)d[2] * scv[2 * t + 1]) * s0;
          acc[t][u][3] += ((float)d[3] * scv[2 * t + 1]) * s1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
  }

  // this warp's partial: C element (A-row, n) of tile t, n8 tile u is output
  // row 8u + n, column 4g + 2t (A-row g) or 4g + 2t + 1 (A-row g + 8)
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int r0 = 8 * u + 2 * q, c0 = 4 * g + 2 * t;
      red[warp][r0 * TC + c0] = acc[t][u][0];
      red[warp][(r0 + 1) * TC + c0] = acc[t][u][1];
      red[warp][r0 * TC + c0 + 1] = acc[t][u][2];
      red[warp][(r0 + 1) * TC + c0 + 1] = acc[t][u][3];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < NV; i += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][i];
    vals[i] = v;
  }
  if (!splitk_combine(vals, NV, partial, (size_t)M * Ns, Int8Off{M, Ns, n_base},
                      counters + tile, S, s))
    return;
  for (int i = threadIdx.x; i < NV; i += THREADS) {
    const int m = i / TC, cc = n_base + i % TC;
    if (m < M && cc < Ns) y[(size_t)m * Ns + cc] = vals[i];
  }
}

template <int NT>
void launch(const void* x, const void* sx, const void* qs, const void* sc, void* y,
            void* partial, void* counters, int M, int K, int Ns, int S, cudaStream_t st) {
  dim3 grid((Ns + TC - 1) / TC, S);
  qmm_int8_kernel<NT><<<grid, THREADS, 0, st>>>(
      (const int8_t*)x, (const float*)sx, (const uint8_t*)qs, (const __nv_bfloat16*)sc,
      (float*)y, (float*)partial, (int*)counters, M, K, Ns, S);
}

}  // namespace

// x int8 [M, K]; sx f32 [M, K/32]; qs uint8 [K/2, Ns]; sc bf16 [K/32, Ns];
// y f32 [M, Ns]; partial f32 [S, M, Ns] and counters int32 [tiles] (zero, and
// left zero) are split-K scratch. 1 <= M <= 32, K % 256 == 0, Ns % 4 == 0,
// 1 <= S <= K / 64.
extern "C" int qmm_int8(const void* x, const void* sx, const void* qs, const void* sc,
                        void* y, void* partial, void* counters, int M, int K, int Ns,
                        int S, void* stream) {
  if (M < 1 || M > 32 || K < 256 || K % 256 || Ns < 4 || Ns % 4 || S < 1 || S > K / 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((M + 7) / 8) {
    case 1: launch<1>(x, sx, qs, sc, y, partial, counters, M, K, Ns, S, st); break;
    case 2: launch<2>(x, sx, qs, sc, y, partial, counters, M, K, Ns, S, st); break;
    case 3: launch<3>(x, sx, qs, sc, y, partial, counters, M, K, Ns, S, st); break;
    default: launch<4>(x, sx, qs, sc, y, partial, counters, M, K, Ns, S, st); break;
  }
  return (int)cudaGetLastError();
}
