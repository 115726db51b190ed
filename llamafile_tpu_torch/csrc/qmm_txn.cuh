// The q4b product for 1 <= M <= 32 rows, shared by qmm_txn.cu (one weight)
// and qmm_txn_g.cu (row tiles of M rows, each on its own expert).
//
// Per row, the math is qmm_txn_m1's: exact int32 group dots of int8
// activations (natural K-group order) against the 4-bit codes, times the
// bf16 group scale and the activation scale, plus the fused bias on the
// bf16-rounded activation group sums.
//
// What bounds it on an H100: device-memory bytes. Each weight byte is read
// once for all M rows, 4M int8 operations a byte (128 at M = 32), far under
// the ~590 operations a byte where the int8 tensor cores would take over.
// Short of the bytes, the instructions bind: copy issue and address math at
// small M, the f32 fold of the group dots (three instructions an output a
// group, the bias term a fourth) at M = 32; and on small grids (N = 4096:
// 32 column tiles, split over K) the split-K combine.
//
// Design. A block owns a tile of TN = 128 columns and one K split of S
// (ops.qmatmul.n_split: 3 blocks an SM; the fixed-order combine of
// qmm_common.cuh, here in float4 pieces); its four warps own disjoint
// 32-column strips, so no per-warp reduction is needed. A chunk (32 packed
// rows: one lo group and the hi group 128 k later, qmm_common.cuh) moves
// through a ring of STAGES stages in dynamic shared memory, filled with
// cp.async copies issued STAGES - 1 chunks ahead, one block barrier a chunk:
// the weight nibbles (32 rows x 128 bytes in 16-byte pieces, XOR-swizzled
// within a row so the fragment reads hit 32 banks), the chunk's two scale
// rows and two bias rows, the codes of the two groups (MP = 8 NT rows of 64
// bytes, padded to 80 so the B fragment reads hit 32 banks) and the two
// activation scales a row (4-byte copies). Each thread's copies are fixed
// offsets worked out once (TxnCopy), so a chunk costs it a few adds and
// five copies at most. Rows past M and columns past Ns are zero-filled by the
// copies and never stored. Each NT is compiled for the blocks an SM its
// shared memory allows (txn_min_blocks), so registers do not cut them.
//
// The math is s8 mma.sync.m16n8k32 in the swap-AB form: A is
// 16 weight columns x one 32-k group, built from the packed bytes by a 4x4
// byte transpose and the lo / hi plane masks (A-row i of tile t stands for
// column 4(i % 8) + 2t + i / 8 of the warp's strip, g = lane / 4), B is the
// activation rows as NT = ceil(M / 8) n8 tiles, so one mma is one group's
// exact int32 dot for 16 columns x 8 rows, folded into f32 at once. The bias
// term's activation side, bf16(sum of a group's codes x its scale), is made
// once a chunk a row by 2 MP threads into the stage, one chunk ahead of the
// math (with a bias the loop waits for two landed chunks), so the one barrier
// publishes it. The accumulators then go to shared memory (the ring's space)
// for the split-K combine and the coalesced float4 store.
#pragma once

#include "mma_s8.cuh"
#include "qmm_common.cuh"

namespace qmm {

constexpr int MAXM = 32;
constexpr int TXN_WARPS = 4;
constexpr int TXN_THREADS = TXN_WARPS * 32;
constexpr int STAGES = 4;
static_assert(STAGES >= 3, "the bias sums run one chunk ahead of the math");

// Blocks an SM each NT is compiled for (__launch_bounds__). Left to itself
// ptxas gives NT = 1 fewer blocks than its 23.5 KB ring allows (the lm
// head's 1008 blocks then miss one wave) and NT = 4 three; at these counts
// nothing spills (scripts/probe_txn.py prints ptxas's counts).
constexpr int txn_min_blocks(int nt) { return nt == 1 ? 8 : nt == 2 ? 7 : 4; }

// Byte layout of one ring stage for NT n8 row tiles (MP = 8 NT rows).
template <int NT>
struct TxnStage {
  static constexpr int MP = 8 * NT;
  static constexpr int XROW = 80;                  // 64 code bytes + 16 of padding
  static constexpr int W = 0;                      // [32 rows][128] nibble bytes, swizzled
  static constexpr int SC = W + CHUNK_ROWS * TN;   // [2][TN] bf16: lo row, hi row
  static constexpr int BI = SC + 2 * TN * 2;       // [2][TN] bf16
  static constexpr int X = BI + 2 * TN * 2;        // [MP][XROW]: lo 32 | hi 32 codes
  static constexpr int SX = X + MP * XROW;         // [2][MP] f32: lo, hi group scales
  static constexpr int BS = SX + 2 * MP * 4;       // [2][MP] f32: bias sums
  static constexpr int BYTES = BS + 2 * MP * 4;
};

// The stored position of the 16-byte piece `ch` of weight row r.
__device__ __forceinline__ int txn_swz(int r, int ch) { return ch ^ (((r >> 2) & 3) << 1); }

// 4-byte global -> shared copy through L1; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

struct TxnArgs {
  const int8_t* x;
  const float* sx;
  const uint8_t* qs;
  const __nv_bfloat16* sc;
  const __nv_bfloat16* bias;
  int M, K, Ns, n_base;
};

// This thread's share of a chunk's copies, its offsets worked out once:
// every thread two 16-byte weight pieces (rows r and r + 16, 16 columns);
// threads < 64 one piece of a scale row (t < 32) or a bias row; threads <
// 4 MP one 16-byte piece of a row's codes; threads 64 .. 64 + 2 MP - 1 one
// activation scale.
template <int NT>
struct TxnCopy {
  using St = TxnStage<NT>;
  size_t w_off;          // bytes of qs past the chunk's first row
  int w_dst, s_off, s_dst, x_off, x_dst, a_off, a_dst;
  bool w_ok, s_ok, x_ok, a_ok;

  __device__ TxnCopy(const TxnArgs& a) {
    const int t = threadIdx.x;
    const int r = t >> 3, ch = t & 7, col = a.n_base + 16 * ch;
    w_ok = col < a.Ns;
    w_off = (size_t)r * a.Ns + (w_ok ? col : 0);
    w_dst = St::W + r * TN + 16 * txn_swz(r, ch);   // row r + 16: same swizzle, 2 KB on
    const int which = (t >> 4) & 1, seg = t & 15, scol = a.n_base + 8 * seg;
    s_ok = t < 64 && scol < a.Ns && (t < 32 || a.bias != nullptr);
    s_off = 4 * which * a.Ns + (s_ok ? scol : 0);
    s_dst = (t < 32 ? St::SC : St::BI) + which * 2 * TN + 16 * seg;
    const int m = t >> 2, part = t & 3;
    x_ok = t < 4 * St::MP && m < a.M;
    x_off = x_ok ? m * a.K + 128 * (part >> 1) + 16 * (part & 1) : 0;
    x_dst = St::X + m * St::XROW + 16 * part;
    const int i = t - 64, am = i >> 1, h = i & 1;
    a_ok = i >= 0 && i < 2 * St::MP && am < a.M;
    a_off = a_ok ? am * (a.K / 32) + 4 * h : 0;
    a_dst = St::SX + 4 * (h * St::MP + am);
  }

  // Issue this thread's copies of chunk c (group j of superblock sb) into
  // the stage at p.
  __device__ __forceinline__ void issue(const TxnArgs& a, int c, unsigned char* p) const {
    const int sb = c >> 2, j = c & 3;
    const uint8_t* w = a.qs + (size_t)(128 * sb + 32 * j) * a.Ns + w_off;
    mma::cp_async16(p + w_dst, w, w_ok);
    mma::cp_async16(p + w_dst + 16 * TN, w + (size_t)16 * a.Ns, w_ok);
    if (threadIdx.x < 64) {
      const __nv_bfloat16* src = threadIdx.x < 32 ? a.sc : a.bias;
      mma::cp_async16(p + s_dst, (s_ok ? src + (size_t)(8 * sb + j) * a.Ns : a.sc) + s_off,
                      s_ok);
    }
    if (threadIdx.x < 4 * St::MP)
      mma::cp_async16(p + x_dst, a.x + (x_ok ? 256 * sb + 32 * j : 0) + x_off, x_ok);
    if (threadIdx.x >= 64 && threadIdx.x < 64 + 2 * St::MP)
      cp_async4(p + a_dst, a.sx + (a_ok ? 8 * sb + j : 0) + a_off, a_ok);
  }
};

// The bias term's activation side of the stage at p: for row m < MP and
// group h, bf16(sum of the group's 32 codes * its scale), exact int32 sum.
template <int NT>
__device__ __forceinline__ void txn_bias_sums(unsigned char* p) {
  using St = TxnStage<NT>;
  const int t = threadIdx.x;
  if (t < 2 * St::MP) {
    const int m = t >> 1, h = t & 1;
    const int4* xr = reinterpret_cast<const int4*>(p + St::X + m * St::XROW + 32 * h);
    const int4 v0 = xr[0], v1 = xr[1];
    int s = 0;
    s = __dp4a(v0.x, 0x01010101, s);
    s = __dp4a(v0.y, 0x01010101, s);
    s = __dp4a(v0.z, 0x01010101, s);
    s = __dp4a(v0.w, 0x01010101, s);
    s = __dp4a(v1.x, 0x01010101, s);
    s = __dp4a(v1.y, 0x01010101, s);
    s = __dp4a(v1.z, 0x01010101, s);
    s = __dp4a(v1.w, 0x01010101, s);
    const float* sxs = reinterpret_cast<const float*>(p + St::SX);
    reinterpret_cast<float*>(p + St::BS)[h * St::MP + m] = bf16_round((float)s * sxs[h * St::MP + m]);
  }
}

// The math of one chunk from the stage at p into this lane's accumulators:
// acc[(t * NT + u) * 4 + e] is C element e of m16 tile t and n8 tile u
// (output row 8u + 2q + (e & 1), strip column 4g + 2t + (e >> 1)).
template <int NT>
__device__ __forceinline__ void txn_math(const unsigned char* p, bool has_bias, float* acc) {
  using St = TxnStage<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int byte = 32 * warp + 4 * g;              // this lane's 4 columns in the tile
  const int swz = 16 * txn_swz(4 * q, byte >> 4) + (byte & 15);   // the same for its rows
  uint32_t w[8];                                   // rows 4q + r, then 16 + 4q + r
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    w[r] = *reinterpret_cast<const uint32_t*>(p + St::W + (4 * q + r) * TN + swz);
    w[4 + r] = *reinterpret_cast<const uint32_t*>(p + St::W + (16 + 4 * q + r) * TN + swz);
  }
  uint32_t cw[8];              // cw[cc]: k 4q.. of column cc; cw[4 + cc]: k 16 + 4q..
  transpose4x4(w, cw);
  transpose4x4(w + 4, cw + 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {                    // lo group, then hi group
    float scv[4], bv[4];
    load_bf16x4(reinterpret_cast<const __nv_bfloat16*>(p + St::SC) + h * TN + byte, scv);
    if (has_bias)
      load_bf16x4(reinterpret_cast<const __nv_bfloat16*>(p + St::BI) + h * TN + byte, bv);
    uint32_t af[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint32_t w4[4] = {cw[2 * t], cw[2 * t + 1], cw[4 + 2 * t], cw[5 + 2 * t]};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        af[t][e] = (uint32_t)(h ? hi_plane(w4[e]) : lo_plane(w4[e]));
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const unsigned char* xr = p + St::X + (8 * u + g) * St::XROW + 32 * h + 4 * q;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
      const int r0 = 8 * u + 2 * q;                // C rows r0, r0 + 1
      const float2 s = *reinterpret_cast<const float2*>(p + St::SX + 4 * (h * St::MP + r0));
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        int d[4] = {0, 0, 0, 0};
        mma::mma_16832_s8(d, af[t], b0, b1);
        float* c = acc + (t * NT + u) * 4;
        c[0] += ((float)d[0] * scv[2 * t]) * s.x;
        c[1] += ((float)d[1] * scv[2 * t]) * s.y;
        c[2] += ((float)d[2] * scv[2 * t + 1]) * s.x;
        c[3] += ((float)d[3] * scv[2 * t + 1]) * s.y;
      }
      if (has_bias) {
        const float2 bl = *reinterpret_cast<const float2*>(p + St::BS + 4 * (h * St::MP + r0));
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float* c = acc + (t * NT + u) * 4;
          c[0] += bl.x * bv[2 * t];
          c[1] += bl.y * bv[2 * t];
          c[2] += bl.x * bv[2 * t + 1];
          c[3] += bl.y * bv[2 * t + 1];
        }
      }
    }
  }
}

// This lane's accumulators into vals [MP][TN] (shared).
template <int NT>
__device__ __forceinline__ void txn_store(const float* acc, float* vals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vals[(8 * u + 2 * q + (e & 1)) * TN + 32 * warp + 4 * g + 2 * t + (e >> 1)] =
            acc[(t * NT + u) * 4 + e];
}

// qmm_common.cuh's split-K combine in float4 pieces, every piece's S
// partial loads of a split issued together: the same sums in the same order
// (split 0 first), so the same bits. vals [MP][TN] (shared) holds the
// block's values; partial [S][M][Ns]. Returns true in the block that holds
// the final values.
template <int NT>
__device__ __forceinline__ bool txn_combine(float* vals, int M, float* partial, int Ns,
                                            int n_base, int* counter, int S, int s) {
  constexpr int Q = TN / 4, PER = (8 * NT * Q + TXN_THREADS - 1) / TXN_THREADS;
  __shared__ int is_last;
  __syncthreads();
  if (S == 1) return true;
  float4* v4 = reinterpret_cast<float4*>(vals);
  const size_t stride = (size_t)M * Ns;
  size_t off[PER];
  bool ok[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * TXN_THREADS, m = i / Q, col = n_base + 4 * (i % Q);
    ok[k] = m < M && col < Ns;
    off[k] = (size_t)m * Ns + col;
    if (ok[k]) *reinterpret_cast<float4*>(partial + s * stride + off[k]) = v4[i];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = (atomicAdd(counter, 1) == S - 1);
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  float4 sum[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) sum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int t = 0; t < S; ++t) {
    float4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (ok[k]) v[k] = __ldcg(reinterpret_cast<const float4*>(partial + t * stride + off[k]));
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (ok[k]) {
        sum[k].x += v[k].x;
        sum[k].y += v[k].y;
        sum[k].z += v[k].z;
        sum[k].w += v[k].w;
      }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (ok[k]) v4[threadIdx.x + k * TXN_THREADS] = sum[k];
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();
  return true;
}

template <int NT>
__global__ void __launch_bounds__(TXN_THREADS, txn_min_blocks(NT))
qmm_txn_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
               const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
               const __nv_bfloat16* __restrict__ bias, float* __restrict__ y,
               float* partial, int* counters, int M, int K, int Ns, int S,
               const int* __restrict__ te) {
  using St = TxnStage<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  {  // row tile z of a grouped launch: its rows and expert te[z]
    const int z = blockIdx.z;
    const int e = te ? __ldg(te + z) : 0;
    const size_t wsc = (size_t)e * (K / 32) * Ns;
    x += (size_t)z * M * K;
    sx += (size_t)z * M * (K / 32);
    qs += (size_t)e * (K / 2) * Ns;
    sc += wsc;
    if (bias != nullptr) bias += wsc;
    y += (size_t)z * M * Ns;
    partial += (size_t)z * S * M * Ns;
    counters += (size_t)z * gridDim.x;
  }
  const int tile = blockIdx.x, s = blockIdx.y;
  const int n_base = tile * TN;
  const TxnArgs a{x, sx, qs, sc, bias, M, K, Ns, n_base};
  const TxnCopy<NT> cp(a);
  const bool has_bias = bias != nullptr;
  auto stage = [&](int c) { return smem + (c % STAGES) * St::BYTES; };
  int cb, ce;
  split_range(K / 64, S, s, &cb, &ce);
  float acc[8 * NT];
#pragma unroll
  for (int i = 0; i < 8 * NT; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (cb + i < ce) cp.issue(a, cb + i, stage(cb + i));
    mma::cp_async_commit();
  }
  if (has_bias && cb < ce) {            // the first chunk's bias sums
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    txn_bias_sums<NT>(stage(cb));
  }
  for (int c = cb; c < ce; ++c) {
    // chunk c has landed (with the bias, chunk c + 1 too: its sums are
    // made beside chunk c's math); the barrier publishes every thread's
    // copies and chunk c's sums, and frees chunk c - 1's stage
    if (has_bias)
      mma::cp_async_wait<STAGES - 3>();
    else
      mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < ce) cp.issue(a, c + STAGES - 1, stage(c + STAGES - 1));
    mma::cp_async_commit();
    if (has_bias && c + 1 < ce) txn_bias_sums<NT>(stage(c + 1));
    txn_math<NT>(stage(c), has_bias, acc);
  }
  mma::cp_async_wait_all();
  __syncthreads();                      // the ring's space becomes vals

  float* vals = reinterpret_cast<float*>(smem);
  txn_store<NT>(acc, vals);
  if (!txn_combine<NT>(vals, M, partial, Ns, n_base, counters + tile, S, s)) return;
  const float4* v4 = reinterpret_cast<const float4*>(vals);
  for (int i = threadIdx.x; i < M * TN / 4; i += TXN_THREADS) {
    const int m = i / (TN / 4), col = n_base + 4 * (i % (TN / 4));
    if (col < Ns) *reinterpret_cast<float4*>(y + (size_t)m * Ns + col) = v4[i];
  }
}

// Dynamic shared memory of a launch: the ring, or vals [MP][TN] if larger.
template <int NT>
constexpr int txn_smem() {
  return STAGES * TxnStage<NT>::BYTES > 8 * NT * TN * 4 ? STAGES * TxnStage<NT>::BYTES
                                                         : 8 * NT * TN * 4;
}

template <int NT>
cudaError_t txn_launch_nt(dim3 grid, cudaStream_t st, const void* x, const void* sx,
                          const void* qs, const void* sc, const void* bias, void* y,
                          void* partial, void* counters, int M, int K, int Ns, int S,
                          const int* te) {
  constexpr int smem = txn_smem<NT>();
  static_assert(smem <= 48 * 1024, "over the default dynamic shared memory limit");
  qmm_txn_kernel<NT><<<grid, TXN_THREADS, smem, st>>>(
      (const int8_t*)x, (const float*)sx, (const uint8_t*)qs, (const __nv_bfloat16*)sc,
      (const __nv_bfloat16*)bias, (float*)y, (float*)partial, (int*)counters, M, K, Ns, S,
      te);
  return cudaGetLastError();
}

// One launch of grid (column tiles, S, tiles) at NT = ceil(M / 8).
inline cudaError_t txn_launch(dim3 grid, cudaStream_t st, const void* x, const void* sx,
                              const void* qs, const void* sc, const void* bias, void* y,
                              void* partial, void* counters, int M, int K, int Ns, int S,
                              const int* te) {
  auto f = txn_launch_nt<4>;
  switch ((M + 7) / 8) {
    case 1: f = txn_launch_nt<1>; break;
    case 2: f = txn_launch_nt<2>; break;
    case 3: f = txn_launch_nt<3>; break;
  }
  return f(grid, st, x, sx, qs, sc, bias, y, partial, counters, M, K, Ns, S, te);
}

}  // namespace qmm
