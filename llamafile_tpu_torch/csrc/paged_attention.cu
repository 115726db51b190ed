// paged_attention: batched T=1 GQA decode attention over a paged KV pool,
// one layer, bf16 pages or int8 pages with per-(head, position) f32 scales.
//
// Replaces the upstream Pallas TPU kernel paged_attention
// (jax/experimental/pallas/ops/tpu/paged_attention/paged_attention_kernel.py,
// online softmax :261-287), which llamafile_tpu/runtime/paged.py paged_attend
// (:253) calls at :277. Its math is all f32: q arrives in f32 already scaled
// by 1/sqrt(D), K and V are promoted to f32 (int8 codes times their f32
// scale), and so is the softmax. Inputs:
//   q       [R, Hq, D] f32
//   k, v    one layer of the pool, [Hkv, P, ps, D] bf16 or int8 (the
//           caller passes the layer's pointer: no slice is copied)
//   ks, vs  [Hkv, P, ps] f32 scales (int8 only)
//   lengths [R] int32 (>= 1), tables [R, MAXP] int32 page ids
// Output [R, Hq, D] f32. Query head h reads KV head h / G (G = Hq / Hkv);
// key j of row r is visible when j < lengths[r] and lives at page
// tables[r, j / ps], offset j % ps.
//
// What bounds it on an H100: device-memory bytes, sum over rows of
// length_r * Hkv * D * 2 (K and V) * (2 B for bf16 | 1 B + 4 B / D of scale
// for int8); about 4 * G flops a byte. Design: pass 1 runs one block per
// (split of the row's pages, head chunk, KV head, row). A split covers
// `pps` pages; splits past the row's length return at once, and no page
// past ceil(length / ps) is read. A row group of D / 8 lanes (a half-warp
// at D = 128, a warp at D = 256) takes one key row at a time, 8 dims a lane
// (one 16-byte load a lane for bf16), so the query heads of the chunk share
// every K/V row loaded; each row group keeps an online softmax in f32 and
// the block merges them in group order. (At D = 256, 16 dims a lane of a
// half-warp would hold q and acc in 256 registers at G = 8; a warp a row
// keeps them at D = 128's 128.) A group of G <= 8 query heads is one
// chunk, an instance of its own (GC = G, a constant: nothing masked); a
// larger group runs as NC = ceil(G / 8) chunks of GC = ceil(G / NC) heads
// on the grid's y axis beside the KV head (the last chunk masks heads past
// G), each reading the K/V rows again. Pass 2 combines the splits of each
// (row, query head) in split order; the scratch is indexed by query head.
// Both merges are in a fixed order, so the result is the same from run to
// run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;           // warps a block
constexpr int U = 2;            // key rows in flight a row group
constexpr float NEG = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __low2float(h[i]);
    out[2 * i + 1] = __high2float(h[i]);
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)c[i];
}

// the sum over the LN lanes of one row group; every group of the warp runs it
template <int LN>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LN / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// D: head dim (128 or 256); GC: query heads a chunk (compile time); G: the
// group, Hq = Hkv * G; ONE: the group is one chunk (G = GC <= 8), so G and
// the chunk are known at compile time and no head is masked
template <typename T, int D, int GC, bool ONE>
__global__ void __launch_bounds__(NW * 32)
pa_split_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                const T* __restrict__ vp, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ lengths,
                const int* __restrict__ tables, float* __restrict__ m_part,
                float* __restrict__ l_part, float* __restrict__ acc_part,
                int Hkv, int G, int P, int ps, int maxp, int pps, int n_split) {
  constexpr int LN = D / 8;       // lanes a row group: 8 dims each
  constexpr int NR = 32 / LN;     // row groups a warp
  constexpr int NH = NW * NR;     // row groups a block
  if (ONE) G = GC;
  const int s = blockIdx.x, r = blockIdx.z;
  const int c = ONE ? 0 : blockIdx.y / Hkv, h = blockIdx.y - c * Hkv;   // head chunk, KV head
  const int gn = min(GC, G - c * GC);            // the chunk's heads below G
  const int len = lengths[r];
  const int j_lo = s * pps * ps;
  if (j_lo >= len) return;                       // nothing visible here
  const int j_hi = min(len, j_lo + pps * ps);
  const int lane = threadIdx.x % LN, half = (threadIdx.x / LN) % NR;
  const int warp = threadIdx.x >> 5, hw = threadIdx.x / LN;
  const int* trow = tables + (size_t)r * maxp;
  const size_t head0 = (size_t)h * P;            // page index base of head h
  // query head of the chunk's head 0: heads h * G + c * GC + g, g < gn
  const size_t qh0 = (size_t)r * Hkv * G + (size_t)h * G + c * GC;

  float qv[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qv[g][e] = g < gn ? q[(qh0 + g) * D + 8 * lane + e] : 0.f;

  float m[GC], l[GC], acc[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // rows j0 + u * NH + half of each warp step; the bound test on j0 is
  // uniform across the warp, so its row groups reach every shuffle together
  for (int j0 = j_lo + NR * warp; j0 < j_hi; j0 += NH * U) {
    float kf[U][8], vf[U][8];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NH + half;
      ok[u] = j < j_hi;
      if (ok[u]) {
        const size_t row = (head0 + trow[j / ps]) * ps + (j % ps);
        load8(kp + row * D + 8 * lane, kf[u]);
        load8(vp + row * D + 8 * lane, vf[u]);
        if (ks != nullptr) {
          const float a = ks[row], b = vs[row];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[u][e] *= a;
            vf[u][e] *= b;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u * NH >= j_hi) break;            // uniform across the warp
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float sc = 0.f;
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sc += qv[g][e] * kf[u][e];
        }
        sc = group_sum<LN>(sc);
        if (ok[u]) {
          const float mn = fmaxf(m[g], sc);
          const float corr = expf(m[g] - mn);
          const float pp = expf(sc - mn);
          l[g] = l[g] * corr + pp;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = acc[g][e] * corr + pp * vf[u][e];
          m[g] = mn;
        }
      }
    }
  }

  extern __shared__ float smem[];
  float* sm = smem;                              // [NH][GC]
  float* sl = sm + NH * GC;                      // [NH][GC]
  float* sacc = sl + NH * GC;                    // [NH][GC][D]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm[hw * GC + g] = m[g];
      sl[hw * GC + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sacc[(hw * GC + g) * D + 8 * lane + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = NEG;
    for (int w = 0; w < NH; ++w) mx = fmaxf(mx, sm[w * GC + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NH; ++w) {
      const float f = expf(sm[w * GC + g] - mx);
      L += sl[w * GC + g] * f;
      A += sacc[(w * GC + g) * D + d] * f;
    }
    const size_t o = (qh0 + g) * n_split + s;        // scratch by query head
    acc_part[o * D + d] = A;
    if (d == 0) {
      m_part[o] = mx;
      l_part[o] = L;
    }
  }
}

// one block per (query head, row), one thread per output dim
template <int D>
__global__ void __launch_bounds__(D)
pa_combine_kernel(const float* __restrict__ m_part,
                  const float* __restrict__ l_part,
                  const float* __restrict__ acc_part,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  int Hq, int pps, int ps, int n_split) {
  const int hq = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int n_live = min(n_split, (lengths[r] + pps * ps - 1) / (pps * ps));
  const size_t o0 = ((size_t)r * Hq + hq) * n_split;
  float mx = NEG;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, m_part[o0 + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float f = expf(m_part[o0 + s] - mx);
    L += l_part[o0 + s] * f;
    A += acc_part[(o0 + s) * D + d] * f;
  }
  out[((size_t)r * Hq + hq) * D + d] = A / fmaxf(L, 1e-30f);
}

template <typename T, int D, int GC, bool ONE>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, const void* tables, void* out,
           void* m_part, void* l_part, void* acc_part, int R, int Hkv, int G, int P,
           int ps, int maxp, int pps, int n_split, cudaStream_t st) {
  constexpr int NH = NW * 32 / (D / 8);   // the kernel's row groups a block
  const int smem = (2 * NH * GC + NH * GC * D) * (int)sizeof(float);
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        pa_split_kernel<T, D, GC, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nc = (G + GC - 1) / GC;              // head chunks a group
  pa_split_kernel<T, D, GC, ONE><<<dim3(n_split, Hkv * nc, R), NW * 32, smem, st>>>(
      (const float*)q, (const T*)k, (const T*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (const int*)tables,
      (float*)m_part, (float*)l_part, (float*)acc_part, Hkv, G, P, ps, maxp, pps,
      n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pa_combine_kernel<D><<<dim3(Hkv * G, R), D, 0, st>>>(
      (const float*)m_part, (const float*)l_part, (const float*)acc_part,
      (const int*)lengths, (float*)out, Hkv * G, pps, ps, n_split);
  return (int)cudaGetLastError();
}

// the instance of the group: G <= 8 is one chunk of G heads, a larger group
// ceil(G / 8) chunks of gc = ceil(G / ceil(G / 8)) heads, 5 <= gc <= 8
template <typename T, int D>
int dispatch(int G, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* lengths,
             const void* tables, void* out, void* m_part, void* l_part,
             void* acc_part, int R, int Hkv, int P, int ps, int maxp, int pps,
             int n_split, cudaStream_t st) {
  const int nc = (G + 7) / 8, gc = (G + nc - 1) / nc;
#define PA_CASE(L, N, ONE)                                                             \
  case L:                                                                              \
    return launch<T, D, N, ONE>(q, k, v, ks, vs, lengths, tables, out, m_part, l_part,\
                             acc_part, R, Hkv, G, P, ps, maxp, pps, n_split, st);
  switch (G <= 8 ? G : -gc) {
    PA_CASE(1, 1, true) PA_CASE(2, 2, true) PA_CASE(3, 3, true) PA_CASE(4, 4, true)
    PA_CASE(5, 5, true) PA_CASE(6, 6, true) PA_CASE(7, 7, true) PA_CASE(8, 8, true)
    PA_CASE(-5, 5, false) PA_CASE(-6, 6, false) PA_CASE(-7, 7, false) PA_CASE(-8, 8, false)
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

// int8 != 0: k/v hold int8 codes and ks/vs their scales; else bf16 and
// ks = vs = NULL. D: the head dim, 128 or 256. m_part/l_part [R, Hq,
// n_split], acc_part [R, Hq, n_split, D] f32 scratch from the caller.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs,
                               const void* lengths, const void* tables,
                               void* out, void* m_part, void* l_part,
                               void* acc_part, int R, int Hq, int Hkv, int D,
                               int P, int ps, int maxp, int pps, int n_split,
                               int int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq < Hkv || Hq % Hkv) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
#define PA_DISPATCH(T, DD, KS, VS)                                                     \
  return dispatch<T, DD>(G, q, k, v, KS, VS, lengths, tables, out, m_part, l_part,    \
                         acc_part, R, Hkv, P, ps, maxp, pps, n_split, st)
  if (int8 && D == 128) PA_DISPATCH(int8_t, 128, ks, vs);
  if (int8 && D == 256) PA_DISPATCH(int8_t, 256, ks, vs);
  if (!int8 && D == 128) PA_DISPATCH(__nv_bfloat16, 128, nullptr, nullptr);
  if (!int8 && D == 256) PA_DISPATCH(__nv_bfloat16, 256, nullptr, nullptr);
#undef PA_DISPATCH
  return (int)cudaErrorInvalidValue;
}
