// flash_decode: T=1 GQA decode attention over one layer of a dense KV cache,
// bf16 or int8 codes with per-(position, head) f32 scales.
//
// Replaces the TPU kernels _flash_decode_kernel (llamafile_tpu/ops/
// attention.py:117, via flash_decode :403) and _flash_decode_qt_kernel
// (:161, via flash_decode_stacked :460); the second computes the first's
// function on layer li of the flat stacked cache, and here both are one
// kernel given layer li's pointer. Inputs:
//   q       [B, Hq, D] f32
//   k, v    [B, S, Hkv, D] (element (b, j, h, d) at b * sb + (j * Hkv + h) *
//           D + d: a bf16 flat [L, B, S, Hkv*D] cache's layer li, or an int8
//           [L, B, S, Hkv, D] cache's, sliced to s_eff positions, no copy)
//   ks, vs  [B, S, Hkv] f32 scales at b * ssb + j * Hkv + h (int8 only)
//   pos     [B] int32: key j is visible iff j <= pos[b], j < s_eff, and
//           j > pos[b] - win when win > 0.
// Numerics of the TPU kernel: scores are f32 dots times `scale`, softmax
// in f32 with its -1e30 mask, the output acc / max(l, 1e-30). A bf16 cache
// rounds q and p to bf16 (the TPU kernel's q2.astype(k.dtype) and
// p.astype(v.dtype)) while l sums the f32 p; an int8 cache computes on the
// dequantized f32 K/V, as the reference hands the kernel f32 K/V: each code
// is multiplied by its f32 scale here, in registers, the same f32 product,
// so no f32 copy of the layer is made.
//
// What bounds it on an H100: device-memory bytes of the visible rows, B *
// n_visible * Hkv * D * 2 (K and V) * (2 B for bf16 | 1 B + 4 B / D for
// int8); about 2 G flops a byte. Design (that of paged_attention.cu): pass
// 1 runs one block per (split of the positions, head chunk, KV head, batch
// row); the 8 half-warps of a block each take one key row at a time, 16
// lanes x 8 dims (one 16-byte load a lane for bf16), so the query heads of
// the chunk share every K/V row loaded; each half-warp keeps an online
// softmax and the block merges them in half-warp order. A group of G <= 8
// query heads is one chunk, an instance of its own (GC = G, a constant:
// nothing masked); a larger group runs as NC = ceil(G / 8) chunks of GC =
// ceil(G / NC) heads on the grid's y axis beside the KV head (the last
// chunk masks heads past G), each reading the K/V rows again.
// Splits with no visible row write a neutral partial (m = -1e30, l = 0).
// Pass 2 combines the splits of each (row, query head) in split order; the
// scratch is indexed by query head. Both merges are in a fixed order, so
// the result is the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int NW = 4;           // warps a block
constexpr int NH = 2 * NW;      // half-warps a block
constexpr int U = 2;            // key rows in flight a half-warp
constexpr float NEG = -1e30f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

__device__ __forceinline__ float half_sum(float v) {
  // the 16 lanes of one half-warp; both halves run it together
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// GC: query heads a chunk (compile time); G: the group, Hq = Hkv * G;
// ONE: the group is one chunk (G = GC <= 8), so G and the chunk are
// known at compile time and no head is masked
template <typename T, int GC, bool ONE>
__global__ void __launch_bounds__(NW * 32)
fd_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ pos,
                float* __restrict__ m_part, float* __restrict__ l_part,
                float* __restrict__ acc_part, int Hkv, int G, int s_eff, long long sb,
                long long ssb, int win, int chunk, int n_split, float scale) {
  constexpr bool BF = sizeof(T) == 2;            // bf16 cache: round q and p
  if (ONE) G = GC;
  const int s = blockIdx.x, b = blockIdx.z;
  const int c = ONE ? 0 : blockIdx.y / Hkv, h = blockIdx.y - c * Hkv;   // head chunk, KV head
  const int gn = min(GC, G - c * GC);            // the chunk's heads below G
  const int p = pos[b];
  const int vis_lo = win > 0 ? max(0, p - win + 1) : 0;
  const int j_lo = max(vis_lo, s * chunk);
  const int j_hi = min(min(p + 1, s_eff), (s + 1) * chunk);
  const int lane = threadIdx.x & 15, half = (threadIdx.x >> 4) & 1;
  const int warp = threadIdx.x >> 5, hw = threadIdx.x >> 4;
  // query head of the chunk's head 0: heads h * G + c * GC + g, g < gn
  const size_t qh0 = (size_t)b * Hkv * G + (size_t)h * G + c * GC;
  const T* kb = k + (size_t)b * sb + (size_t)h * D + 8 * lane;
  const T* vb = v + (size_t)b * sb + (size_t)h * D + 8 * lane;

  float qv[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = g < gn ? q[(qh0 + g) * D + 8 * lane + e] : 0.f;
      qv[g][e] = BF ? bf16_round(x) : x;
    }

  float m[GC], l[GC], acc[GC][8];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // rows j0 + u * NH + half of each warp step; the bound test on j0 is
  // uniform across the warp, so both halves reach every shuffle together
  for (int j0 = j_lo + 2 * warp; j0 < j_hi; j0 += NH * U) {
    float kf[U][8], vf[U][8];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NH + half;
      ok[u] = j < j_hi;
      if (ok[u]) {
        const size_t row = (size_t)j * Hkv * D;
        load8(kb + row, kf[u]);
        load8(vb + row, vf[u]);
        if (!BF) {
          const size_t o = (size_t)b * ssb + (size_t)j * Hkv + h;
          const float a = ks[o], c = vs[o];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[u][e] *= a;
            vf[u][e] *= c;
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
        sc = half_sum(sc) * scale;
        if (ok[u]) {
          const float mn = fmaxf(m[g], sc);
          const float corr = expf(m[g] - mn);
          const float pp = expf(sc - mn);
          l[g] = l[g] * corr + pp;
          const float pv = BF ? bf16_round(pp) : pp;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = acc[g][e] * corr + pv * vf[u][e];
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

// one block per (query head, batch row), one thread per output dim
__global__ void __launch_bounds__(D)
fd_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                  const float* __restrict__ acc_part, float* __restrict__ out, int Hq,
                  int n_split) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t o0 = ((size_t)b * Hq + hq) * n_split;
  float mx = NEG;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[o0 + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float f = expf(m_part[o0 + s] - mx);
    L += l_part[o0 + s] * f;
    A += acc_part[(o0 + s) * D + d] * f;
  }
  out[((size_t)b * Hq + hq) * D + d] = A / fmaxf(L, 1e-30f);
}

template <typename T, int GC, bool ONE>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pos, void* out, void* m_part, void* l_part, void* acc_part, int B,
           int Hkv, int G, int s_eff, long long sb, long long ssb, int win, int chunk,
           int n_split, float scale, cudaStream_t st) {
  const int smem = (2 * NH * GC + NH * GC * D) * (int)sizeof(float);
  static bool smem_set = false;      // once, so later launches can be captured
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_split_kernel<T, GC, ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nc = (G + GC - 1) / GC;              // head chunks a group
  fd_split_kernel<T, GC, ONE><<<dim3(n_split, Hkv * nc, B), NW * 32, smem, st>>>(
      (const float*)q, (const T*)k, (const T*)v, (const float*)ks, (const float*)vs,
      (const int*)pos, (float*)m_part, (float*)l_part, (float*)acc_part, Hkv, G, s_eff, sb,
      ssb, win, chunk, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fd_combine_kernel<<<dim3(Hkv * G, B), D, 0, st>>>(
      (const float*)m_part, (const float*)l_part, (const float*)acc_part, (float*)out,
      Hkv * G, n_split);
  return (int)cudaGetLastError();
}

// the instance of the group: G <= 8 is one chunk of G heads, a larger group
// ceil(G / 8) chunks of gc = ceil(G / ceil(G / 8)) heads, 5 <= gc <= 8
template <typename T>
int dispatch(int G, const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* m_part, void* l_part,
             void* acc_part, int B, int Hkv, int s_eff, long long sb, long long ssb,
             int win, int chunk, int n_split, float scale, cudaStream_t st) {
  const int nc = (G + 7) / 8, gc = (G + nc - 1) / nc;
#define FD_CASE(L, N, ONE)                                                                   \
  case L:                                                                                    \
    return launch<T, N, ONE>(q, k, v, ks, vs, pos, out, m_part, l_part, acc_part, B, Hkv, G, \
                             s_eff, sb, ssb, win, chunk, n_split, scale, st);
  switch (G <= 8 ? G : -gc) {
    FD_CASE(1, 1, true) FD_CASE(2, 2, true) FD_CASE(3, 3, true) FD_CASE(4, 4, true)
    FD_CASE(5, 5, true) FD_CASE(6, 6, true) FD_CASE(7, 7, true) FD_CASE(8, 8, true)
    FD_CASE(-5, 5, false) FD_CASE(-6, 6, false) FD_CASE(-7, 7, false) FD_CASE(-8, 8, false)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_CASE
}

}  // namespace

// int8 != 0: k/v hold int8 codes and ks/vs their f32 scales; else bf16 and
// ks = vs = NULL. sb / ssb: batch strides of k, v and of ks, vs in elements.
// Split s covers positions [s * chunk, (s + 1) * chunk). m_part/l_part
// [B, Hq, n_split], acc_part [B, Hq, n_split, D] f32 scratch from the caller.
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* ks,
                            const void* vs, const void* pos, void* out, void* m_part,
                            void* l_part, void* acc_part, int B, int Hq, int Hkv,
                            int s_eff, long long sb, long long ssb, int win, int chunk,
                            int n_split, int int8, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq < Hkv || Hq % Hkv || chunk <= 0 || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (int8)
    return dispatch<int8_t>(G, q, k, v, ks, vs, pos, out, m_part, l_part, acc_part, B, Hkv,
                            s_eff, sb, ssb, win, chunk, n_split, scale, st);
  return dispatch<__nv_bfloat16>(G, q, k, v, nullptr, nullptr, pos, out, m_part, l_part,
                                 acc_part, B, Hkv, s_eff, sb, ssb, win, chunk, n_split,
                                 scale, st);
}
