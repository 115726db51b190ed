// qmm_routed: the routed (expert-indexed) M=1 GEMVs of a MoE decode step,
//   out[s, :] = x[ti[s], :] @ W[ei[s]]        for every slot s of S,
// over expert-stacked weights, all S slots in one launch.
//
// Replaces the TPU kernels _qmm_kernel_txn_m1_r (q4b, llamafile_tpu/ops/
// qmatmul.py:867, call :875) and _qmm_kernel_q8_m1_r (q8b, g 16 or 32,
// :948, call :956). There the expert ids ei and token rows ti rode scalar
// prefetch; here each block reads its slot's ei[s] and ti[s] from device
// memory (blockIdx.z is the slot) and offsets its weight and activation
// pointers, so the router's on-device top-k feeds the kernel with no copy
// to the host. Under stacked layers the ids are li*E + e into the merged
// [L*E, ...] stacks. The math per slot is qmm_txn_m1's (q4b, with the
// fused bias) and qmm_q8_m1's (q8b).
//
// What bounds it on an H100: device-memory bytes of the S routed experts'
// weights (a Mixtral-width gate|up expert is 58.7 MB of q4b codes, scales
// and bias; S = 2 at a decode step). Each slot runs the split-K GEMV of
// qmm_m1.cuh (q4b: a cluster of a tile's splits) or qmm_q8.cuh (q8b: its
// own partials and tile counters), so the slots' sums are independent and
// in a fixed order; two slots that name one expert read its bytes twice
// (the second mostly from L2).
#include "qmm_m1.cuh"
#include "qmm_q8.cuh"

using namespace qmm;

// x int8 [M, K], sx f32 [M, K/32]; qs uint8 [E, K/2, Ns], sc (and bias)
// bf16 [E, K/32, Ns]; ei, ti int32 [slots]; y f32 [slots, Ns]. K % 256 ==
// 0, Ns % 16 == 0, 1 <= S <= min(K / 64, M1_MAX_SPLITS).
extern "C" int qmm_txn_m1_r(const void* x, const void* sx, const void* qs, const void* sc,
                            const void* bias, void* y, const void* ei, const void* ti, int K,
                            int Ns, int S, int slots, void* stream) {
  if (K < 256 || K % 256 || Ns < 16 || Ns % 16 || S < 1 || S > K / 64 || slots < 1)
    return (int)cudaErrorInvalidValue;
  return (int)m1_gemv_launch(dim3((Ns + TN - 1) / TN, S, slots), (cudaStream_t)stream, x, sx,
                             qs, sc, bias, y, K, Ns, (const int*)ei, (const int*)ti);
}

// The same on q8b codes: qs int8 [E, K, Ns], sc (and bias) bf16 [E, K/g, Ns].
extern "C" int qmm_q8_m1_r(const void* x, const void* sx, const void* qs, const void* sc,
                           const void* bias, void* y, void* partial, void* counters,
                           const void* ei, const void* ti, int K, int Ns, int g, int S,
                           int slots, void* stream) {
  return launch_q8_m1(x, sx, qs, sc, bias, y, partial, counters, K, Ns, g, S, slots, ei, ti,
                      (cudaStream_t)stream);
}
