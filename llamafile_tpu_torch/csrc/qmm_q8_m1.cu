// qmm_q8_m1: the M=1 (decode) GEMV on int8-stored weights (q8b: Q8_0 with
// g = 32, Q6_K with g = 16) on Hopper.
//
// Replaces the TPU kernel _qmm_kernel_q8_m1 (llamafile_tpu/ops/qmatmul.py:684)
// and its layer-stacked form _qmm_kernel_q8_m1_l (:780): the caller passes
// the pointer of layer li's slice of the stacked [L, K, Ns] codes, so the
// stacked weights are indexed in place with no copy. The math and the
// kernel are in qmm_q8.cuh.
//
// What bounds it on an H100: device-memory bytes. Every weight byte is read
// once (one int8 code a weight plus a bf16 scale per g), two int8 operations
// a byte, far under the card's int8 ridge; the design spends its effort on
// the stream (qmm_q8.cuh), and the fixed-order split-K combine keeps results
// the same run to run.
#include "qmm_q8.cuh"

using namespace qmm;

// x int8 [K], sx f32 [K/32], qs int8 [K, Ns], sc (and bias) bf16 [K/g, Ns],
// y f32 [Ns]. K % 32 == 0, Ns % 4 == 0, g 16 or 32.
extern "C" int qmm_q8_m1(const void* x, const void* sx, const void* qs, const void* sc,
                         const void* bias, void* y, void* partial, void* counters, int K,
                         int Ns, int g, int S, void* stream) {
  return launch_q8_m1(x, sx, qs, sc, bias, y, partial, counters, K, Ns, g, S, 1, nullptr,
                      nullptr, (cudaStream_t)stream);
}
