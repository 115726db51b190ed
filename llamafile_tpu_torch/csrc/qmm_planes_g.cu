// qmm_planes_g: the grouped q4b two-plane GEMM of a MoE layer at prefill
// scale (routed slots past 512): row tile i of 128 rows multiplies expert
// te[i]'s weights, the bias term fused.
//
// Replaces the TPU kernel _qmm_kernel_planes_g (llamafile_tpu/ops/qmatmul.py
// :1432, call _qmm_call_planes_grouped :1458). What it computes, per row
// tile i with e = te[i]:
//   y = x_even @ bf16(lo * s_lo[e]) + x_odd @ bf16(hi * s_hi[e])
//     + bf16(sum_32 x) @ bias[e]
// (qmm_planes's two-plane product on bf16(x), see qmm_planes.cu), with two
// numerics of the grouped TPU kernel kept: the bias term is dotted in the
// kernel into the same f32 accumulator before the single output rounding
// (the dense planes path adds it outside, in y's dtype), from bx = the
// bf16-rounded f32 sums of each 32 of the unrounded x; and the output is
// bf16 when the padded row count reaches 256, else f32 (:1497).
//
// What bounds it on an H100: operations (2 S_pad K N over the 989 TFLOP/s
// bf16 peak), or the bytes of the distinct experts te names, whichever is
// larger. Design: the GEMM body of qmm_gemm.cuh (128 x 128 tiles on
// mma.sync, each packed byte read once for both planes) with the expert's
// weight pointer chosen per row tile and the bias term run as K/32 extra
// K steps (bx as A, the expert's bias rows as B) before the epilogue.
#include "qmm_gemm.cuh"

// x bf16 [tiles * 128, K], K % 256 == 0; qs uint8 [E, K/2, Ns]; sc bf16
// [E, K/32, Ns]; te int32 [tiles]; bx bf16 [tiles * 128, K/32] and bias
// bf16 [E, K/32, Ns], or both null; y f32 or bf16 [tiles * 128, Ns];
// Ns % 16 == 0.
extern "C" int qmm_planes_g(const void* x, const void* qs, const void* sc, const void* te,
                            const void* bx, const void* bias, void* y, int tiles, int K,
                            int Ns, int bf16_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles < 1 || Ns % 16 || K % 256 || te == nullptr || (bx == nullptr) != (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = tiles * BM;
  if (bf16_out) return launch_gemm<true, 32, true>(x, qs, sc, y, M, K, Ns, st, te, bx, bias);
  return launch_gemm<true, 32, false>(x, qs, sc, y, M, K, Ns, st, te, bx, bias);
}
