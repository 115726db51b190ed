// qmm_dequant: the bf16-dequant GEMM on Hopper tensor cores.
//
// Replaces the TPU kernel _qmm_kernel (llamafile_tpu/ops/qmatmul.py:1761)
// with its _dequant_tile (:93), reached through _qmm_call (:1775) for every
// stacked q4b product of M > 32 rows (prefill), every q8b product of M >= 2
// and every q8b g 8 product (IQ1_M), M = 1 too. The stacked caller passes
// the pointer of layer li's slice, so no slice copy is made (the
// reference's fallback copied the layer, :2079-2084). Output f32; the bias term stays outside (ops/qmatmul.py), as
// there. The GEMM body and its numerics are in qmm_gemm.cuh.
//
// What bounds it on an H100: operations at prefill sizes (gate|up at M =
// 2048 is 4.8e11 FLOP, 0.49 ms at 989 TFLOP/s) and weight bytes at small M.
// Design: qmm_gemm.cuh's body, 128 x 128 tiles on wgmma from shared memory,
// each weight tile dequantized once a block beside the previous step's
// tensor-core work.
#include "qmm_gemm.cuh"

// x bf16 [M, K]; qs uint8 [K/2, Ns] (q4b) or int8 [K, Ns] (q8b); sc bf16
// [K/g, Ns]; y f32 [M, Ns]. q4b needs K % 256 == 0 and g 32, q8b K % 64 == 0
// and g 8, 16 or 32; Ns % 16 == 0.
extern "C" int qmm_dequant(const void* x, const void* qs, const void* sc, void* y, int M,
                           int K, int Ns, int g, int q4, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || Ns % 16) return (int)cudaErrorInvalidValue;
  if (q4) {
    if (K % 256 || g != 32) return (int)cudaErrorInvalidValue;
    return launch_gemm<true, 32, false>(x, qs, sc, y, M, K, Ns, st);
  }
  if (K % BK) return (int)cudaErrorInvalidValue;
  if (g == 32) return launch_gemm<false, 32, false>(x, qs, sc, y, M, K, Ns, st);
  if (g == 16) return launch_gemm<false, 16, false>(x, qs, sc, y, M, K, Ns, st);
  if (g == 8) return launch_gemm<false, 8, false>(x, qs, sc, y, M, K, Ns, st);
  return (int)cudaErrorInvalidValue;
}
