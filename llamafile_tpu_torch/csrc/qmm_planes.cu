// qmm_planes: the q4b two-plane prefill GEMM on Hopper tensor cores.
//
// Replaces the TPU kernel _qmm_kernel_planes (llamafile_tpu/ops/qmatmul.py
// :117), called by _qmm_call_planes (:166) for every unstacked q4b product
// of M > 32 rows: the prefill of a model whose layers differ in format and
// run unrolled (a Q4_K_M file). What it computes:
//   y[M, Ns] = x_even @ bf16(lo * s_lo) + x_odd @ bf16(hi * s_hi)
// with x_even / x_odd the even and odd 128-wide K chunks of each
// 256-superblock of x (bf16), lo = p & 0x0F and hi = int8((p ^ 0x80) & 0xF0)
// the two planes of each packed byte p of qs (uint8 [K/2, Ns]), and s_lo /
// s_hi the scale rows r % 8 < 4 and r % 8 >= 4 of the bf16 scales
// [K/32, Ns] (the hi rows pre-folded by repack._fold_hi_plane). Each weight
// product is rounded once to bf16, accumulation is f32, and the output is
// f32 below M = 256 and bf16 from M = 256, rounded once in this kernel's
// epilogue (_qmm_call_planes :191). The bias term stays with the caller, as
// there.
//
// What bounds it on an H100: operations (2 M K N over the 989 TFLOP/s bf16
// peak; gate|up of llama3-8b at M = 1024 is 2.4e11 FLOP, 0.24 ms). Design:
// the GEMM body of qmm_gemm.cuh, whose q4b K step reads each packed byte
// once and writes both of its nibbles, dequantized, into the lo-plane and
// hi-plane rows of the shared B tile that the bf16 mma.sync consumes; the
// A tile takes the matching even/odd chunk columns of x. The bf16 epilogue
// halves the output bytes of the large-M products, as on the TPU.
#include "qmm_gemm.cuh"

// x bf16 [M, K], K % 256 == 0; qs uint8 [K/2, Ns]; sc bf16 [K/32, Ns];
// y f32 [M, Ns], or bf16 when bf16_out; Ns % 16 == 0.
extern "C" int qmm_planes(const void* x, const void* qs, const void* sc, void* y, int M,
                          int K, int Ns, int bf16_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || Ns % 16 || K % 256) return (int)cudaErrorInvalidValue;
  if (bf16_out) return launch_gemm<true, 32, true>(x, qs, sc, y, M, K, Ns, st);
  return launch_gemm<true, 32, false>(x, qs, sc, y, M, K, Ns, st);
}
