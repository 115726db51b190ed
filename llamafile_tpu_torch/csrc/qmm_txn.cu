// qmm_txn: the q4b product for 2 <= M <= 32 rows (prefill of a prompt whose
// bucket is 16 or 32, and later the batched decode of the server).
//
// Replaces the TPU kernels _qmm_kernel_txn (llamafile_tpu/ops/qmatmul.py:276)
// and _qmm_kernel_txn_l (:396); the stacked form is the same kernel on the
// pointer of layer li's slice. Per row, the math is qmm_txn_m1's: exact int32
// group dots of int8 activations (natural K-group order) against the 4-bit
// codes, times the bf16 group scale and the activation scale, plus the fused
// bias on the bf16-rounded activation group sums.
//
// What bounds it on an H100: device-memory bytes at M <= 32 (the weights are
// read once for all rows: 4M int8 operations a weight byte, 128 at M = 32,
// under the ~590 operations a byte of the int8 tensor cores); short of them,
// instructions (copy issue at small M, the f32 fold at M = 32) and the
// split-K combine of small grids. The design (qmm_txn.cuh) keeps chunks of
// weights, scales, bias and activation codes in flight a block through a
// 4-stage cp.async ring in shared memory, with one block barrier a chunk,
// and does the int8 math on s8 mma.sync tensor cores (one m16n8k32 is one
// group's exact dot for 16 columns x 8 rows), each warp on its own 32
// columns. K is split over S blocks with the fixed-order combine of
// qmm_common.cuh, so two launches on the same inputs give the same bits.
#include "qmm_txn.cuh"

using namespace qmm;

extern "C" int qmm_txn(const void* x, const void* sx, const void* qs,
                       const void* sc, const void* bias, void* y, void* partial,
                       void* counters, int M, int K, int Ns, int S, void* stream) {
  if (M < 1 || M > MAXM || K < 256 || K % 256 || Ns < 16 || Ns % 16 || S < 1 || S > K / 64)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Ns + TN - 1) / TN, S);
  return (int)txn_launch(grid, (cudaStream_t)stream, x, sx, qs, sc, bias, y, partial,
                         counters, M, K, Ns, S, nullptr);
}
