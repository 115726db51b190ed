// qmm_int8: the q4b product for 1 <= M <= 32 rows under the int8 flavour
// (LLAMAFILE_TPU_Q4B=int8), on the small-M q4b body of qmm_txn (qmm_txn.cuh)
// with no bias term.
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
// plane 16q - 128, the fold in the scales); y f32 [M, Ns]. The bias term
// stays with the caller (qmatmul adds it outside, as the reference does).
// This is qmm_txn's product without its bias term, so the kernel is
// qmm_txn's body launched with no bias: the stage carries no bias rows and
// no bias sums, and the loop waits for one landed chunk, not two.
//
// What bounds it on an H100: device-memory bytes. Each weight byte is read
// once for all M <= 32 rows (64 int8 operations a byte at M = 32, far under
// the ~590 ops/byte ridge); short of the bytes, the f32 fold of the group
// dots at M = 32 and the split-K combine on small grids. The design is
// qmm_txn.cuh's: a 4-stage cp.async ring of weight chunks, scale rows and
// activation codes and scales, s8 mma.sync m16n8k32 in the swap-AB form (one
// mma is one group's exact int32 dot for 16 columns x 8 rows), each of 4
// warps on its own 32 columns, K split by ops.qmatmul.txn_split and summed
// in a fixed order (qmm_txn.cuh txn_combine), so two launches give the same
// bits. The order of the f32 sums is not that of the earlier body of this
// file (8 warps on 32 columns, summed in warp order), so its bits may differ
// from that body's, within the same 1e-5 of the plain version.
#include "qmm_txn.cuh"

using namespace qmm;

// x int8 [M, K]; sx f32 [M, K/32]; qs uint8 [K/2, Ns]; sc bf16 [K/32, Ns];
// y f32 [M, Ns]; partial f32 [S, M, Ns] and counters int32 [tiles] (zero, and
// left zero) are split-K scratch. 1 <= M <= 32, K % 256 == 0, Ns % 16 == 0,
// 1 <= S <= K / 64.
extern "C" int qmm_int8(const void* x, const void* sx, const void* qs, const void* sc,
                        void* y, void* partial, void* counters, int M, int K, int Ns,
                        int S, void* stream) {
  if (M < 1 || M > MAXM || K < 256 || K % 256 || Ns < 16 || Ns % 16 || S < 1 || S > K / 64)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Ns + TN - 1) / TN, S);
  return (int)txn_launch(grid, (cudaStream_t)stream, x, sx, qs, sc, nullptr, y, partial,
                         counters, M, K, Ns, S, nullptr);
}
