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
// What bounds it on an H100: still device-memory bytes at M <= 32 (the
// weights are read once for all rows: 32 rows x 2 ops a weight is ~130 int8
// ops a weight byte, under the ~590 ops/byte ridge). The design reads each
// 32-row weight chunk of a 128-column tile into shared memory once and
// reuses it for every row: warp w serves rows w, w+8, w+16, w+24. The
// activation codes of 32 rows x K = 14336 do not fit shared memory, so they
// are streamed chunk by chunk with the weights (64 bytes a row a chunk). K is
// split over S blocks with the fixed-order combine of qmm_common.cuh.
// __dp4a after a 4x4 byte transpose does the int8 math; a later version
// would move to s8 mma.sync and a cp.async pipeline.
#include "qmm_txn.cuh"

using namespace qmm;

extern "C" int qmm_txn(const void* x, const void* sx, const void* qs,
                       const void* sc, const void* bias, void* y, void* partial,
                       void* counters, int M, int K, int Ns, int S, void* stream) {
  if (M < 1 || M > MAXM) return (int)cudaErrorInvalidValue;
  dim3 grid((Ns + TN - 1) / TN, S);
  qmm_txn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const float*)sx, (const uint8_t*)qs,
      (const __nv_bfloat16*)sc, (const __nv_bfloat16*)bias, (float*)y,
      (float*)partial, (int*)counters, M, K, Ns, S, nullptr);
  return (int)cudaGetLastError();
}
