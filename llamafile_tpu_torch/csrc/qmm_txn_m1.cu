// qmm_txn_m1: the M=1 (decode) q4b GEMV on Hopper.
//
// Replaces the TPU kernel _qmm_kernel_txn_m1 (llamafile_tpu/ops/qmatmul.py:457)
// and its layer-stacked form _qmm_kernel_txn_m1_l (:608): the caller passes
// the pointer of layer li's slice of the stacked [L, K/2, Ns] arrays, so the
// stacked weights are indexed in place with no copy.
//
// What bounds it on an H100: device-memory bytes. A decode GEMV reads every
// weight byte once (4.5 bits a weight plus bf16 scales and bias) and does two
// int8 operations a weight, far below the card's ~590 ops/byte int8 ridge.
// The design therefore spends its effort on the stream:
//   * a warp reads whole 128-byte rows (lane = 4 adjacent columns), 32
//     independent row loads in flight per lane;
//   * the int8 math runs on __dp4a after a 4x4 byte transpose, so the ALU
//     stays well under the memory time;
//   * with N = 4096 there are only 32 column tiles of 128, so K is split
//     over 8 warps inside a block and over S blocks of the grid; the S
//     partials are summed in a fixed order by the last block of each tile
//     (integer counter, no float atomics), so results do not vary run to run.
// The TPU kernel's block-diagonal activation layout fed its 128-wide MXU; the
// GPU has no use for it and reads the natural int8 codes.
#include "qmm_common.cuh"

using namespace qmm;

extern "C" int qmm_txn_m1(const void* x, const void* sx, const void* qs,
                          const void* sc, const void* bias, void* y,
                          void* partial, void* counters, int K, int Ns, int S,
                          void* stream) {
  dim3 grid((Ns + TN - 1) / TN, S);
  m1_gemv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const float*)sx, (const uint8_t*)qs,
      (const __nv_bfloat16*)sc, (const __nv_bfloat16*)bias, (float*)y,
      (float*)partial, (int*)counters, K, Ns, S, nullptr, nullptr);
  return (int)cudaGetLastError();
}
