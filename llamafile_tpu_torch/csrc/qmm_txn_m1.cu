// qmm_txn_m1: the M=1 (decode) q4b GEMV on Hopper.
//
// Replaces the TPU kernel _qmm_kernel_txn_m1 (llamafile_tpu/ops/qmatmul.py:457)
// and its layer-stacked form _qmm_kernel_txn_m1_l (:608): the caller passes
// the pointer of layer li's slice of the stacked [L, K/2, Ns] arrays, so the
// stacked weights are indexed in place with no copy.
//
// What bounds it on an H100: device-memory bytes. A decode GEMV reads every
// weight byte once (4.5 bits a weight plus bf16 scales and bias) and does two
// int8 operations a weight, far below the card's ~590 ops/byte int8 ridge;
// short of the bytes, at small N (qkv, o) the fixed cost of a launch. The
// design (qmm_m1.cuh) keeps each warp's next chunks of weights, scales and
// bias rows in flight through a cp.async ring of its own in shared memory,
// stages the block's activations once, does the int8 math on __dp4a after
// a 4x4 byte transpose, and splits K over the fewest blocks that fill the
// card by bytes in flight (ops.qmatmul.m1_split), a tile's splits one
// thread-block cluster summed in a fixed order through distributed shared
// memory, so results do not vary run to run and need no scratch.
// The TPU kernel's block-diagonal activation layout fed its 128-wide MXU; the
// GPU has no use for it and reads the natural int8 codes.
#include "qmm_m1.cuh"

using namespace qmm;

// x int8 [K], sx f32 [K/32]; qs uint8 [K/2, Ns], sc (and bias) bf16
// [K/32, Ns]; y f32 [Ns]. K % 256 == 0, Ns % 16 == 0, 1 <= S <= min(K / 64,
// M1_MAX_SPLITS).
extern "C" int qmm_txn_m1(const void* x, const void* sx, const void* qs,
                          const void* sc, const void* bias, void* y, int K, int Ns, int S,
                          void* stream) {
  if (K < 256 || K % 256 || Ns < 16 || Ns % 16 || S < 1 || S > K / 64)
    return (int)cudaErrorInvalidValue;
  return (int)m1_gemv_launch(dim3((Ns + TN - 1) / TN, S), (cudaStream_t)stream, x, sx, qs,
                             sc, bias, y, K, Ns, nullptr, nullptr);
}
