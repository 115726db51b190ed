// qmm_txn_g: the grouped q4b product of a MoE layer at small routed-slot
// counts (serving steps of more slots than experts, prompts of up to 256
// tokens): row tile i of x (tm = 8 or 32 rows) multiplies expert te[i]'s
// weights.
//
// Replaces the TPU kernel _qmm_kernel_txn_g (llamafile_tpu/ops/qmatmul.py
// :1373, call _qmm_call_txn_grouped :1381), whose per-tile expert map rode
// scalar prefetch; here blockIdx.z is the row tile and each block reads
// te[z] from device memory. The caller (models/llama.py
// grouped_expert_ffn) sorts the routed (token, expert) rows by expert and
// pads each expert's group to a multiple of tm with zero rows, which give
// zero outputs. Per row, the math is qmm_txn's: the rows are quantized per
// 32 with no norm (quantize_activations_g32), exact int32 group dots, the
// bf16 group scales and the fused bias.
//
// What bounds it on an H100: device-memory bytes of the experts that te
// names (each tile reads its expert's weights; tiles of one expert share
// them through L2), or the int8 operations of the padded rows, whichever is
// larger. The design is qmm_txn's body (qmm_txn.cuh: a cp.async ring of
// weight chunks and activation codes, s8 mma.sync with NT = ceil(tm / 8) n8
// row tiles) with the weight pointer chosen per row tile.
#include "qmm_txn.cuh"

using namespace qmm;

// x int8 [tiles * tm, K], sx f32 [tiles * tm, K/32]; qs uint8 [E, K/2, Ns],
// sc (and bias) bf16 [E, K/32, Ns]; te int32 [tiles]; y f32 [tiles * tm, Ns];
// partial f32 [tiles, S, tm, Ns]; counters int32 [tiles, Ns / 128].
extern "C" int qmm_txn_g(const void* x, const void* sx, const void* qs, const void* sc,
                         const void* bias, void* y, void* partial, void* counters,
                         const void* te, int tm, int tiles, int K, int Ns, int S,
                         void* stream) {
  if (tm < 1 || tm > MAXM || tiles < 1 || K < 256 || K % 256 || Ns < 16 || Ns % 16 || S < 1
      || S > K / 64)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Ns + TN - 1) / TN, S, tiles);
  return (int)txn_launch(grid, (cudaStream_t)stream, x, sx, qs, sc, bias, y, partial,
                         counters, tm, K, Ns, S, (const int*)te);
}
