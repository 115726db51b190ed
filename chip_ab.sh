#!/usr/bin/env bash
# Decode rate of two trees of this repository on one card, in turns:
# A, B, B, A (each turn builds its kernels, then three greedy 64-token
# Engine.generate runs of synthetic llama3-8b Q4_K from a 24-token prompt,
# through chip_smoke.py's build_engine / counted_generate / decode_report).
#
#   bash chip_ab.sh <tree A> <tree B>
#
# A tree is a checkout, e.g. the parent commit unpacked with
# `git archive <commit> | tar -x -C _archive/parent` (_archive/ is ignored).
set -e
run() {
  (cd "$1" && python3 -c "
import torch, chip_smoke as C
from llamafile_tpu_torch import resolve_device
from llamafile_tpu_torch.ops import _build
d = resolve_device('cuda'); _build.build_all()
eng, read = C.build_engine(torch, d, 'Q4_K')
p = [int(t) for t in torch.randint(3, eng.cfg.n_vocab, (24,), generator=torch.Generator().manual_seed(3))]
for _ in range(3):
    _, _, ttft, dec = C.counted_generate(torch, eng, p, 64)
    C.decode_report(torch, read, 63, ttft, dec, '$1')
" 2>&1 | grep -E "decode|first token")
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in "$1" "$2" "$2" "$1"; do echo "== $t"; run "$t"; done
