"""qmm_txn's launch helpers on the CPU: the K split of a launch
(qmatmul.n_split, which every split-K kernel of the port takes) at
qmm_txn's main-path shapes and over a grid of sizes, and the swapped-scale
control that the card checks hold the kernel against (testing.txn_scale_swap).
The kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2)."""
import numpy as np
import pytest
import torch

from llamafile_tpu_torch.ops import qmatmul as Q
from llamafile_tpu_torch.testing import rand_q4b, rel_err, txn_scale_swap

SMS = 132                     # an H100 SXM


@pytest.mark.parametrize("what,blocks,chunks,want", [
    ("lm head, 1008 column tiles", 1008, 64, 1),
    ("gate|up, 224 tiles", 224, 64, 2),
    ("qkv, 48 tiles", 48, 64, 9),
    ("o, 32 tiles", 32, 64, 13),
    ("down, 32 tiles over K = 14336", 32, 224, 13),
    ("qmm_txn_g gate|up, 5 row tiles x 224 column tiles", 5 * 224, 64, 1),
    ("qmm_txn_g down, 5 row tiles x 32", 5 * 32, 224, 3),
    ("one tile over K = 14336: a split a chunk", 1, 224, 224),
])
def test_n_split_main_path(what, blocks, chunks, want):
    assert Q.n_split(blocks, chunks, chunks, SMS) == want, what


@pytest.mark.parametrize("sms", [1, 8, 66, 114, 132])
def test_n_split_fills_the_card(sms):
    """At least _TARGET_BLOCKS_PER_SM blocks an SM unless every chunk is its
    own split, at least one chunk a split, and the fewest splits that do so;
    a cap below the chunk count bounds it."""
    per_sm = Q._TARGET_BLOCKS_PER_SM
    for blocks in (1, 2, 3, 7, 32, 48, 131, 224, 528, 1008, 5000):
        for chunks in (4, 16, 64, 224):
            s = Q.n_split(blocks, chunks, chunks, sms)
            assert 1 <= s <= chunks
            assert blocks * s >= per_sm * sms or s == chunks
            assert s == 1 or blocks * (s - 1) < per_sm * sms
            capped = Q.n_split(blocks, chunks, chunks // 8, sms)
            assert capped == max(1, min(s, chunks // 8))


@pytest.mark.parametrize("m", [1, 8, 25, 32])
@pytest.mark.parametrize("bias", [True, False])
def test_txn_scale_swap_fails_the_limit(m, bias):
    """The control moves the product far past qmm_txn's 1e-5 limit; the
    plain version itself is bitwise repeatable."""
    gen = torch.Generator().manual_seed(m)
    qs, sc, b = rand_q4b(gen, 1, 256, 512, "cpu")
    b = b[0] if bias else None
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32))
    xq, sx = Q.quantize_activations_g32(x)
    want = Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b)
    assert torch.equal(Q.qmm_txn(xq, sx, qs[0], sc[0], b), want)
    assert rel_err(txn_scale_swap(xq, sx, qs[0], sc[0], b), want) > 1e-3
