"""Gemma 3 through the port against the JAX package, on the CPU: the shared
tests of tests/test_torch_gemma.py (see its docstring for the GGUF and what
is held) on its tiny gemma3 GGUF, 6 layers with layer 5 global; the
batcher's refusal, and the paged decode's q/k norms.
"""
import dataclasses

import pytest
import torch

import tests.conftest  # noqa: F401

from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.paged import PagedKV
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from tests.test_torch_gemma import (MAX_LEN, _one_torch_thread, gguf, jax_refs,  # noqa: F401
                                    test_carried_weights_equal_loaded,
                                    test_config_matches_jax, test_decode_past_window_matches_jax,
                                    test_engine_and_cli_match_jax, test_prefill_matches_jax)
from tests.test_torch_llama import close


@pytest.fixture(scope="module")
def arch():
    return "gemma3"


def test_gemma3_refused_by_batcher_and_paged_decode(gguf):
    """The batcher refuses gemma3 (its window); with the window and the post
    norms off, the paged decode now runs the q/k norms (qwen3's path) and
    agrees with the dense decode of the same tokens."""
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="gemma3"):
        TBatcher(eng, rows=2)
    cfg = dataclasses.replace(eng.cfg, swa_window=0, post_norms=False, swa_rope_theta=0.0)
    assert cfg.qk_norm
    ids = [1, 40, 41, 42, 43]
    cache = TL.init_cache(cfg, 1, MAX_LEN, device="cpu")
    want, _ = TL.forward(eng.params, cfg, torch.tensor([ids]), torch.zeros(1, dtype=torch.int32),
                         cache, fresh_prefill=True)
    ps, n = 16, len(ids)
    pool = PagedKV(*[torch.zeros((cfg.n_layers, cfg.n_kv_heads, 2, ps, cfg.head_dim),
                                 dtype=torch.bfloat16) for _ in range(2)])
    tables = torch.tensor([[1]], dtype=torch.int32)
    for i, t in enumerate(ids):
        got, _ = TL.forward_paged_decode(eng.params, cfg, torch.tensor([t], dtype=torch.int32),
                                         torch.tensor([i], dtype=torch.int32), pool, tables)
    # the last step's logits: decode over the pool the steps before wrote
    assert n == 5 and TL.layer_window(cfg, 0) is None
    close(got[0].numpy(), want[0, -1].numpy(), 2e-2)
