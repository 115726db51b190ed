"""Gemma 3 through the port against the JAX package, on the CPU: the shared
tests of tests/test_torch_gemma.py (see its docstring for the GGUF and what
is held) on its tiny gemma3 GGUF, 6 layers with layer 5 global, and the
batcher's and the paged decode's refusals.
"""
import dataclasses

import pytest
import torch

import tests.conftest  # noqa: F401

from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from tests.test_torch_gemma import (MAX_LEN, _one_torch_thread, gguf, jax_refs,  # noqa: F401
                                    test_carried_weights_equal_loaded,
                                    test_config_matches_jax, test_decode_past_window_matches_jax,
                                    test_engine_and_cli_match_jax, test_prefill_matches_jax)


@pytest.fixture(scope="module")
def arch():
    return "gemma3"


def test_gemma3_refused_by_batcher_and_paged_decode(gguf):
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="gemma3"):
        TBatcher(eng, rows=2)
    # with the window and the post norms off, the q/k norms still refuse
    cfg = dataclasses.replace(eng.cfg, swa_window=0, post_norms=False)
    with pytest.raises(NotImplementedError, match="qk_norm"):
        TL.forward_paged_decode(eng.params, cfg, torch.zeros(1, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32), None,
                                torch.zeros((1, 1), dtype=torch.int32))
