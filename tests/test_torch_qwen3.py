"""Qwen3 through the port against the JAX package, on the CPU: the shared
tests of tests/test_torch_qwen.py (see its docstring for the GGUF and what
is held) on its tiny qwen3 GGUF, per-head q/k norms under Engine, --cli,
the paged decode and the server; and the Qwen MoE architectures, which the
port still refuses by name.
"""
import pytest

import tests.conftest  # noqa: F401

from llamafile_tpu_torch.models.loader import load_llama
from tests.test_torch_qwen import (_one_torch_thread, gguf, jax_refs,  # noqa: F401
                                   make_tiny_qwen_gguf, test_qwen_carried_weights_equal_loaded,
                                   test_qwen_config_matches_jax, test_qwen_decode_matches_jax,
                                   test_qwen_engine_and_cli_match_jax,
                                   test_qwen_http_server_alone_and_together,
                                   test_qwen_paged_decode_matches_jax,
                                   test_qwen_prefill_matches_jax,
                                   test_qwen_served_alone_and_beside_others)


@pytest.fixture(scope="module")
def arch():
    return "qwen3"


@pytest.mark.parametrize("moe_arch", ["qwen2moe", "qwen3moe"])
def test_qwen_moe_not_ported(tmp_path, moe_arch):
    """qwen2moe and qwen3moe wait for shared experts: they raise by name."""
    path = make_tiny_qwen_gguf(str(tmp_path / f"{moe_arch}.gguf"), moe_arch)
    with pytest.raises(NotImplementedError, match=moe_arch):
        load_llama(path, device="cpu")
