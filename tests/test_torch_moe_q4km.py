"""The 4-layer Q4_K_M 8-expert GGUF of tests/test_torch_moe_model.py (3-D
`ffn_*_exps` tensors, ffn_down Q6_K in layers 2 and 3, attn_k/v Q8_0,
attn_output Q5_K; unrolled in both packages) through the port's forward,
Engine and CLI, against the JAX package on the CPU. The helpers, the
interpret-mode monkeypatch and the tolerances are that file's: logits within
5e-2 of the largest at bucket 32 and 1e-1 at bucket 256, the port's top-1
the reference's or within that tolerance of it; greedy ids and CLI text
equal for a prompt whose 16 ids agree.
"""
import pytest

from tests.test_torch_moe_model import (_forward_both, engine_and_cli_match_jax,
                                        make_q4_k_m_moe_gguf)


@pytest.fixture(scope="module")
def gguf_q4km(tmp_path_factory):
    return make_q4_k_m_moe_gguf(str(tmp_path_factory.mktemp("moe_q4km") / "moe-q4_k_m.gguf"))


@pytest.mark.parametrize("n_prompt", [20, 200], ids=["bucket32", "bucket256"])
def test_q4_k_m_moe_forward_matches_jax(gguf_q4km, n_prompt):
    _forward_both(gguf_q4km, n_prompt, stacked=False, tol32=5e-2, tol_long=1e-1)


@pytest.mark.parametrize("which,prompt", [("gguf_q4km", "hi there")], ids=["exps-q4_k_m"])
def test_moe_engine_and_cli_match_jax(request, which, prompt):
    engine_and_cli_match_jax(request.getfixturevalue(which), prompt, unrolled=True)
