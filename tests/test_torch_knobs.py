"""The reference's route knobs in the port, against the JAX package, on the CPU.

Each knob is set on both sides the way each side reads it:
LLAMAFILE_TPU_STACK (read when an Engine is built) and LLAMAFILE_TPU_ILGU
(read by models.loader.fuse_projections) in the environment;
LLAMAFILE_TPU_FLASH_DECODE and LLAMAFILE_TPU_PRENORM, read at import into
module constants, by patching ops.attention.FLASH_DECODE and
models.llama.PRENORM beside the reference's FLASH_DECODE and _PRENORM.

The model is the tiny Q4_K GGUF (d 256, 2 query heads over 1 KV head of
head_dim 128, d_ff 1024: the interleaved gate|up and the fused FFN, 2
layers). The JAX side runs its Pallas kernels interpreted, and a prompt of
80 tokens (bucket 128) takes its unstacked products on the planes rule
under STACK=0. The logits of the prefill and of three decode steps (the
reference's greedy tokens fed on both sides) are held as
tests/test_torch_q4b_model.py holds Q4_K models: within 2e-2 (prefill) and
5e-2 (decode) of the largest logit. Each knob's route is held too: the
unrolled layers, the concatenated gate|up, the einsum route counted a
layer a step, and the norm run apart from the products' prep.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.models.llama as JL
import llamafile_tpu.ops.attention as JA
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.ops import qmatmul as TQ
from llamafile_tpu_torch.runtime.engine import load_engine
from tests.test_torch_q4km import _interpreted, _one_torch_thread  # noqa: F401
from tests.util_models import make_tiny_llama_gguf

MAX_LEN = 256
N_PROMPT = 80
STEPS = 3
KNOBS = ("STACK", "ILGU", "FLASH_DECODE", "PRENORM")


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("knobs") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024, n_heads=2,
                                n_kv_heads=1, n_layers=2)


def _prompt():
    ids = np.zeros((1, 128), np.int32)
    ids[0, :N_PROMPT] = np.random.default_rng(5).integers(3, 250, N_PROMPT)
    return ids


def knob(mp, name):
    """Turn one knob off on both sides."""
    if name in ("STACK", "ILGU"):
        mp.setenv(f"LLAMAFILE_TPU_{name}", "0")
    elif name == "FLASH_DECODE":
        mp.setattr(JA, "FLASH_DECODE", False)
        mp.setattr(TA, "FLASH_DECODE", False)
    else:
        mp.setattr(JL, "_PRENORM", False)
        mp.setattr(TL, "PRENORM", False)


def _jax_steps(path):
    """The reference's prefill logits and greedy decode of STEPS tokens:
    (tokens, logits [1 + STEPS, V])."""
    cfg, params, tok, _ = j_load_llama(path)
    eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
    fwd = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))
    cache = JL.init_cache(cfg, 1, MAX_LEN)
    lg, cache = fwd(eng.params, cfg, jnp.asarray(_prompt()), jnp.zeros((1,), jnp.int32),
                    cache, fresh_prefill=True,
                    last_idx=jnp.full((1,), N_PROMPT - 1, jnp.int32))
    logits, toks = [np.asarray(lg[0, -1])], []
    for i in range(STEPS):
        toks.append(int(np.argmax(logits[-1])))
        lg, cache = fwd(eng.params, cfg, jnp.full((1, 1), toks[-1], jnp.int32),
                        jnp.full((1,), N_PROMPT + i, jnp.int32), cache, attn_len=MAX_LEN)
        logits.append(np.asarray(lg[0, -1]))
    return toks, np.stack(logits)


@pytest.fixture(scope="module")
def jax_side(gguf):
    """{knob: the reference's (tokens, logits) with that knob off}, each
    from one interpreted run."""
    out = {}
    for name in KNOBS:
        mp = pytest.MonkeyPatch()
        knob(mp, name)
        try:
            out[name] = _interpreted(lambda: _jax_steps(gguf))
        finally:
            mp.undo()
    return out


@pytest.mark.parametrize("name", KNOBS)
def test_knob_logits_match_reference(gguf, jax_side, monkeypatch, name):
    knob(monkeypatch, name)
    toks, want = jax_side[name]
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    stacked = isinstance(eng.params.layers, TL.LlamaLayer)
    assert stacked == (name != "STACK")
    layer = eng.params.layers if stacked else eng.params.layers[0]
    assert layer.w_gate_up.il == (name != "ILGU")       # interleaved, or concatenated
    cache = eng.new_cache()
    n0 = TA.ROUTE_COUNTS["einsum"]
    lg, _ = TL.forward(eng.params, eng.cfg, torch.from_numpy(_prompt()),
                       torch.zeros(1, dtype=torch.int32), cache, fresh_prefill=True,
                       last_idx=torch.full((1,), N_PROMPT - 1, dtype=torch.int32))
    got = [lg[0, -1]]
    for i, t in enumerate(toks):
        lg, _ = TL.forward(eng.params, eng.cfg, torch.full((1, 1), t, dtype=torch.int32),
                           torch.full((1,), N_PROMPT + i, dtype=torch.int32), cache,
                           attn_len=MAX_LEN)
        got.append(lg[0, -1])
    got = torch.stack(got).numpy()
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 2e-2 if i == 0 else 5e-2
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), (i, name)
    # the einsum route: every layer of every decode step under FLASH_DECODE=0
    einsum = TA.ROUTE_COUNTS["einsum"] - n0
    assert einsum == (eng.cfg.n_layers * STEPS if name == "FLASH_DECODE" else 0)
    # M = 1: the M = 1 GEMV on each product, and the fused FFN only on the
    # stacked interleaved gate|up
    wl = 0 if stacked else None
    assert [TQ.product_route(q, 1, eng.cfg.d_model, wl, TQ.q4b_flavour())
            for q in (layer.wqkv, layer.w_gate_up)] == ["qmm_txn_m1", "qmm_txn_m1"]
    fused = stacked and layer.w_gate_up.il and TL.moe_fusable(
        layer.w_gate_up, layer.w_down, eng.cfg.d_model, eng.cfg.d_ff)
    assert fused == (name not in ("STACK", "ILGU"))


def test_prenorm_off_norms_before_the_product(monkeypatch):
    """PRENORM off hands the products the normed rows and no prenorm."""
    x = torch.randn(3, 64)
    w = torch.rand(64) + 0.5
    h, pn = TL._prenormed(x, w, 1e-5)
    assert h is x and pn == (w, 1e-5)
    monkeypatch.setattr(TL, "PRENORM", False)
    h, pn = TL._prenormed(x, w, 1e-5)
    assert pn is None and torch.equal(h, TQ.apply_rmsnorm(x, w, 1e-5))
