"""Whole models under the q4b kernel flavours (LLAMAFILE_TPU_Q4B) of the
port against the JAX package's, on the CPU: the tiny Q4_K GGUF (d 256,
d_ff 1024, 2 heads of 128, 1 KV head, 2 layers; stacked by the Engine)
through the forward, Engine, batcher and --cli, and the tiny 4-expert MoE
GGUF through the Engine. The products and the flavour switch itself are
tests/test_torch_q4b.py's, whose flavour() sets both packages' switch.

Tolerances: the forward's logits as tests/test_torch_q4km.py holds them
(see test_forward_matches_jax), and token ids equal.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu.server.batcher import Batcher as JBatcher
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.ops import qmatmul as TQ
from llamafile_tpu_torch.ops import reset_launch_counts
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_q4km import _exact_planes, _one_torch_thread  # noqa: F401
from tests.test_torch_moe_model import _interpreted
from tests.test_torch_q4b import flavour, rel
from tests.util_models import make_tiny_llama_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 512
PROMPT = "the int8 flavour runs its products in int8"          # 42 tokens + BOS


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q4b") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


@pytest.fixture(scope="module")
def gguf_moe(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q4b_moe") / "tiny-moe-q4k.gguf")
    return make_tiny_llama_gguf(path, n_experts=4, n_experts_used=2, d_model=256,
                                d_ff=1024, n_heads=2, n_kv_heads=1, quant="Q4_K")


# one compile per shape and flavour (the flavour's caches are cleared)
j_forward = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))


@pytest.mark.parametrize("n_prompt", [45, 140], ids=["bucket64", "bucket256"])
@pytest.mark.parametrize("flav", ["int8", "planes"])
def test_forward_matches_jax(gguf, flav, n_prompt):
    """A prefill at bucket 64 (f32 planes out) or 256 (bf16 out) and one
    decode step (the int8 or planes kernel at M = 1, padded to 8), against
    the JAX forward jitted with its kernels in interpret mode. The limits
    are tests/test_torch_q4km.py's: an ulp on a rounding boundary of a
    per-32 code or a bf16 activation moves these logits by up to 1e-2 on
    every flavour (measured here: prefill 4.2e-3 under txn, 4.3e-3 to
    9.4e-3 under int8 and planes; the decode step 2.4e-2 under txn at
    bucket 256, up to 2.6e-2 under int8), so every step within 2e-2
    (prefill) or 5e-2 (decode) of the largest logit, with the reference's
    greedy pick or a near tie of it."""
    bucket = 64 if n_prompt <= 64 else 256
    jcfg, jp, _, _ = j_load_llama(gguf)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    jp, tp = JL.stack_layers(jp), TL.stack_layers(tp)
    toks = np.zeros((1, bucket + 1), np.int32)
    toks[0, :n_prompt] = np.random.default_rng(n_prompt).integers(3, 250, n_prompt)
    toks[0, bucket] = 65
    last = np.asarray([n_prompt - 1], np.int32)

    def run_jax():
        jc = JL.init_cache(jcfg, 1, MAX_LEN)
        lg, jc = j_forward(jp, jcfg, jnp.asarray(toks[:, :bucket]), jnp.zeros((1,), jnp.int32),
                           jc, fresh_prefill=True, last_idx=jnp.asarray(last))
        lg2, _ = j_forward(jp, jcfg, jnp.asarray(toks[:, bucket:]),
                           jnp.asarray([n_prompt], jnp.int32), jc, attn_len=MAX_LEN)
        return [np.asarray(lg)[0, -1], np.asarray(lg2)[0, -1]]
    with flavour(flav):
        want = _interpreted(lambda: _exact_planes(run_jax))
        tc = TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        lg, tc = TL.forward(tp, tcfg, torch.from_numpy(toks[:, :bucket]),
                            torch.zeros(1, dtype=torch.int32), tc, fresh_prefill=True,
                            last_idx=torch.from_numpy(last))
        lg2, _ = TL.forward(tp, tcfg, torch.from_numpy(toks[:, bucket:]),
                            torch.tensor([n_prompt], dtype=torch.int32), tc, attn_len=MAX_LEN)
    for g, w, tol in ((lg[0, -1].numpy(), want[0], 2e-2), (lg2[0, -1].numpy(), want[1], 5e-2)):
        assert rel(g, w) <= tol
        assert w[np.argmax(g)] >= w.max() - tol * np.abs(w).max()


@functools.lru_cache(maxsize=None)
def _jax_generate(path, prompt, flav, n=16):
    """The JAX package's greedy generation under flavour flav (cached: the
    Engine and CLI cases share it)."""
    def run():
        cfg, params, tok, _ = j_load_llama(path)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
        return list(eng.generate(prompt, max_tokens=n, sampling=JSP(temperature=0.0),
                                 stop_on_eog=False))
    with flavour(flav):
        return _interpreted(run)


def _port_ids(path, prompt, n=16):
    eng = load_engine(path, device="cpu", max_seq_len=MAX_LEN)
    return [t for t, _ in eng.generate(prompt, max_tokens=n, sampling=TSP(temperature=0.0),
                                       stop_on_eog=False)]


@pytest.mark.parametrize("flav", ["int8", "planes"])
def test_engine_greedy_ids_match_jax(gguf, flav):
    """16 greedy ids from a 42-token prompt: the stacked planes kernel at
    bucket 64, then decode on qmm_int8 (int8) or qmm_planes (planes)."""
    want = _jax_generate(gguf, PROMPT, flav)
    with flavour(flav):
        ids = _port_ids(gguf, PROMPT)
    assert ids == [t for t, _ in want]


def test_cli_int8_prints_the_jax_text(gguf):
    """The port's --cli under LLAMAFILE_TPU_Q4B=int8 prints the text of the
    JAX package's greedy generation under the same flavour (its kernels in
    interpret mode, as tests/test_torch_engine.py compares the CLI)."""
    want = _jax_generate(gguf, PROMPT, "int8")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["LLAMAFILE_TPU_Q4B"] = "int8"
    r = subprocess.run(
        [sys.executable, "-m", "llamafile_tpu_torch.cli", "--device", "cpu", "--cli", "-m",
         gguf, "-p", PROMPT, "-n", "16", "--temp", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    text = ""
    for tid, piece in want:
        if tid == 2:             # the CLI stops at end-of-generation (eos 2)
            break
        text += piece
    assert r.stdout == text


def test_batcher_int8_same_greedy_ids(gguf):
    """Two slots under int8: admission slices under bucket 128, then the
    paged decode at 2 rows (padded to 8) on qmm_int8."""
    cfg, params, tok, _ = j_load_llama(gguf)
    prompts = [_prompt(s, n) for s, n in ((41, 9), (42, 30), (43, 50))]
    out = {}
    with flavour("int8"):
        jeng = JEngine(cfg, params, tok, max_seq_len=256)
        teng = load_engine(gguf, device="cpu", max_seq_len=256)
        for name, eng, B, SP in (("jax", jeng, JBatcher, JSP), ("port", teng, TBatcher, TSP)):
            b = B(eng, rows=2)
            try:
                out[name] = _serve(b, [(p, SP(temperature=0.0), 6) for p in prompts])
            finally:
                b.shutdown()
    assert out["port"] == out["jax"] and all(len(t) == 6 for t in out["port"])


def test_moe_engine_int8_on_routed_fallback(gguf_moe):
    """The tiny 4-expert MoE GGUF under int8: decode leaves the fused FFN for
    the routed products, whose q4b experts take _routed_fallback."""
    want = _jax_generate(gguf_moe, "hello", "int8")
    with flavour("int8"):
        eng = load_engine(gguf_moe, device="cpu", max_seq_len=MAX_LEN)
        assert TL.moe_route(eng.params.layers, eng.cfg, 1) == "routed"
        reset_launch_counts()
        ids = [t for t, _ in eng.generate("hello", max_tokens=16,
                                          sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert ids == [t for t, _ in want]
    # two routed products (gate|up, down) a layer a decode step
    assert TQ.ROUTE_COUNTS["routed_fallback"] == 2 * eng.cfg.n_layers * 15
