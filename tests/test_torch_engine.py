"""The port's Engine and CLI against the JAX package's on tiny Q4_K and
Q8_0 GGUFs: greedy generation must give the same token ids.

The GGUFs are tests/util_models.make_tiny_llama_gguf with d_model 256, d_ff
1024 (the Q4_K dense FFN fuses at M = 1) and head_dim 128 (decode reaches
the fused attention kernel). A prompt of over 128 tokens (bucket 256) takes
the dequant GEMM and the flash prefill. The JAX side runs its Pallas kernels
in interpret mode, attention included (the monkeypatch of
tests/test_flash_write.py), so both sides follow the TPU kernels' numerics;
token ids must be equal.
"""
import os
import subprocess
import sys

import pytest
import torch

import tests.conftest  # noqa: F401
import jax

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.runtime.engine import load_engine as j_load_engine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch.runtime.engine import Engine, load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams
from tests.util_models import make_tiny_llama_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "hello"
# 140 characters: 141 tokens of the byte vocabulary with BOS (bucket 256)
LONG_PROMPT = ("The quick brown fox jumps over the lazy dog while the tiny "
               "model reads a prompt long enough for the flash prefill and "
               "the dequant GEMM path.")


def _tiny(tmp_path_factory, quant):
    path = str(tmp_path_factory.mktemp("tiny") / f"tiny-{quant.lower()}.gguf")
    return make_tiny_llama_gguf(path, quant=quant, d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return _tiny(tmp_path_factory, "Q4_K")


@pytest.fixture(scope="module")
def gguf_q8(tmp_path_factory):
    return _tiny(tmp_path_factory, "Q8_0")


def _jax_generate(path, prompt, n=16):
    """(token id, text piece) pairs of the JAX package's greedy generation,
    its kernels driven in Pallas interpret mode."""
    mp = pytest.MonkeyPatch()
    orig = JA.pl.pallas_call
    mp.setattr(JA.pl, "pallas_call",
               lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mp.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        eng = j_load_engine(path)
        out = list(eng.generate(prompt, max_tokens=n,
                                sampling=JSP(temperature=0.0), stop_on_eog=False))
    finally:
        mp.undo()
        jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def jax_generation(gguf):
    return _jax_generate(gguf, PROMPT)


@pytest.fixture(scope="module")
def jax_long_generation(gguf):
    return _jax_generate(gguf, LONG_PROMPT, 8)


@pytest.fixture(scope="module")
def jax_q8_generation(gguf_q8):
    return _jax_generate(gguf_q8, PROMPT)


def _cli_text(path, prompt, n):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "llamafile_tpu_torch.cli", "--device", "cpu",
         "--cli", "-m", path, "-p", prompt, "-n", str(n), "--temp", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _text_until_eos(generation):
    want = ""
    for tid, piece in generation:
        if tid == 2:             # the CLI stops at end-of-generation (eos 2)
            break
        want += piece
    return want


@pytest.fixture(scope="module")
def engine(gguf):
    return load_engine(gguf, device="cpu")


def test_greedy_generate_same_ids(engine, jax_generation):
    ids = [t for t, _ in engine.generate(PROMPT, max_tokens=16,
                                         sampling=SamplingParams(temperature=0.0),
                                         stop_on_eog=False)]
    assert len(ids) == 16
    assert ids == [t for t, _ in jax_generation]


def test_cli_prints_the_same_text(gguf, jax_generation):
    assert _cli_text(gguf, PROMPT, 16) == _text_until_eos(jax_generation)


@pytest.mark.parametrize("which", ["q4k_long", "q8_0"])
def test_cli_long_prompt_and_q8_0_same_text(gguf, gguf_q8, jax_long_generation,
                                            jax_q8_generation, which):
    path, prompt, n, gen = ((gguf, LONG_PROMPT, 8, jax_long_generation)
                            if which == "q4k_long"
                            else (gguf_q8, PROMPT, 16, jax_q8_generation))
    assert _cli_text(path, prompt, n) == _text_until_eos(gen)


def test_q8_0_greedy_generate_same_ids(gguf_q8, jax_q8_generation):
    eng = load_engine(gguf_q8, device="cpu")
    assert eng.params.layers.wqkv.kind == "q8b"
    assert eng.params.layers.w_gate_up.kind == "q8b" and not eng.params.layers.w_gate_up.il
    ids = [t for t, _ in eng.generate(PROMPT, max_tokens=16,
                                      sampling=SamplingParams(temperature=0.0),
                                      stop_on_eog=False)]
    assert ids == [t for t, _ in jax_q8_generation]


def test_sampled_generate_is_seeded(engine):
    sp = SamplingParams(temperature=0.8, seed=3)
    a = [t for t, _ in engine.generate(PROMPT, 12, sp, stop_on_eog=False)]
    b = [t for t, _ in engine.generate(PROMPT, 12, sp, stop_on_eog=False)]
    assert a == b and len(a) == 12


def test_long_prompt_raises(engine, jax_long_generation):
    """Prompts past 32 tokens no longer raise: a 141-token prompt (bucket
    256) gives the JAX package's greedy ids."""
    assert len(engine.tokenizer.encode(LONG_PROMPT)) > 128
    ids = [t for t, _ in engine.generate(LONG_PROMPT, max_tokens=8,
                                         sampling=SamplingParams(temperature=0.0),
                                         stop_on_eog=False)]
    assert len(ids) == 8
    assert ids == [t for t, _ in jax_long_generation]


@pytest.mark.parametrize("option", [dict(repeat_penalty=1.1), dict(mirostat=2),
                                    dict(presence_penalty=0.5)])
def test_unported_samplers_raise(engine, option):
    with pytest.raises(NotImplementedError):
        list(engine.generate(PROMPT, 4, SamplingParams(**option)))


def test_cli_unported_mode_exits(gguf):
    from llamafile_tpu_torch.cli import main
    assert main(["--chat", "-m", gguf]) == 2


def test_cuda_engine_raises_without_a_card(engine):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(engine.cfg, engine.params, engine.tokenizer, device="cuda")
