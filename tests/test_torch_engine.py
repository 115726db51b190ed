"""The port's Engine and CLI against the JAX package's on a tiny Q4_K GGUF:
greedy generation must give the same token ids.

The GGUF is tests/util_models.make_tiny_llama_gguf with d_model 256, d_ff
1024 (the dense FFN fuses at M = 1) and head_dim 128 (decode reaches the
fused attention kernel). The JAX side runs its Pallas kernels in interpret
mode, attention included (the monkeypatch of tests/test_flash_write.py), so
both sides follow the TPU kernels' numerics; token ids must be equal.
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


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


@pytest.fixture(scope="module")
def jax_generation(gguf):
    """(token id, text piece) pairs of the JAX package's greedy generation,
    its kernels driven in Pallas interpret mode."""
    mp = pytest.MonkeyPatch()
    orig = JA.pl.pallas_call
    mp.setattr(JA.pl, "pallas_call",
               lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mp.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        eng = j_load_engine(gguf)
        out = list(eng.generate(PROMPT, max_tokens=16,
                                sampling=JSP(temperature=0.0), stop_on_eog=False))
    finally:
        mp.undo()
        jax.clear_caches()
    return out


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
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "llamafile_tpu_torch.cli", "--device", "cpu",
         "--cli", "-m", gguf, "-p", PROMPT, "-n", "16", "--temp", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = ""
    for tid, piece in jax_generation:
        if tid == 2:             # the CLI stops at end-of-generation (eos 2)
            break
        want += piece
    assert r.stdout == want


def test_sampled_generate_is_seeded(engine):
    sp = SamplingParams(temperature=0.8, seed=3)
    a = [t for t, _ in engine.generate(PROMPT, 12, sp, stop_on_eog=False)]
    b = [t for t, _ in engine.generate(PROMPT, 12, sp, stop_on_eog=False)]
    assert a == b and len(a) == 12


def test_long_prompt_raises(engine):
    with pytest.raises(NotImplementedError, match="_qmm_kernel"):
        list(engine.generate("", prompt_ids=list(range(3, 43)), max_tokens=4))


@pytest.mark.parametrize("option", [dict(repeat_penalty=1.1), dict(mirostat=2),
                                    dict(tfs_z=0.9)])
def test_unported_samplers_raise(engine, option):
    with pytest.raises(NotImplementedError):
        list(engine.generate(PROMPT, 4, SamplingParams(**option)))


def test_cli_unported_mode_exits(gguf):
    from llamafile_tpu_torch.cli import main
    assert main(["--server", "-m", gguf]) == 2


def test_cuda_engine_raises_without_a_card(engine):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(engine.cfg, engine.params, engine.tokenizer, device="cuda")
