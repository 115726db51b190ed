"""A head_dim-256 llama through the port's Engine (bf16 and int8 KV) and its
batcher, against the JAX package, on the CPU.

The GGUF is tests/util_models.make_tiny_llama_gguf at d_model 512, 2 query
heads over 1 KV head (head_dim 256, gemma's), d_ff 1024, Q4_K, 2 layers. The
reference runs its decode kernels for any head_dim with D % 128 == 0, and
the port routes D = 256 to its kernels in the same way (ops.attention
decode_route): on the CPU their plain versions, on the card
flash_decode_write (bf16 cache), flash_decode (int8 cache) and
paged_attention (the batcher's pool). The JAX side runs its Pallas kernels
in interpret mode (the monkeypatch of tests/test_flash_write.py), so both
sides follow the TPU kernels' numerics: greedy token ids must be equal, as
tests/test_torch_engine.py and tests/test_torch_batcher.py hold them for
head_dim 128.
"""
import pytest
import torch

import tests.conftest  # noqa: F401

from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu.server.batcher import Batcher as JBatcher
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_q4km import _interpreted
from tests.util_models import make_tiny_llama_gguf

MAX_LEN = 256


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("d256") / "tiny-d256-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=512, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_same_greedy_ids(gguf, kv):
    def run():
        cfg, params, tok, _ = j_load_llama(gguf)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN, kv_dtype=kv)
        return [t for t, _ in eng.generate("hello", max_tokens=12,
                                           sampling=JSP(temperature=0.0), stop_on_eog=False)]
    want = _interpreted(run)
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN, kv_dtype=kv)
    assert eng.cfg.head_dim == 256
    assert TA.decode_route(256, hq=2, s_eff=MAX_LEN) == "kernel"
    got = [t for t, _ in eng.generate("hello", max_tokens=12,
                                      sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert got == want


def test_batcher_same_greedy_ids(gguf):
    """Two rows admitted at 12 and 40 tokens (buckets under 128: both
    packages' einsum prefill), then paged decode."""
    cfg, params, tok, _ = j_load_llama(gguf)
    jeng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
    teng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    assert TA.decode_route(256, paged=True) == "kernel"
    prompts = [_prompt(s, n) for s, n in ((31, 12), (32, 40))]
    out = {}
    for name, eng, B, SP in (("jax", jeng, JBatcher, JSP), ("port", teng, TBatcher, TSP)):
        b = B(eng, rows=2)
        try:
            out[name] = _serve(b, [(p, SP(temperature=0.0), 6) for p in prompts])
        finally:
            b.shutdown()
    assert out["port"] == out["jax"] and all(len(t) == 6 for t in out["port"])
