"""Files whose layers mix formats, the dense int8 KV cache, and Q5_K: the
port against the JAX package on the CPU.

The mixed GGUF is written here by llama.cpp's Q4_K_M recipe
(llamafile_tpu_torch.testing.use_more_bits): d_model 256, d_ff 1024, 2
heads, 1 KV head (head_dim 128), 4 layers; attn_v and ffn_down are Q6_K in
layers 2 and 3, every other matrix Q4_K, the output head Q6_K. Its layers
cannot be stacked, so both packages run them unrolled: Q4_K products at 64
rows and more take the two-plane kernel (bf16 out from 256 rows), Q6_K ones
the dequant GEMM. The JAX side runs its Pallas kernels in interpret mode,
attention included (the monkeypatch of tests/test_flash_write.py).

Tolerances: greedy token ids and CLI text must be equal. Logits: the
paths share every integer dot and rounding rule but sum in another order.
At bucket 32 an ulp on a rounding boundary of a per-32 activation code
moves a logit by up to 1.5% of the largest (measured): held within 2e-2,
as tests/test_torch_llama.py does. At bucket 256 the Q4_K products return
bf16 (2**-8 a step) and silu(g) * u runs in bf16 on both sides: a one-step
parting of a few qkv outputs spreads through attention and the FFN
(measured on layer 0: 5e-5 of the qkv outputs, then 4.8% of the attention
outputs and 48% of the FFN's, the residual within 1.3%), and the logits
part by up to 3.3% of the largest (measured): held within 5e-2. At both,
the port's top-1 must be the reference's or within the tolerance of it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.gguf import GGUFWriter
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.ops import qmatmul as JQM
from llamafile_tpu.ops import repack as JR
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu.server.batcher import Batcher as JBatcher
from llamafile_tpu_torch.gguf import quants as TQ
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.ops import qmatmul as TQM
from llamafile_tpu_torch.ops import repack as TR
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from llamafile_tpu_torch.testing import use_more_bits
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_engine import _cli_text, _text_until_eos
from tests.util_models import byte_vocab, make_tiny_llama_gguf

D, DFF, NL, H, HKV = 256, 1024, 4, 2, 1
MAX_LEN = 512
j_forward = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))


def make_q4_k_m_gguf(path, seed=0):
    rng = np.random.default_rng(seed)
    tokens, scores, token_type = byte_vocab()
    w = GGUFWriter(path)
    for key, val in (("general.architecture", "llama"), ("general.name", "tiny-q4_k_m"),
                     ("llama.block_count", NL), ("llama.embedding_length", D),
                     ("llama.attention.head_count", H),
                     ("llama.attention.head_count_kv", HKV),
                     ("llama.feed_forward_length", DFF), ("llama.rope.freq_base", 10000.0),
                     ("llama.attention.layer_norm_rms_epsilon", 1e-5),
                     ("llama.context_length", MAX_LEN), ("llama.vocab_size", len(tokens)),
                     ("tokenizer.ggml.model", "llama"), ("tokenizer.ggml.tokens", tokens),
                     ("tokenizer.ggml.scores", scores),
                     ("tokenizer.ggml.token_type", np.asarray(token_type, np.int32)),
                     ("tokenizer.ggml.bos_token_id", 1), ("tokenizer.ggml.eos_token_id", 2),
                     ("tokenizer.ggml.unknown_token_id", 0),
                     ("tokenizer.ggml.add_bos_token", True)):
        w.add(key, val)

    def add(name, shape, quant, scale=0.08):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        w.add_tensor(name, shape, quant, JQ.TYPE_BY_NAME[quant].quantize(arr.reshape(-1)))

    w.add_tensor_f32("token_embd.weight",
                     (rng.standard_normal((len(tokens), D)) * 0.5).astype(np.float32))
    for i in range(NL):
        p, more = f"blk.{i}.", "Q6_K" if use_more_bits(i, NL) else "Q4_K"
        w.add_tensor_f32(p + "attn_norm.weight", np.ones(D, np.float32))
        add(p + "attn_q.weight", (H * 128, D), "Q4_K")
        add(p + "attn_k.weight", (HKV * 128, D), "Q4_K")
        add(p + "attn_v.weight", (HKV * 128, D), more)
        add(p + "attn_output.weight", (D, H * 128), "Q4_K")
        w.add_tensor_f32(p + "ffn_norm.weight", np.ones(D, np.float32))
        add(p + "ffn_gate.weight", (DFF, D), "Q4_K")
        add(p + "ffn_up.weight", (DFF, D), "Q4_K")
        add(p + "ffn_down.weight", (D, DFF), more)
    w.add_tensor_f32("output_norm.weight", np.ones(D, np.float32))
    add("output.weight", (len(tokens), D), "Q6_K", 0.5)
    w.write()
    return path


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_q4_k_m_gguf(str(tmp_path_factory.mktemp("q4km") / "tiny-q4_k_m.gguf"))


@pytest.fixture(scope="module")
def gguf_q4k(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q4k") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


def _interpreted(fn):
    """fn() with the JAX package's Pallas kernels in interpret mode."""
    mp = pytest.MonkeyPatch()
    orig = JA.pl.pallas_call
    mp.setattr(JA.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mp.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        return fn()
    finally:
        mp.undo()
        jax.clear_caches()


def _jax_generate(path, prompt, n=16, **kw):
    def run():
        cfg, params, tok, _ = j_load_llama(path)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN, **kw)
        return list(eng.generate(prompt, max_tokens=n, sampling=JSP(temperature=0.0),
                                 stop_on_eog=False))
    return _interpreted(run)


def test_mixed_file_loads_unrolled(gguf):
    cfg, params, _, _ = load_llama(gguf, device="cpu")
    assert isinstance(params.layers, list) and TL.stack_layers(params) is params
    kinds = [(l.wqkv is not None, l.w_down.kind) for l in params.layers]
    assert kinds == [(True, "q4b"), (True, "q4b"), (False, "q8b"), (False, "q8b")]
    assert params.layers[0].w_gate_up.il and params.output.kind == "q8b"


@pytest.mark.parametrize("n_prompt", [20, 200], ids=["bucket32", "bucket256"])
def test_unrolled_forward_matches_jax(gguf, n_prompt):
    jcfg, jp, _, _ = j_load_llama(gguf)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    bucket = 32 if n_prompt <= 32 else 256
    toks = np.zeros((1, bucket + 2), np.int32)
    toks[0, :n_prompt] = np.random.default_rng(n_prompt).integers(3, 250, n_prompt)
    toks[0, bucket:] = [65, 66]
    last = np.asarray([n_prompt - 1], np.int32)

    def run_jax():
        jc = JL.init_cache(jcfg, 1, MAX_LEN)
        out = []
        lg, jc = j_forward(jp, jcfg, jnp.asarray(toks[:, :bucket]), jnp.zeros((1,), jnp.int32),
                           jc, fresh_prefill=True, last_idx=jnp.asarray(last))
        out.append(np.asarray(lg)[0, -1])
        for i in range(2):                         # teacher-forced decode steps
            lg, jc = j_forward(jp, jcfg, jnp.asarray(toks[:, bucket + i:bucket + i + 1]),
                               jnp.asarray([n_prompt + i], jnp.int32), jc, attn_len=256)
            out.append(np.asarray(lg)[0, -1])
        return out
    want = _interpreted(run_jax)
    tc = TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    lg, _ = TL.forward(tp, tcfg, torch.from_numpy(toks[:, :bucket]),
                       torch.zeros(1, dtype=torch.int32), tc, fresh_prefill=True,
                       last_idx=torch.from_numpy(last))
    got = [lg[0, -1].numpy()]
    for i in range(2):
        lg, _ = TL.forward(tp, tcfg, torch.from_numpy(toks[:, bucket + i:bucket + i + 1]),
                           torch.tensor([n_prompt + i], dtype=torch.int32), tc, attn_len=256)
        got.append(lg[0, -1].numpy())
    tol = 2e-2 if bucket == 32 else 5e-2
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * np.abs(w).max()
        # the port's greedy pick is the reference's, or a near-tie of it
        assert w[np.argmax(g)] >= w.max() - tol * np.abs(w).max()


@pytest.fixture(scope="module")
def jax_q4km_generation(gguf):
    return _jax_generate(gguf, "hello")


def test_q4_k_m_engine_and_cli_match_jax(gguf, jax_q4km_generation):
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers, list)
    ids = [t for t, _ in eng.generate("hello", max_tokens=16,
                                      sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert ids == [t for t, _ in jax_q4km_generation]
    assert _cli_text(gguf, "hello", 16) == _text_until_eos(jax_q4km_generation)


def test_q4_k_m_batcher_same_greedy_ids(gguf):
    """Admission slices of 16 and 64 tokens (the txn and two-plane kernels),
    then unrolled paged decode of 2 rows."""
    cfg, params, tok, _ = j_load_llama(gguf)
    jeng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
    teng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    prompts = [_prompt(s, n) for s, n in ((21, 12), (22, 50))]
    out = {}
    for name, eng, B, SP in (("jax", jeng, JBatcher, JSP), ("port", teng, TBatcher, TSP)):
        b = B(eng, rows=2)
        try:
            out[name] = _serve(b, [(p, SP(temperature=0.0), 6) for p in prompts])
        finally:
            b.shutdown()
    assert out["port"] == out["jax"] and all(len(t) == 6 for t in out["port"])


@pytest.fixture(scope="module")
def jax_int8_generation(gguf_q4k):
    return _jax_generate(gguf_q4k, "hello", kv_dtype="int8")


def test_int8_kv_engine_and_cli_match_jax(gguf_q4k, jax_int8_generation):
    """The dense int8 cache on stacked layers: decode through flash_decode
    over layer li's codes and scales."""
    eng = load_engine(gguf_q4k, device="cpu", max_seq_len=MAX_LEN, kv_dtype="int8")
    assert eng.new_cache().quantized
    ids = [t for t, _ in eng.generate("hello", max_tokens=16,
                                      sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert ids == [t for t, _ in jax_int8_generation]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "llamafile_tpu_torch.cli", "--device", "cpu", "--cli",
         "-m", gguf_q4k, "-p", "hello", "-n", "16", "--temp", "0", "-c", str(MAX_LEN),
         "--kv-dtype", "int8"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _text_until_eos(jax_int8_generation)


def q5k_blocks(rng, n, k):
    raw = rng.integers(0, 256, size=(n * k // 256, 176), dtype=np.uint8)
    raw[:, 1] &= 0x3B          # keep the f16 d / dmin exponents moderate
    raw[:, 3] &= 0x3B
    return raw


@pytest.mark.parametrize("n,k", [(300, 512), (64, 1024)])
def test_q5_k_repack_identical(n, k):
    raw = q5k_blocks(np.random.default_rng(n + k), n, k)
    want = JR.repack_numpy(raw, "Q5_K", (n, k))
    got = TR.repack_numpy(raw, "Q5_K", (n, k))
    assert got[0] == want[0] == "q8b" and got[4] == want[4] == 32
    for a, b in zip(got[1:4], want[1:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    spec = TQ.TYPE_BY_NAME["Q5_K"]
    ref = JQ.dequantize(raw, spec.type_id, (n, k))
    np.testing.assert_array_equal(TQ.dequantize(raw, spec.type_id, (n, k)), ref)
    tqt = TR.repack(raw, "Q5_K", (n, k), device="cpu")
    jqt = JR.repack(raw, "Q5_K", (n, k))
    for t, j in ((tqt.qs, jqt.qs), (tqt.scales, jqt.scales), (tqt.bias, jqt.bias)):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    np.testing.assert_allclose(TR.dequant_qtensor(tqt).numpy(), ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("m", [1, 64])
def test_q5_k_products_match_jax(m):
    """Q5_K is q8b with a bias: the q8b GEMV fuses it at M = 1, the dequant
    GEMM takes it from qmatmul at M > 1 (tolerance of test_torch_qmatmul)."""
    n, k = 300, 512
    raw = q5k_blocks(np.random.default_rng(m), n, k)
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(np.float32)
    want = JQM.qmatmul(jnp.asarray(x), JR.repack(raw, "Q5_K", (n, k)))
    got = TQM.qmatmul(torch.from_numpy(x), TR.repack(raw, "Q5_K", (n, k), device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
