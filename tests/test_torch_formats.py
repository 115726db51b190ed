"""The other GGUF formats (Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, IQ4_NL, IQ4_XS)
and the port's GGUF writer, against the JAX package, on the CPU.

- dequantization equals the reference's (np.array_equal) and the repack is
  byte-identical to repack_numpy, on random blocks whose f16 scales are
  small and finite (models.synthetic.random_blocks): Q4_0 and Q4_1 take
  the q4b layout when K % 256 == 0 and q8b below, the others q8b;
- Q8_1, which the reference cannot dequantize either, raises
  NotImplementedError naming the type (the grid IQ types load since they
  were ported: tests/test_torch_grid_iq.py);
- an Engine on a Q4_0 file (the reference's quantizer: the q4b kernels),
  on a Q3_K one and on a Q2_K one (random raw blocks written by the
  reference's writer: the q8b kernels at per-16 scales, Q2_K's with a
  bias) holds its logits against the JAX Engine's,
  its kernels interpreted: the prefill within 2e-2 and three decode steps
  within 5e-2 of the largest logit, as tests/test_torch_q4b_model.py holds
  Q4_K models; layers of one format stack, mixed ones stay unrolled;
- the writer: the same calls give the reference writer's bytes (metadata
  of every type the reference infers, tensors of several formats,
  pack_zip with and without ZIP64), and the port's reader reads them back.
"""
import zipfile

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.gguf.writer as JW
import llamafile_tpu.models.llama as JL
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.ops import repack as JR
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu_torch.gguf import quants as TQ
from llamafile_tpu_torch.gguf import writer as TW
from llamafile_tpu_torch.gguf.reader import GGUFReader
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.synthetic import random_blocks
from llamafile_tpu_torch.ops import repack as TR
from llamafile_tpu_torch.runtime.engine import load_engine
from tests.test_torch_q4km import _interpreted, _one_torch_thread  # noqa: F401
from tests.util_models import byte_vocab, make_tiny_llama_gguf

FORMATS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "IQ4_NL", "IQ4_XS")
MAX_LEN = 256
STEPS = 3


def _blocks(fmt, n, k, seed=0):
    return random_blocks(np.random.default_rng(seed), fmt, n * k)


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequant_equals_reference(fmt):
    spec = TQ.TYPE_BY_NAME[fmt]
    raw = _blocks(fmt, 16, 512, 1)
    got = TQ.dequantize(raw, spec.type_id, (16, 512))
    want = JQ.dequantize(raw, spec.type_id, (16, 512))
    assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,k", [(300, 512), (48, 96)])
def test_repack_byte_identical(fmt, n, k):
    if k % TQ.TYPE_BY_NAME[fmt].block_elems:
        k = 256                                   # a K-quant's smallest row
    raw = _blocks(fmt, n, k, n + k)
    want = JR.repack_numpy(raw, fmt, (n, k))
    got = TR.repack_numpy(raw, fmt, (n, k))
    q4b = fmt in ("Q4_0", "Q4_1") and k % 256 == 0
    assert got[0] == want[0] == ("q4b" if q4b else "q8b") and got[4] == want[4]
    for a, b in zip(got[1:4], want[1:4]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    qt = TR.repack(raw, fmt, (n, k), device="cpu")
    w = TR.dequant_qtensor(qt)
    ref = torch.from_numpy(JQ.dequantize(raw, TQ.TYPE_BY_NAME[fmt].type_id, (n, k)))
    # the device layout rounds scales and bias to bf16: within their step
    assert (w - ref).abs().max() <= 2 ** -7 * ref.abs().max()


@pytest.mark.parametrize("fmt", ["Q8_1"])
def test_grid_types_raise(fmt):
    spec = TQ.TYPE_BY_NAME[fmt]
    raw = np.zeros(4 * spec.block_bytes, np.uint8)
    with pytest.raises(NotImplementedError, match=fmt):
        TR.repack_numpy(raw, fmt, (4, 256))
    with pytest.raises(NotImplementedError, match=fmt):
        TQ.dequantize(raw, spec.type_id, (4, 256))


def make_raw_llama_gguf(path, fmts, d_model=256, d_ff=1024, n_heads=2, n_kv_heads=1,
                        seed=0):
    """A tiny llama GGUF through the reference's writer whose layer li's
    matrices (and the head, fmts[-1]) hold random raw blocks of fmts[li]."""
    rng = np.random.default_rng(seed)
    tokens, scores, types = byte_vocab()
    w = JW.GGUFWriter(path)
    for key, val in (("general.architecture", "llama"), ("general.name", "raw-test"),
                     ("llama.block_count", len(fmts)), ("llama.embedding_length", d_model),
                     ("llama.attention.head_count", n_heads),
                     ("llama.attention.head_count_kv", n_kv_heads),
                     ("llama.feed_forward_length", d_ff), ("llama.rope.freq_base", 10000.0),
                     ("llama.attention.layer_norm_rms_epsilon", 1e-5),
                     ("llama.context_length", 512), ("llama.vocab_size", len(tokens)),
                     ("tokenizer.ggml.model", "llama"), ("tokenizer.ggml.tokens", tokens),
                     ("tokenizer.ggml.scores", scores),
                     ("tokenizer.ggml.token_type", np.asarray(types, np.int32)),
                     ("tokenizer.ggml.bos_token_id", 1), ("tokenizer.ggml.eos_token_id", 2),
                     ("tokenizer.ggml.unknown_token_id", 0)):
        w.add(key, val)
    hd = d_model // n_heads
    w.add_tensor_f32("token_embd.weight",
                     rng.standard_normal((len(tokens), d_model)).astype(np.float32) * 0.5)
    for i, fmt in enumerate(fmts):
        p = f"blk.{i}."
        w.add_tensor_f32(p + "attn_norm.weight", np.ones(d_model, np.float32))
        w.add_tensor_f32(p + "ffn_norm.weight", np.ones(d_model, np.float32))
        for name, n, k in (("attn_q", n_heads * hd, d_model),
                           ("attn_k", n_kv_heads * hd, d_model),
                           ("attn_v", n_kv_heads * hd, d_model),
                           ("attn_output", d_model, n_heads * hd),
                           ("ffn_gate", d_ff, d_model), ("ffn_up", d_ff, d_model),
                           ("ffn_down", d_model, d_ff)):
            w.add_tensor(f"{p}{name}.weight", (n, k), fmt, random_blocks(rng, fmt, n * k))
    w.add_tensor_f32("output_norm.weight", np.ones(d_model, np.float32))
    w.add_tensor("output.weight", (len(tokens), d_model), fmts[-1],
                 random_blocks(rng, fmts[-1], len(tokens) * d_model))
    w.write()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("formats")
    return {"Q4_0": make_tiny_llama_gguf(str(d / "q4_0.gguf"), quant="Q4_0", d_model=256,
                                         d_ff=1024, n_heads=2, n_kv_heads=1),
            "Q3_K": make_raw_llama_gguf(str(d / "q3_k.gguf"), ("Q3_K", "Q3_K")),
            "Q2_K": make_raw_llama_gguf(str(d / "q2_k.gguf"), ("Q2_K", "Q2_K")),
            "mixed": make_raw_llama_gguf(str(d / "mixed.gguf"), ("Q5_1", "IQ4_XS"))}


def _ids(n=24):
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = np.random.default_rng(11).integers(3, 250, n)
    return toks, n


def _jax_steps(path):
    cfg, params, tok, _ = j_load_llama(path)
    eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
    fwd = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))
    toks, n = _ids()
    cache = JL.init_cache(cfg, 1, MAX_LEN)
    lg, cache = fwd(eng.params, cfg, jnp.asarray(toks), jnp.zeros((1,), jnp.int32), cache,
                    fresh_prefill=True, last_idx=jnp.full((1,), n - 1, jnp.int32))
    logits, fed = [np.asarray(lg[0, -1])], []
    for i in range(STEPS):
        fed.append(int(np.argmax(logits[-1])))
        lg, cache = fwd(eng.params, cfg, jnp.full((1, 1), fed[-1], jnp.int32),
                        jnp.full((1,), n + i, jnp.int32), cache, attn_len=MAX_LEN)
        logits.append(np.asarray(lg[0, -1]))
    return fed, np.stack(logits)


@pytest.mark.parametrize("fmt,kind,g", [("Q4_0", "q4b", 32), ("Q3_K", "q8b", 16),
                                         ("Q2_K", "q8b", 16)])
def test_engine_logits_match_reference(files, fmt, kind, g):
    path = files[fmt]
    fed, want = _interpreted(lambda: _jax_steps(path))
    eng = load_engine(path, device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers, TL.LlamaLayer)           # one format: stacked
    assert (eng.params.layers.wqkv.kind, eng.params.layers.wqkv.g) == (kind, g)
    toks, n = _ids()
    cache = eng.new_cache()
    lg, _ = TL.forward(eng.params, eng.cfg, torch.from_numpy(toks),
                       torch.zeros(1, dtype=torch.int32), cache, fresh_prefill=True,
                       last_idx=torch.full((1,), n - 1, dtype=torch.int32))
    got = [lg[0, -1]]
    for i, t in enumerate(fed):
        lg, _ = TL.forward(eng.params, eng.cfg, torch.full((1, 1), t, dtype=torch.int32),
                           torch.full((1,), n + i, dtype=torch.int32), cache,
                           attn_len=MAX_LEN)
        got.append(lg[0, -1])
    for i, (a, b) in enumerate(zip(torch.stack(got).numpy(), want)):
        assert np.abs(a - b).max() <= (2e-2 if i == 0 else 5e-2) * np.abs(b).max(), i


def test_mixed_formats_stay_unrolled_and_generate(files):
    eng = load_engine(files["mixed"], device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers, list)
    assert [(l.wqkv.kind, l.wqkv.bias is not None) for l in eng.params.layers] == [
        ("q8b", True), ("q8b", False)]                  # Q5_1's min; IQ4_XS none
    out = [t for t, _ in eng.generate("hi", max_tokens=4, stop_on_eog=False)]
    assert len(out) == 4


def _metadata(w):
    w.add("general.architecture", "llama")
    w.add("a.bool", True)
    w.add("a.u32", 7)
    w.add("a.i64", -3)
    w.add("a.big", 2 ** 40)
    w.add("a.f32", 0.25)
    w.add("a.u64", 5, JW.T_U64)
    w.add("a.i32", -9, JW.T_I32)
    w.add("a.strs", ["x", "yz", ""])
    w.add("a.floats", [1.5, -2.0])
    w.add("a.ints", [1, -2, 3])
    w.add("a.np_i32", np.arange(5, dtype=np.int32))
    w.add("a.np_u32", np.arange(3, dtype=np.uint32))
    w.add("a.np_f32", np.linspace(0, 1, 4, dtype=np.float32))


def _tensors(w, rng):
    w.add_tensor_f32("t.f32", rng.standard_normal((3, 5)).astype(np.float32))
    w.add_tensor_f16("t.f16", rng.standard_normal((7,)).astype(np.float32))
    for fmt in ("Q4_0", "Q3_K", "IQ4_XS", "Q4_K"):
        w.add_tensor(f"t.{fmt}", (2, 256), fmt, random_blocks(rng, fmt, 512))


def test_writer_byte_identical_and_read_back(tmp_path):
    files = []
    for mod in (JW, TW):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.gguf")
        w = mod.GGUFWriter(path)
        _metadata(w)
        _tensors(w, np.random.default_rng(3))
        w.write()
        files.append(path)
    ref, port = (open(p, "rb").read() for p in files)
    assert port == ref
    r = GGUFReader(files[1])
    assert r.metadata["a.strs"] == ["x", "yz", ""] and r.metadata["a.big"] == 2 ** 40
    assert r.metadata["a.bool"] is True and r.metadata["a.i32"] == -9
    rng = np.random.default_rng(3)
    rng.standard_normal((3, 5))
    rng.standard_normal((7,))
    for fmt in ("Q4_0", "Q3_K", "IQ4_XS", "Q4_K"):
        blocks = random_blocks(rng, fmt, 512)
        t = r.tensors[f"t.{fmt}"]
        assert t.type_name == fmt and t.shape == (2, 256) and t.offset % TW.ALIGNMENT == 0
        np.testing.assert_array_equal(np.asarray(r.tensor_bytes(f"t.{fmt}")).reshape(-1),
                                      blocks.reshape(-1))


def test_writer_value_types(tmp_path):
    """The GGUF value types the reference's writer leaves out: u8, i8, u16,
    i16 and f64 are read back as written."""
    path = str(tmp_path / "types.gguf")
    w = TW.GGUFWriter(path)
    for key, val, t in (("u8", 200, TW.T_U8), ("i8", -100, TW.T_I8), ("u16", 60000, TW.T_U16),
                        ("i16", -30000, TW.T_I16), ("f64", 0.1, TW.T_F64)):
        w.add(f"v.{key}", val, t)
    w.write()
    md = GGUFReader(path).metadata
    assert [md[f"v.{k}"] for k in ("u8", "i8", "u16", "i16", "f64")] == [
        200, -100, 60000, -30000, 0.1]


@pytest.mark.parametrize("zip64", [False, True])
def test_pack_zip_byte_identical(tmp_path, monkeypatch, zip64):
    src = str(tmp_path / "m.gguf")
    w = TW.GGUFWriter(src)
    _metadata(w)
    _tensors(w, np.random.default_rng(4))
    w.write()
    other = tmp_path / "notes.txt"
    other.write_bytes(b"x" * 5000)
    if zip64:                                  # every member and offset past the threshold
        monkeypatch.setattr(JW, "_ZIP64_THRESHOLD", 1000)
        monkeypatch.setattr(TW, "_ZIP64_THRESHOLD", 1000)
    out = []
    for mod in (JW, TW):
        z = str(tmp_path / f"{mod.__name__.split('.')[0]}.zip")
        mod.pack_zip(z, {"model.gguf": src, "notes.txt": str(other)})
        out.append(z)
    assert open(out[1], "rb").read() == open(out[0], "rb").read()
    with zipfile.ZipFile(out[1]) as zf:
        assert zf.testzip() is None
    assert GGUFReader(out[1]).metadata["a.strs"] == ["x", "yz", ""]
