"""The grid IQ types (IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M)
and the rest of the reference's dequantize (Q8_K, F64, I8-I64), against
the JAX package, on the CPU.

- the port's copy of iq_grids.npz holds the reference's arrays;
- dequantization equals the reference's (np.array_equal) on random blocks
  whose d is small and finite (models.synthetic.random_blocks: IQ1_M's d is
  spelled by the top nibbles of its four scales);
- the repack is byte-identical to repack_numpy at (300, 512) and (48, 256):
  q8b with g 32 (IQ2_XXS, IQ3_XXS, IQ3_S; IQ1_S with a bias), g 16 (IQ2_XS,
  IQ2_S) and g 8 with a bias (IQ1_M), and concat_qtensors at g 8 is the
  reference's;
- product_route names the kernel of the reference's branch, seen by spying
  on the reference's kernel calls: qmm_dequant for IQ1_M at every M,
  stacked and not, qmm_q8_m1 at M = 1 for the other six; the products agree;
- an Engine on a tiny IQ1_M file and one on a tiny IQ2_XS file hold their
  logits against the JAX Engine's, its Pallas kernels interpreted (one
  shared run): the prefill within 2e-2 and three decode steps within 5e-2
  of the largest logit, as tests/test_torch_formats.py holds Q3_K.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

import llamafile_tpu.gguf as jg
import llamafile_tpu.ops.qmatmul as JQM
import llamafile_tpu_torch.gguf as tg
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch.gguf import quants as TQ
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.synthetic import random_blocks
from llamafile_tpu_torch.ops import qmatmul as TQM
from llamafile_tpu_torch.ops import repack as TR
from llamafile_tpu_torch.runtime.engine import load_engine
from tests.test_torch_formats import MAX_LEN, _ids, _jax_steps, make_raw_llama_gguf
from tests.test_torch_q4km import _interpreted, _one_torch_thread  # noqa: F401
from tests.test_torch_repack import bits

GRID = ("IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M")
# (g, bias) of each type's q8b layout
LAYOUT = {"IQ2_XXS": (32, False), "IQ2_XS": (16, False), "IQ2_S": (16, False),
          "IQ3_XXS": (32, False), "IQ3_S": (32, False), "IQ1_S": (32, True),
          "IQ1_M": (8, True)}
REST = ("Q8_K", "F64", "I8", "I16", "I32", "I64")


def _blocks(fmt, n, k, seed=0):
    return random_blocks(np.random.default_rng(seed), fmt, n * k)


def _rest_raw(fmt, n_elems, seed=0):
    """Raw bytes of one of REST: finite values (Q8_K's f32 d small)."""
    rng = np.random.default_rng(seed)
    if fmt == "Q8_K":
        b = rng.integers(0, 256, (n_elems // 256, 292), dtype=np.uint8)
        b[:, 0:4] = rng.uniform(1e-4, 1e-3, len(b)).astype(np.float32).view(
            np.uint8).reshape(-1, 4)
        return b.reshape(-1)
    if fmt == "F64":
        return rng.standard_normal(n_elems).view(np.uint8)
    dt = TQ.DENSE_INTS[fmt]
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n_elems, dtype=dt, endpoint=True).view(np.uint8)


def test_grids_equal_reference():
    assert filecmp.cmp(os.path.join(os.path.dirname(tg.__file__), "iq_grids.npz"),
                       os.path.join(os.path.dirname(jg.__file__), "iq_grids.npz"),
                       shallow=False)
    got, want = TQ._grids(), JQ._grids()
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name])


@pytest.mark.parametrize("fmt", GRID)
def test_dequant_equals_reference(fmt):
    spec = TQ.TYPE_BY_NAME[fmt]
    raw = _blocks(fmt, 16, 512, 1)
    got = TQ.dequantize(raw, spec.type_id, (16, 512))
    want = JQ.dequantize(raw, spec.type_id, (16, 512))
    assert got.dtype == want.dtype == np.float32 and np.isfinite(got).all()
    assert np.array_equal(got, want)
    assert 0.01 < np.sqrt((got ** 2).mean()) < 0.1      # spread as the other formats


@pytest.mark.parametrize("fmt", REST)
def test_rest_of_dequantize_equals_reference(fmt):
    spec = TQ.TYPE_BY_NAME[fmt]
    raw = _rest_raw(fmt, 8 * 256, 2)
    got = TQ.dequantize(raw, spec.type_id, (8, 256))
    want = JQ.dequantize(raw, spec.type_id, (8, 256))
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    kind, qs, *_ = TR.repack_numpy(raw, fmt, (8, 256))
    jkind, jqs, *_ = JR.repack_numpy(raw, fmt, (8, 256))
    assert kind == jkind == "dense" and np.array_equal(qs, jqs)


def _assert_same_repack(got, want):
    assert got[0] == want[0] and got[4] == want[4]
    for a, b in zip(got[1:4], want[1:4]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("fmt", GRID)
@pytest.mark.parametrize("n,k", [(300, 512), (48, 256)])
def test_repack_byte_identical(fmt, n, k):
    raw = _blocks(fmt, n, k, n + k)
    got = TR.repack_numpy(raw, fmt, (n, k))
    _assert_same_repack(got, JR.repack_numpy(raw, fmt, (n, k)))
    g, bias = LAYOUT[fmt]
    assert (got[0], got[4], got[3] is not None) == ("q8b", g, bias)
    qt = TR.repack(raw, fmt, (n, k), device="cpu")
    assert qt.scales.shape == (k // g, 2048) and (qt.bias is not None) == bias
    w = TR.dequant_qtensor(qt)
    ref = torch.from_numpy(JQ.dequantize(raw, TQ.TYPE_BY_NAME[fmt].type_id, (n, k)))
    # the device layout rounds scales and bias to bf16: within their step
    assert (w - ref).abs().max() <= 2 ** -7 * ref.abs().max()


def test_concat_at_g8_is_the_reference():
    """IQ1_M's q8b g 8 with a bias through concat_qtensors (the fused qkv and
    gate|up): the reference's leaves, byte for byte."""
    ns = (256, 64, 64)
    raws = [_blocks("IQ1_M", n, 256, n) for n in ns]
    tc = TR.concat_qtensors([TR.repack(r, "IQ1_M", (n, 256), device="cpu")
                             for r, n in zip(raws, ns)])
    jc = JR.concat_qtensors([JR.repack(r, "IQ1_M", (n, 256)) for r, n in zip(raws, ns)])
    assert (tc.kind, tc.shape, tc.g) == (jc.kind, jc.shape, jc.g) == ("q8b", (384, 256), 8)
    for t, j in ((tc.qs, jc.qs), (tc.scales, jc.scales), (tc.bias, jc.bias)):
        np.testing.assert_array_equal(bits(t), bits(j))


_REF_ROUTES = {"_qmm_call": "qmm_dequant", "_qmm_call_q8_m1": "qmm_q8_m1",
               "_qmm_call_q8_m1_stacked": "qmm_q8_m1"}


@pytest.mark.parametrize("fmt", GRID)
def test_route_is_the_reference_branch(fmt, monkeypatch):
    n, k = 256, 512
    raws = [_blocks(fmt, n, k, li) for li in range(2)]
    tqs = [TR.repack(r, fmt, (n, k), device="cpu") for r in raws]
    jqs = [JR.repack(r, fmt, (n, k)) for r in raws]
    st = lambda ts, f: None if ts[0] is None else f(ts)
    tstack = TR.QTensor("q8b", (n, k), tqs[0].g, torch.stack([q.qs for q in tqs]),
                        torch.stack([q.scales for q in tqs]),
                        st([q.bias for q in tqs], torch.stack))
    jstack = JR.QTensor("q8b", (n, k), jqs[0].g, jnp.stack([q.qs for q in jqs]),
                        jnp.stack([q.scales for q in jqs]),
                        st([q.bias for q in jqs], jnp.stack))
    seen = []
    for name in _REF_ROUTES:
        orig = getattr(JQM, name)
        monkeypatch.setattr(JQM, name, lambda *a, _o=orig, _n=name, **kw:
                            (seen.append(_n), _o(*a, **kw))[1])
    for m in (1, 40):
        x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
        for li in (None, 1):
            seen.clear()
            jqt, tqt = (jqs[1], tqs[1]) if li is None else (jstack, tstack)
            want = np.asarray(JQM.qmatmul(jnp.asarray(x), jqt,
                                          None if li is None else jnp.int32(li)))
            route = TQM.product_route(tqt, m, k, li)
            assert len(set(seen)) == 1, seen                  # one kernel a product
            assert route == _REF_ROUTES[seen[0]], (m, li, seen)
            if fmt == "IQ1_M" or m > 1:
                assert route == "qmm_dequant"
            else:
                assert route == "qmm_q8_m1"
            got = TQM.qmatmul(torch.from_numpy(x), tqt, li).numpy()
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), (m, li)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid")
    return {fmt: make_raw_llama_gguf(str(d / f"{fmt.lower()}.gguf"), (fmt, fmt))
            for fmt in ("IQ1_M", "IQ2_XS")}


@pytest.fixture(scope="module")
def jax_steps(files):
    """The JAX Engine's prefill and decode logits of both files, from one
    interpreted run."""
    return _interpreted(lambda: {fmt: _jax_steps(path) for fmt, path in files.items()})


@pytest.mark.parametrize("fmt,g,bias", [("IQ1_M", 8, True), ("IQ2_XS", 16, False)])
def test_engine_logits_match_reference(files, jax_steps, fmt, g, bias):
    fed, want = jax_steps[fmt]
    eng = load_engine(files[fmt], device="cpu", max_seq_len=MAX_LEN)
    layers = eng.params.layers
    assert isinstance(layers, TL.LlamaLayer)                    # one format: stacked
    assert (layers.wqkv.kind, layers.wqkv.g, layers.wqkv.bias is not None) == ("q8b", g, bias)
    assert layers.w_gate_up is not None and layers.w_gate_up.g == g
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


def test_non_finite_block_raises():
    """A block whose d is inf gives no int8 codes: the repack raises (the
    reference's assert, a check that -O keeps)."""
    raw = _blocks("IQ1_S", 16, 256, 3)
    raw[:, 0:2] = np.array([np.inf], np.float16).view(np.uint8)
    with np.errstate(invalid="ignore"), pytest.raises(ValueError, match="IQ1_S"):
        TR.repack_numpy(raw, "IQ1_S", (16, 256))
