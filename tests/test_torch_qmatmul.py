"""The port's quantized matmuls (llamafile_tpu_torch.ops.qmatmul) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

The same numpy-seeded weights and activations go to both. Tolerances:
  * activation codes: exact; activation scales: rtol 1e-6 (the rsqrt of the
    folded RMSNorm may differ in its last bit between the two libraries);
  * txn_m1 / txn: rtol 1e-5 with atol 1e-5 x max|y|: the int32 group dots
    are exact on both sides, only the order of the f32 group sums differs;
  * moe_m1: atol 2e-3 x max|y|: on top of that, an ulp of difference in
    silu(g)*u can move one requantized code by one step;
  * q8_m1: as txn_m1 (exact int32 group dots, f32 group sums reordered);
  * dequant: rtol 1e-5 with atol 1e-5 x max|y|: the bf16 weight products
    are exact in f32 on both sides and only their f32 sums are reordered
    (measured: within 3.4e-7 of max|y|, prenormed or not).
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from llamafile_tpu.models.synthetic import _rand_qtensor
from llamafile_tpu.ops import qmatmul as JQ
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch.ops import qmatmul as TQ
from llamafile_tpu_torch.ops.repack import QTensor as TQT
from llamafile_tpu_torch.runtime.kvcache import init_kv

D, DFF, L = 256, 1024, 3


def tt(a):
    """JAX array -> torch CPU tensor of the same values (bf16 kept bf16)."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32)).copy()).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(a).copy())


def to_torch(qt):
    return TQT(qt.kind, qt.shape, qt.g, tt(qt.qs), tt(qt.scales), tt(qt.bias), qt.il)


def stacked(rng, n, k, layers=L, quant="Q4_K"):
    qts = [_rand_qtensor(rng, n, k, quant) for _ in range(layers)]
    st = lambda a: None if a[0] is None else jnp.stack(a)
    return JR.QTensor(qts[0].kind, (n, k), qts[0].g, st([q.qs for q in qts]),
                      st([q.scales for q in qts]), st([q.bias for q in qts]))


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("use_nrm", [False, True])
@pytest.mark.parametrize("m", [1, 16])
def test_quantize_activations_g32(use_nrm, m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 1024)).astype(np.float32) * 3
    x[0, :32] = 0.0                                  # an all-zero group
    nrm = (1 + 0.2 * rng.standard_normal(1024)).astype(np.float32) if use_nrm else None
    jq, js = JQ.quantize_activations_g32(
        jnp.asarray(x), None if nrm is None else jnp.asarray(nrm), 1e-5)
    tq, ts = TQ.quantize_activations_g32(
        torch.from_numpy(x), None if nrm is None else torch.from_numpy(nrm), 1e-5)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("stack", [False, True])
def test_txn_m1_plain_matches_pallas(stack):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, D)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    if stack:
        qt = stacked(rng, 512, D)
        want = JQ._qmm_call_txn_m1_stacked(
            jnp.asarray(x), qt.qs, qt.scales, jnp.int32(1), qt.bias,
            jnp.asarray(nrm), eps=1e-5, interpret=True)
        tq = to_torch(qt)
        w = (tq.qs[1], tq.scales[1], tq.bias[1])
    else:
        qt = _rand_qtensor(rng, 1000, D, "Q4_K")        # N padded 1000 -> 2048
        want = JQ._qmm_call_txn_m1(jnp.asarray(x), qt.qs, qt.scales, qt.bias,
                                   jnp.asarray(nrm), eps=1e-5, interpret=True)
        tq = to_torch(qt)
        w = (tq.qs, tq.scales, tq.bias)
    xq, sx = TQ.quantize_activations_g32(torch.from_numpy(x),
                                         torch.from_numpy(nrm), 1e-5)
    close(TQ.qmm_txn_m1(xq, sx, *w), want, 1e-5)


@pytest.mark.parametrize("m", [8, 16, 32])
def test_txn_plain_matches_pallas(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, D)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    qt = stacked(rng, 2048, D)
    want = JQ._qmm_call_txn_stacked(jnp.asarray(x), qt.qs, qt.scales,
                                    jnp.int32(2), qt.bias, jnp.asarray(nrm),
                                    eps=1e-5, interpret=True)
    tq = to_torch(qt)
    xq, sx = TQ.quantize_activations_g32(torch.from_numpy(x),
                                         torch.from_numpy(nrm), 1e-5)
    close(TQ.qmm_txn(xq, sx, tq.qs[2], tq.scales[2], tq.bias[2]), want, 1e-5)


def _ffn_stacks(rng):
    gu = [JR.interleave_gateup(_rand_qtensor(rng, DFF, D, "Q4_K"),
                               _rand_qtensor(rng, DFF, D, "Q4_K")) for _ in range(L)]
    dn = [_rand_qtensor(rng, D, DFF, "Q4_K") for _ in range(L)]
    st = lambda qts, il: JR.QTensor(
        "q4b", qts[0].shape, 32, jnp.stack([q.qs for q in qts]),
        jnp.stack([q.scales for q in qts]), jnp.stack([q.bias for q in qts]), il)
    return st(gu, True), st(dn, False)


def test_moe_m1_plain_matches_pallas():
    rng = np.random.default_rng(5)
    gu, dn = _ffn_stacks(rng)
    x = rng.standard_normal((1, D)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    li = 2
    want = JQ._qmm_call_moe_m1(
        jnp.asarray(x), gu.qs, gu.scales, gu.bias, dn.qs, dn.scales, dn.bias,
        jnp.full((1,), li, jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.ones((1,), jnp.float32), jnp.asarray(nrm), eps=1e-5,
        interpret=True)[:, :D]                      # storage N is padded
    tgu, tdn = to_torch(gu), to_torch(dn)
    assert TQ.moe_fusable(tgu, tdn, D, DFF)
    got = TQ.qmatmul_moe(torch.from_numpy(x), tgu, tdn,
                         torch.tensor([li], dtype=torch.int32), torch.ones(1),
                         prenorm=(torch.from_numpy(nrm), 1e-5))
    close(got, want, 2e-3)


def test_moe_fusable_checks_down_depth():
    rng = np.random.default_rng(6)
    gu, _ = _ffn_stacks(rng)
    bad_dn = stacked(rng, D, 2 * DFF)
    with pytest.raises(ValueError, match="depth"):
        TQ.moe_fusable(to_torch(gu), to_torch(bad_dn), D, DFF)


@pytest.mark.parametrize("stack", [False, True])
@pytest.mark.parametrize("quant,with_bias", [("Q8_0", False), ("Q6_K", False),
                                             ("Q8_0", True)])
def test_q8_m1_plain_matches_pallas(stack, quant, with_bias):
    rng = np.random.default_rng(31 + stack)
    x = rng.standard_normal((1, D)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    qt = stacked(rng, 512, D, quant=quant) if stack else _rand_qtensor(rng, 1000, D, quant)
    bias = None
    if with_bias:                    # a q8b format with mins (Q5_1, Q2_K, ...)
        bias = jnp.asarray(rng.uniform(-0.1, 0.0, qt.scales.shape), jnp.bfloat16)
    pn = dict(nrm=jnp.asarray(nrm), eps=1e-5, g=qt.g, interpret=True)
    if stack:
        want = JQ._qmm_call_q8_m1_stacked(jnp.asarray(x), qt.qs, qt.scales,
                                          jnp.int32(1), bias, **pn)
    else:
        want = JQ._qmm_call_q8_m1(jnp.asarray(x), qt.qs, qt.scales, bias, **pn)
    tq, tb = to_torch(qt), tt(bias)
    w = ((tq.qs[1], tq.scales[1], None if tb is None else tb[1]) if stack
         else (tq.qs, tq.scales, tb))
    xq, sx = TQ.quantize_activations_g32(torch.from_numpy(x),
                                         torch.from_numpy(nrm), 1e-5)
    close(TQ.qmm_q8_m1(xq, sx, *w), want, 1e-5)


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("quant,prenorm", [("Q4_K", False), ("Q4_K", True),
                                           ("Q8_0", True), ("Q6_K", False)])
def test_dequant_plain_matches_pallas(m, quant, prenorm):
    """qmatmul on stacked weights at M > 32: the reference runs _qmm_call
    (the _qmm_kernel slice-copy branch) in interpret mode and adds the bias
    outside; the port runs qmm_dequant's plain version the same way."""
    rng = np.random.default_rng(m + len(quant))
    qt = stacked(rng, 512, 2 * D, quant=quant)
    x = rng.standard_normal((m, 2 * D)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(2 * D)).astype(np.float32)
    jpn = (jnp.asarray(nrm), 1e-5) if prenorm else None
    tpn = (torch.from_numpy(nrm), 1e-5) if prenorm else None
    want = JQ.qmatmul(jnp.asarray(x), qt, li=jnp.int32(2), prenorm=jpn)
    got = TQ.qmatmul(torch.from_numpy(x), to_torch(qt), li=2, prenorm=tpn)
    assert tuple(got.shape) == tuple(want.shape) == (m, 512)
    close(got, want, 1e-5)


@pytest.mark.parametrize("quant", ["Q4_K", "Q8_0", "Q6_K"])
def test_dispatch_by_rows(monkeypatch, quant):
    """The reference's branch order at M in (1, 16, 64, 128) for each kind."""
    calls = []
    for name in ("qmm_txn_m1", "qmm_txn", "qmm_q8_m1", "qmm_dequant"):
        real = getattr(TQ, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(TQ, name, spy)
    qt = to_torch(stacked(np.random.default_rng(4), 512, D, quant=quant))
    for m in (1, 16, 64, 128):
        assert TQ.qmatmul(torch.randn(m, D), qt, li=1).shape == (m, 512)
    small = ["qmm_txn_m1", "qmm_txn"] if quant == "Q4_K" else ["qmm_q8_m1", "qmm_dequant"]
    assert calls == small + ["qmm_dequant", "qmm_dequant"]


def test_dispatch_reaches_the_ported_branches(monkeypatch):
    """Q4_K and q8b fixtures reach exactly the ported branches, unstacked
    and stacked, and what is still unported raises NotImplementedError."""
    calls = []
    for name in ("qmm_txn_m1", "qmm_txn", "qmm_moe_m1", "qmm_q8_m1", "qmm_dequant"):
        real = getattr(TQ, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(TQ, name, spy)
    rng = np.random.default_rng(9)
    st = to_torch(stacked(rng, 512, D))
    un = to_torch(_rand_qtensor(rng, 512, D, "Q4_K"))
    gu, dn = (to_torch(q) for q in _ffn_stacks(rng))
    x1, x16 = torch.randn(1, D), torch.randn(16, D)
    assert TQ.qmatmul(x1, un).shape == (1, 512)
    assert TQ.qmatmul(x1, st, li=1).shape == (1, 512)
    assert TQ.qmatmul(x16, st, li=1).shape == (16, 512)
    assert TQ.qmatmul(x16, un).shape == (16, 512)
    TQ.qmatmul_moe(x1, gu, dn, torch.zeros(1, dtype=torch.int32), torch.ones(1))
    assert calls == ["qmm_txn_m1", "qmm_txn_m1", "qmm_txn", "qmm_txn", "qmm_moe_m1"]
    del calls[:]
    assert TQ.qmatmul(torch.randn(33, D), st, li=0).shape == (33, 512)
    q8 = TQT("q8b", (512, D), 32, torch.zeros(D, 512, dtype=torch.int8),
             torch.ones(D // 32, 512, dtype=torch.bfloat16))
    assert TQ.qmatmul(x1, q8).shape == (1, 512)
    assert TQ.qmatmul(x16, q8).shape == (16, 512)
    assert calls == ["qmm_dequant", "qmm_q8_m1", "qmm_dequant"]
    with pytest.raises(NotImplementedError, match="kind"):
        TQ.qmatmul(x1, TQT("q2x", (512, D), 32, q8.qs))
    # the int8 KV cache is ported; an f16 cache is not
    assert init_kv(2, 1, 64, 2, 128, dtype="int8", device="cpu").k.dtype == torch.int8
    with pytest.raises(NotImplementedError, match="bf16 or int8"):
        init_kv(2, 1, 64, 2, 128, dtype="f16")


@pytest.mark.parametrize("kind", ["q4b", "dense", "q8b"])
def test_qmatmul_fallback_matches_reference(kind):
    """The materialized-dequant reference path, both packages."""
    rng = np.random.default_rng(13)
    qt = _rand_qtensor(rng, 300, D, {"q4b": "Q4_K", "dense": "F16", "q8b": "Q6_K"}[kind])
    x = rng.standard_normal((4, D)).astype(np.float32)
    want = JQ.qmatmul_fallback(jnp.asarray(x), qt)
    got = TQ.qmatmul_fallback(torch.from_numpy(x), to_torch(qt))
    close(got, want, 1e-5)
