"""The q4b kernel flavours (LLAMAFILE_TPU_Q4B: txn, int8, planes, concat) of
the port against the JAX package's, on the CPU.

The flavour is set by patching both packages' Q4B_KERNEL, with the JAX
caches cleared before and after (its jitted callers read the global at
trace time). The JAX side runs its Pallas kernels in interpret mode. Each
case names the kernel that ran on both sides (patched wrappers record it)
and holds the port's against the reference's branch.

Tolerances, each of the largest output, with what was measured:
- qmm_int8 (plain on the CPU) against _qmm_call_int8(_stacked): 1e-6. The
  int32 group dots are exact on both sides; only the f32 order of the group
  sums differs (measured: up to 2.5e-7).
- the planes kernel on layer 1 of a stack against _qmm_call_planes_stacked:
  1e-6 in f32 (M = 8; measured 1.9e-7); 2^-7, one bf16 step, from a
  padded M of 256, where both round to bf16.
- qmatmul per flavour: 1e-5 on the int8-activation routes (codes of the
  same normed x, f32 order only) and on the dequant GEMM and the f32
  planes products of an un-normed x; 1e-3 on those two with the RMSNorm
  first (an ulp between the two packages' RMSNorms flips a bf16 rounding
  of an activation; measured 7.0e-5); 2^-6 on bf16 planes outputs (the
  product's bf16 rounding, then the bias term added in bf16).

Whole models under the flavours are tests/test_torch_q4b_model.py's.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from llamafile_tpu.models.synthetic import _rand_qtensor
from llamafile_tpu.ops import qmatmul as JQ
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch.ops import qmatmul as TQ
from llamafile_tpu_torch.ops import reset_launch_counts
from llamafile_tpu_torch.testing import q4b_scale_swap
from tests.test_torch_qmatmul import stacked, to_torch

FLAVOURS = ("txn", "int8", "planes", "concat")
N, K = 500, 512                   # logical N; storage pads to 2048


def rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return np.abs(got - want).max() / np.abs(want).max()


@contextlib.contextmanager
def flavour(name, traced=True):
    """Both packages' q4b kernel flavour set to `name` inside the block.
    traced: the block runs jitted JAX code that calls qmatmul while it is
    traced (a model), so the JAX caches are cleared before and after; a
    direct qmatmul call reads the flavour on every call, outside its
    jitted kernels, and may keep them."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JQ, "Q4B_KERNEL", name)
    mp.setattr(TQ, "Q4B_KERNEL", name)
    if traced:
        jax.clear_caches()
    try:
        yield
    finally:
        mp.undo()
        if traced:
            jax.clear_caches()


# ---------------------------------------------------------------------------
# The kernels of rows 12-14
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,layers", [(8, 0), (16, 0), (32, 0), (8, 3), (32, 3)],
                         ids=["M8", "M16", "M32", "M8-stacked", "M32-stacked"])
def test_int8_matches_pallas(m, layers):
    """qmm_int8 against _qmm_call_int8, or _qmm_call_int8_stacked on layer 1
    of 3 (layers 3), on the same x; the port takes its codes from the same
    quantize_activations_g32 (bit-identical, tests/test_torch_qmatmul.py)."""
    rng = np.random.default_rng(m + layers)
    qt = stacked(rng, 512, 1024, layers) if layers else _rand_qtensor(rng, 512, 1024, "Q4_K")
    x = rng.standard_normal((m, 1024)).astype(np.float32)
    tq = to_torch(qt)
    if layers:
        want = JQ._qmm_call_int8_stacked(jnp.asarray(x), qt.qs, qt.scales, 1, interpret=True)
        qs, sc = tq.qs[1], tq.scales[1]
    else:
        want = JQ._qmm_call_int8(jnp.asarray(x), qt.qs, qt.scales, interpret=True)
        qs, sc = tq.qs, tq.scales
    xq, sx = TQ.quantize_activations_g32(torch.from_numpy(x))
    got = TQ.qmm_int8(xq, sx, qs, sc)
    assert got.shape == (m, 2048) and got.dtype == torch.float32      # storage N
    assert rel(got, want) <= 1e-6
    # the control: lo and hi scale rows of each superblock swapped
    assert rel(q4b_scale_swap(xq, sx, qs, sc), want) > 1e-2


@pytest.mark.parametrize("m", [8, 256])
def test_planes_stacked_matches_pallas(m):
    """Row 12: qmm_planes on layer 1 of 3 (views of the stack) against
    _qmm_call_planes_stacked: f32 out at M = 8, bf16 from 256."""
    rng = np.random.default_rng(40 + m)
    qt = stacked(rng, 512, 1024)
    x = rng.standard_normal((m, 1024)).astype(np.float32)
    want = JQ._qmm_call_planes_stacked(jnp.asarray(x), qt.qs, qt.scales, 1, interpret=True)
    tq = to_torch(qt)
    got = TQ.qmm_planes(torch.from_numpy(x), tq.qs[1], tq.scales[1])
    assert got.dtype == (torch.bfloat16 if m >= 256 else torch.float32)
    assert str(want.dtype) == ("bfloat16" if m >= 256 else "float32")
    assert rel(got, want) <= (2 ** -7 if m >= 256 else 1e-6)


# ---------------------------------------------------------------------------
# qmatmul's branches per flavour
# ---------------------------------------------------------------------------

# the reference's call of each branch, as the port names its kernel
J_CALLS = {"_qmm_call_q8_m1": "qmm_q8_m1", "_qmm_call_txn_m1": "qmm_txn_m1",
           "_qmm_call_txn": "qmm_txn", "_qmm_call_int8": "qmm_int8",
           "_qmm_call_planes": "qmm_planes", "_qmm_call": "qmm_dequant"}
T_KERNELS = ("qmm_q8_m1", "qmm_txn_m1", "qmm_txn", "qmm_int8", "qmm_planes", "qmm_dequant")


def _spy(mp, mod, name, label, ran):
    fn = getattr(mod, name)

    def spy(*a, **kw):
        ran.append(label)
        return fn(*a, **kw)
    mp.setattr(mod, name, spy)


@functools.lru_cache(maxsize=None)
def _weight(quant, layers):
    rng = np.random.default_rng(7 if quant == "Q4_K" else 8)
    qt = stacked(rng, N, K, layers, quant) if layers else _rand_qtensor(rng, N, K, quant)
    return qt, to_torch(qt)


@pytest.mark.parametrize("quant,prenorm", [("Q4_K", True), ("Q8_0", False)],
                         ids=["q4k-norm", "q8_0"])
@pytest.mark.parametrize("layers", [0, 2], ids=["unstacked", "stacked"])
@pytest.mark.parametrize("m", [1, 8, 32, 64, 256])
@pytest.mark.parametrize("flav", FLAVOURS)
def test_qmatmul_matches_jax(flav, m, layers, quant, prenorm):
    """One product per case, stacked ones on layer 1 of 2; both sides name
    their kernel and must name the same one."""
    jqt, tqt = _weight(quant, layers)
    assert (tqt.bias is not None) == (quant == "Q4_K")
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    li = 1 if layers else None
    j_ran, t_ran = [], []
    mp = pytest.MonkeyPatch()
    for name, label in J_CALLS.items():
        for suffix in ("", "_stacked"):
            if hasattr(JQ, name + suffix):
                _spy(mp, JQ, name + suffix, label, j_ran)
    for name in T_KERNELS:
        _spy(mp, TQ, name, name, t_ran)
    try:
        with flavour(flav, traced=False):
            want = JQ.qmatmul(jnp.asarray(x), jqt, li,
                              prenorm=(jnp.asarray(nrm), 1e-5) if prenorm else None)
            got = TQ.qmatmul(torch.from_numpy(x), tqt, li,
                             prenorm=(torch.from_numpy(nrm), 1e-5) if prenorm else None)
            route = TQ.product_route(tqt, m, K, li)
    finally:
        mp.undo()
    assert t_ran == j_ran == [route], (t_ran, j_ran, route)
    assert tuple(got.shape) == (m, N) and str(got.dtype)[6:] == str(want.dtype)
    assert rel(got, want) <= (2 ** -6 if got.dtype == torch.bfloat16
                              else 1e-3 if prenorm and route in ("qmm_planes", "qmm_dequant")
                              else 1e-5)


@pytest.mark.parametrize("m,layers,route", [
    (1, 2, "qmm_int8"), (32, 2, "qmm_int8"), (33, 2, "qmm_planes"), (1, 0, "qmm_int8"),
    (300, 0, "qmm_planes")])
def test_int8_flavour_routes(m, layers, route):
    """product_route under int8 by padded M: stacked and unstacked q4b at M
    up to 32 on qmm_int8, above on the planes kernel (bf16 from 256)."""
    _, tqt = _weight("Q4_K", layers)
    with flavour("int8", traced=False):
        assert TQ.product_route(tqt, m, K, 1 if layers else None) == route
        y = TQ.qmatmul(torch.zeros((m, K)), tqt, 1 if layers else None)
    assert y.shape == (m, N) and y.dtype == (torch.bfloat16 if m >= 256 else torch.float32)


@pytest.mark.parametrize("value,error", [("uplanes", NotImplementedError), ("tx", ValueError)])
def test_unported_and_unknown_flavours_raise(value, error):
    _, tqt = _weight("Q4_K", 0)
    with flavour(value):
        with pytest.raises(error, match="C.5" if value == "uplanes" else "expected one of"):
            TQ.qmatmul(torch.zeros((1, K)), tqt)
        with pytest.raises(error):
            TQ.moe_fusable(tqt, tqt, K, 1024)
        # a dense product reads no flavour
        TQ.qmatmul(torch.zeros((1, K)), TQ.QTensor("dense", (4, K), 0, torch.zeros((K, 4))))


# ---------------------------------------------------------------------------
# The MoE gates: the fused FFN and the routed products
# ---------------------------------------------------------------------------

E, D, DFF = 4, 256, 1024


@functools.lru_cache(maxsize=None)
def _experts(quant, n, k):
    rng = np.random.default_rng(n + k + len(quant))
    qts = [_rand_qtensor(rng, n, k, quant) for _ in range(E)]
    st = lambda a: None if a[0] is None else jnp.stack(a)
    jqt = JR.QTensor(qts[0].kind, (n, k), qts[0].g, st([q.qs for q in qts]),
                     st([q.scales for q in qts]), st([q.bias for q in qts]))
    return jqt, to_torch(jqt)


@pytest.mark.parametrize("flav", ["txn", "int8"])
def test_moe_fusable_needs_txn(flav):
    (jgu, tgu), (jdn, tdn) = _experts("Q4_K", 2 * DFF, D), _experts("Q4_K", D, DFF)
    with flavour(flav):
        assert JQ.moe_fusable(jgu, jdn, D, DFF) == TQ.moe_fusable(tgu, tdn, D, DFF) \
            == (flav == "txn")


@pytest.mark.parametrize("quant,n,k", [("Q4_K", 2 * DFF, D), ("Q4_K", D, DFF),
                                       ("Q8_0", D, DFF)], ids=["q4b-gu", "q4b-down", "q8b"])
def test_routed_under_int8_matches_jax(quant, n, k):
    """Under int8, q4b experts take _routed_fallback (counted), q8b ones keep
    the routed q8b GEMV; 3 slots of 2 rows, against the JAX package's."""
    jqt, tqt = _experts(quant, n, k)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, k)).astype(np.float32)
    ei, ti = np.asarray([3, 0, 2], np.int32), np.asarray([0, 1, 1], np.int32)
    reset_launch_counts()
    t_ran = []
    mp = pytest.MonkeyPatch()
    _spy(mp, TQ, "qmm_q8_m1_r", "qmm_q8_m1_r", t_ran)
    try:
        with flavour("int8", traced=False):
            want = JQ.qmatmul_routed(jnp.asarray(x), jqt, jnp.asarray(ei), jnp.asarray(ti))
            got = TQ.qmatmul_routed(torch.from_numpy(x), tqt, torch.from_numpy(ei),
                                    torch.from_numpy(ti))
    finally:
        mp.undo()
    q4 = quant == "Q4_K"
    assert TQ.ROUTE_COUNTS["routed_fallback"] == int(q4)
    assert t_ran == ([] if q4 else ["qmm_q8_m1_r"])
    assert got.shape == (3, n) and rel(got, want) <= 1e-5
