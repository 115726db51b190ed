"""The port's two-plane q4b GEMM (qmm_planes, the unrolled prefill's
product) against the JAX package's _qmm_kernel_planes in interpret mode.

Weights are repacked Q4_K (the JAX package's repack of random blocks) with
N = K = 512. Tolerances:
  * M = 64 (f32 out): within 1e-4 of the largest |y|. Both sides multiply
    the same bf16 activations by the same bf16-rounded weights, exactly in
    f32, and differ only in the order of the f32 sums.
  * M = 256 (bf16 out): every element within one bf16 step of the
    reference's (2**-7 of its magnitude's power of two): the f32 sums,
    reordered, may round to the neighbouring bf16 value. Through qmatmul
    the bias term is then added in bf16 on both sides, each sum rounded
    once more: held within one bf16 step of |product| + |bias term| plus
    one step of the result.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from llamafile_tpu.gguf import quants as JQQ
from llamafile_tpu.ops import qmatmul as JQ
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch.ops import qmatmul as TQ
from tests.test_torch_qmatmul import to_torch, tt

N = K = 512


def q4k_weight(seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    raw = JQQ.TYPE_BY_NAME["Q4_K"].quantize(w.reshape(-1))
    return JR.repack(np.frombuffer(raw, np.uint8), "Q4_K", (N, K))


def bf16_step(a):
    """One bf16 step (unit in the last place) at each element's magnitude."""
    a = np.abs(np.asarray(a, np.float32))
    return 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7)


def f32(a):
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("m", [64, 256])
def test_planes_plain_matches_pallas(m):
    qt = q4k_weight(m)
    x = np.random.default_rng(m + 1).standard_normal((m, K)).astype(np.float32)
    want = JQ._qmm_call_planes(jnp.asarray(x), qt.qs, qt.scales, interpret=True)
    tq = to_torch(qt)
    got = TQ.qmm_planes(torch.from_numpy(x), tq.qs, tq.scales)
    assert got.dtype == (torch.bfloat16 if m >= 256 else torch.float32)
    assert str(want.dtype) == ("bfloat16" if m >= 256 else "float32")
    w, g = f32(want), got.float().numpy()
    if m < 256:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    else:
        assert (np.abs(g - w) <= np.maximum(bf16_step(w), bf16_step(g))).all()
    # the plain version is the dequant GEMM's function, rounded as the planes
    ref = TQ.qmm_dequant_plain(torch.from_numpy(x), tq.qs, tq.scales)
    np.testing.assert_allclose(got.float().numpy(), ref.to(got.dtype).float().numpy(),
                               rtol=0, atol=1e-4 * np.abs(w).max() if m < 256 else
                               float(bf16_step(np.abs(w).max())))


@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("prenorm", [False, True])
def test_unstacked_qmatmul_matches_jax(m, prenorm):
    """qmatmul's unstacked q4b branch at M > 32 (the reference's
    _qmm_call_planes, bias added outside in the product's dtype)."""
    qt = q4k_weight(10 + m)
    rng = np.random.default_rng(m + prenorm)
    x = rng.standard_normal((m, K)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    want = JQ.qmatmul(jnp.asarray(x), qt,
                      prenorm=(jnp.asarray(nrm), 1e-5) if prenorm else None)
    got = TQ.qmatmul(torch.from_numpy(x), to_torch(qt),
                     prenorm=(torch.from_numpy(nrm), 1e-5) if prenorm else None)
    assert tuple(got.shape) == tuple(want.shape) == (m, N)
    w, g = f32(want), got.float().numpy()
    if m < 256:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    else:
        assert got.dtype == torch.bfloat16
        xs = x if not prenorm else TQ.apply_rmsnorm(
            torch.from_numpy(x), torch.from_numpy(nrm), 1e-5).numpy()
        bias = xs.reshape(m, K // 32, 32).sum(-1) @ tt(qt.bias).float().numpy()[:, :N]
        tol = bf16_step(np.abs(w) + np.abs(bias)) + np.maximum(bf16_step(w),
                                                               bf16_step(g))
        assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()


def test_dispatch_unstacked_planes_stacked_dequant(monkeypatch):
    """Unstacked q4b at M > 32 takes qmm_planes; stacked keeps qmm_dequant;
    unstacked at M <= 32 keeps the int8 kernels."""
    calls = []
    for name in ("qmm_txn", "qmm_dequant", "qmm_planes"):
        real = getattr(TQ, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(TQ, name, spy)
    un = to_torch(q4k_weight(3))
    st = TQ.QTensor(un.kind, un.shape, un.g, un.qs[None], un.scales[None],
                    un.bias[None])
    TQ.qmatmul(torch.randn(33, K), un)
    TQ.qmatmul(torch.randn(16, K), un)
    TQ.qmatmul(torch.randn(33, K), st, li=0)
    assert calls == ["qmm_planes", "qmm_txn", "qmm_dequant"]
