"""The port's attention (llamafile_tpu_torch.ops.attention) against the JAX
package's: the fused decode-with-write against _flash_decode_write_kernel in
Pallas interpret mode (the monkeypatch of tests/test_flash_write.py), the
flash prefill's plain version against the upstream Pallas flash_attention in
interpret mode (the same monkeypatch), the einsum prefill against the JAX
einsum path.

Tolerances: decode outputs 2e-2 (p is rounded to bf16 relative to a running
max, which moves with the block size); the written cache rows exactly equal;
einsum prefill 1e-5 (f32 einsums summed in another order). The flash
prefill is held row by row (testing.row_rel_err: each query's output for
one head, in units of that row's largest value) within FLASH_ROW_TOL, two
bf16 steps: both sides round their outputs to bf16, so one output may sit
one bf16 step away, up to 2**-7 of its value. A kernel that drops a query's
diagonal key tile is rejected by far (the control below, held above 50x the
limit). The rounding of p to bf16 moves an output less than the output's
own bf16 rounding, so this bound does not pin that rounding, and claims not
to.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.testing import flash_prefill_tile_fault, row_rel_err

L, B, S, Hkv, D, Hq = 3, 2, 512, 2, 128, 8
FLASH_ROW_TOL = 1.5e-2


@pytest.fixture
def pallas_kernels(monkeypatch):
    """Drive the JAX package's Pallas TPU kernels in interpret mode."""
    orig = JA.pl.pallas_call
    monkeypatch.setattr(JA.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _case(seed):
    rng = np.random.default_rng(seed)
    k3 = np.array(jnp.asarray(rng.standard_normal((L, B, S, Hkv * D)),
                              jnp.bfloat16).astype(jnp.float32))
    v3 = np.array(jnp.asarray(rng.standard_normal((L, B, S, Hkv * D)),
                              jnp.bfloat16).astype(jnp.float32))
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    return k3, v3, q, kn, vn


@pytest.mark.parametrize("pos,s_limit", [((37, 301), None), ((0, 255), 256)])
def test_flash_decode_write_plain_matches_pallas(pallas_kernels, pos, s_limit):
    k3, v3, q, kn, vn = _case(sum(pos))
    pos = np.asarray(pos, np.int32)
    want, jk3, jv3 = JA.flash_decode_write_stacked(
        jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(1), jnp.asarray(pos), 0.088,
        hkv=Hkv, s_limit=s_limit)
    tk3 = torch.from_numpy(k3).to(torch.bfloat16)
    tv3 = torch.from_numpy(v3).to(torch.bfloat16)
    got = TA.flash_decode_write_stacked(
        torch.from_numpy(q), tk3, tv3, torch.from_numpy(kn), torch.from_numpy(vn),
        1, torch.from_numpy(pos), 0.088, hkv=Hkv, s_limit=s_limit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    # the cache tensors were written in place, row for row as the kernel did
    np.testing.assert_array_equal(tk3.float().numpy(), np.asarray(jk3.astype(jnp.float32)))
    np.testing.assert_array_equal(tv3.float().numpy(), np.asarray(jv3.astype(jnp.float32)))


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (64, 0.0), (None, 30.0)])
def test_flash_decode_write_plain_options(window, softcap):
    """Window and softcap exist on the plain version (the CUDA kernel raises
    on them for now); held against the JAX package's einsum attention."""
    k3, v3, q, kn, vn = _case(3)
    pos = np.asarray([100, 400], np.int32)
    bidx = np.arange(B)
    k3u, v3u = k3.copy(), v3.copy()
    k3u[1, bidx, pos] = np.asarray(jnp.asarray(kn.reshape(B, -1), jnp.bfloat16).astype(jnp.float32))
    v3u[1, bidx, pos] = np.asarray(jnp.asarray(vn.reshape(B, -1), jnp.bfloat16).astype(jnp.float32))
    want = JA.flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k3u, jnp.bfloat16), jnp.asarray(v3u, jnp.bfloat16),
        jnp.int32(1), jnp.asarray(pos), 0.088, hkv=Hkv,
        win_l=None if window is None else jnp.int32(window), softcap=softcap)
    got = TA.flash_decode_write_stacked(
        torch.from_numpy(q), torch.from_numpy(k3).to(torch.bfloat16),
        torch.from_numpy(v3).to(torch.bfloat16), torch.from_numpy(kn),
        torch.from_numpy(vn), 1, torch.from_numpy(pos), 0.088, hkv=Hkv,
        win_l=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("t", [16, 32])
def test_flash_prefill_matches_einsum(t):
    rng = np.random.default_rng(t)
    q = rng.standard_normal((1, t, Hq, 64)).astype(np.float32)
    k = rng.standard_normal((1, t, Hkv, 64)).astype(np.float32)
    v = rng.standard_normal((1, t, Hkv, 64)).astype(np.float32)
    want = JA.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125)
    got = TA.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _prefill_case(t, d, hq=4, hkv=2, seed=0):
    rng = np.random.default_rng(seed + t + d)
    return [rng.standard_normal((1, t, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_prefill_plain_matches_pallas(pallas_kernels, t, d):
    q, k, v = _prefill_case(t, d)
    want = np.asarray(JA.flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), d ** -0.5))
    n0 = TA.flash_prefill.launches
    got = TA.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), d ** -0.5).numpy()
    assert TA.flash_prefill.launches == n0          # the CPU runs the plain version
    want_t = torch.from_numpy(want)
    assert row_rel_err(torch.from_numpy(got), want_t) <= FLASH_ROW_TOL
    fault = flash_prefill_tile_fault(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), d ** -0.5)
    assert row_rel_err(fault, want_t) > 50 * FLASH_ROW_TOL      # the control fails
    plain = TA.flash_prefill_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), d ** -0.5).numpy()
    np.testing.assert_array_equal(got, plain)
    # every output is a bf16 value, as the upstream kernel's bf16 output
    np.testing.assert_array_equal(got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())


def test_flash_prefill_long_prompt_raises():
    """A long prompt no longer raises: T >= 128 with a window or a softcap,
    or with T not a multiple of 128, keeps the reference's f32 einsum."""
    q, k, v = (torch.from_numpy(a) for a in _prefill_case(160, 64))
    for kw in (dict(window=48), dict(softcap=20.0), {}):
        want = JA.flash_prefill(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), 0.125, **kw)
        got = TA.flash_prefill(q, k, v, 0.125, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    q128 = q[:, :128]
    w = TA.flash_prefill(q128, k[:, :128], v[:, :128], 0.125, window=48)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(JA.flash_prefill(
            jnp.asarray(q128.numpy()), jnp.asarray(k[:, :128].numpy()),
            jnp.asarray(v[:, :128].numpy()), 0.125, window=48)), rtol=1e-5, atol=1e-5)
