"""Decode attention routes by shape, as the reference routes it, on every
device (ops.attention.decode_route): a dense cache takes the f32 einsum for
S % 256, D % 128 or Hq > 256 (llamafile_tpu/ops/attention.py:334-342), a
paged pool the gather for D % 128 or a v width other than D
(llamafile_tpu/runtime/paged.py:262-300); the kernel otherwise.

The route of each shape is asserted; then the non-kernel routes of the
port's wrappers run against the JAX package's own on the CPU, where the
reference takes them by shape too: a head_dim-64 decode with the fused row
write, and a head_dim-64 paged decode. Tolerance 1e-5 of the largest output:
both are f32 einsums summed in another order. The written rows are exactly
equal.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.runtime import paged as JP
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.ops import reset_launch_counts
from llamafile_tpu_torch.testing import paged_case


@pytest.mark.parametrize("d,s_eff,hq,route", [
    (128, 256, 32, "kernel"), (128, 300, 32, "einsum"), (128, 256, 320, "einsum"),
    (64, 256, 32, "einsum"), (64, 300, 32, "einsum"), (64, 256, 320, "einsum"),
    (256, 256, 32, "kernel"), (256, 300, 32, "einsum"), (256, 256, 320, "einsum"),
    (128, 2048, 256, "kernel")])
def test_dense_decode_route(d, s_eff, hq, route):
    assert TA.decode_route(d, hq=hq, s_eff=s_eff) == route


@pytest.mark.parametrize("d,dv,route", [(128, 128, "kernel"), (64, 64, "gather"),
                                        (256, 256, "kernel"), (128, 64, "gather"),
                                        (192, 128, "gather")])
def test_paged_decode_route(d, dv, route):
    assert TA.decode_route(d, dv=dv, paged=True) == route


@pytest.mark.parametrize("d,s_limit", [(64, None), (128, 300)], ids=["d64", "s_eff300"])
def test_decode_write_einsum_route_matches_jax(d, s_limit):
    """flash_decode_write_stacked on an einsum-route shape: the rows written
    in place, then the f32 einsum, as the JAX package's fallback branch."""
    rng = np.random.default_rng(d)
    nl, b, s, hkv, hq = 2, 2, 512, 2, 8
    k3 = np.array(jnp.asarray(rng.standard_normal((nl, b, s, hkv * d)),
                              jnp.bfloat16).astype(jnp.float32))
    v3 = np.array(jnp.asarray(rng.standard_normal((nl, b, s, hkv * d)),
                              jnp.bfloat16).astype(jnp.float32))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray([5, 260], np.int32)
    want, jk, jv = JA.flash_decode_write_stacked(
        jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), 1, jnp.asarray(pos), d ** -0.5, hkv,
        s_limit=s_limit)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k3, v3))
    reset_launch_counts()
    got = TA.flash_decode_write_stacked(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), 1,
        torch.from_numpy(pos), d ** -0.5, hkv, s_limit=s_limit)
    assert TA.ROUTE_COUNTS["einsum"] == 1
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))


def test_paged_gather_route_matches_jax():
    """paged_attention at head_dim 64: the gather route, as paged_attend's."""
    q, kp, vp, _, _, lens, tables = paged_case(torch.Generator().manual_seed(3),
                                               [1, 63, 65], 8, 2, 64, 16, 8)
    reset_launch_counts()
    got = TA.paged_attention(q, kp[0], vp[0], lens, tables)
    assert TA.ROUTE_COUNTS["gather"] == 1
    f32 = lambda t: jnp.asarray(t.float().numpy())
    want = np.asarray(JP.paged_attend(f32(q), f32(kp[0]).astype(jnp.bfloat16),
                                      f32(vp[0]).astype(jnp.bfloat16),
                                      jnp.asarray(lens.numpy()), jnp.asarray(tables.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
