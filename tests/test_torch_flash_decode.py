"""The port's dense-cache decode attention (flash_decode, flash_decode_stacked)
and int8 KV cache against the JAX package's, on the CPU.

The JAX side runs _flash_decode_kernel / _flash_decode_qt_kernel in Pallas
interpret mode (the monkeypatch of tests/test_flash_write.py). S is 256 or
512, one streaming tile of the TPU kernel, so both sides round p against
the same maximum: outputs are held row by row (one query head's output)
within 1e-5 of the row's largest magnitude; only the order of the f32 sums
differs. The int8 cache's codes and scales must equal the jitted
reference's bit for bit (runtime/kvcache.py: _quant_rows multiplies by the
f32 reciprocal of 127, as XLA compiles the reference's divide).
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.runtime import kvcache as JK
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.runtime import kvcache as TK
from llamafile_tpu_torch.testing import row_rel_err

D = 128


@pytest.fixture
def pallas_kernels(monkeypatch):
    orig = JA.pl.pallas_call
    monkeypatch.setattr(JA.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _case(seed, b, s, hq, hkv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, D)).astype(np.float32)
    kv = rng.standard_normal((2, b, s, hkv, D)).astype(np.float32)
    pos = np.asarray([0, s // 3, s - 1][:b], np.int32)
    return q, kv, pos


def _np(a):
    return np.array(a.astype(jnp.float32))


@pytest.mark.parametrize("s", [256, 512])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_decode_plain_matches_pallas(pallas_kernels, s, hq, hkv, cache):
    q, kv, pos = _case(s + hq + hkv, 3, s, hq, hkv)
    scale = D ** -0.5
    if cache == "bf16":
        k, v = (jnp.asarray(a, jnp.bfloat16) for a in kv)
        want = JA.flash_decode(jnp.asarray(q), k, v, jnp.asarray(pos), scale)
        tk, tv = (torch.from_numpy(_np(a)).to(torch.bfloat16) for a in (k, v))
        got = TA.flash_decode(torch.from_numpy(q), tk, tv, torch.from_numpy(pos), scale)
    else:
        qk, sk = JK._quant_rows(jnp.asarray(kv[0]))
        qv, sv = JK._quant_rows(jnp.asarray(kv[1]))
        # the reference hands its kernel f32 K/V, dequantized beforehand
        want = JA.flash_decode(jnp.asarray(q), qk.astype(jnp.float32) * sk[..., None],
                               qv.astype(jnp.float32) * sv[..., None],
                               jnp.asarray(pos), scale)
        t = lambda a: torch.from_numpy(np.asarray(a))
        got = TA.flash_decode(torch.from_numpy(q), t(qk), t(qv), torch.from_numpy(pos),
                              scale, k_scale=t(sk), v_scale=t(sv))
    assert row_rel_err(got, torch.from_numpy(_np(want))) <= 1e-5


@pytest.mark.parametrize("s_limit", [None, 256])
def test_flash_decode_stacked_plain_matches_pallas(pallas_kernels, s_limit):
    b, s, hq, hkv, nl, li = 2, 512, 4, 2, 3, 1
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, hq, D)).astype(np.float32)
    k3, v3 = (jnp.asarray(rng.standard_normal((nl, b, s, hkv * D)), jnp.bfloat16)
              for _ in range(2))
    pos = np.asarray([5, 200], np.int32)
    want = JA.flash_decode_stacked(jnp.asarray(q), k3, v3, jnp.int32(li),
                                   jnp.asarray(pos), 0.088, hkv, s_limit=s_limit)
    tk3, tv3 = (torch.from_numpy(_np(a)).to(torch.bfloat16) for a in (k3, v3))
    got = TA.flash_decode_stacked(torch.from_numpy(q), tk3, tv3, li,
                                  torch.from_numpy(pos), 0.088, hkv, s_limit=s_limit)
    assert row_rel_err(got, torch.from_numpy(_np(want))) <= 1e-5


def test_flash_decode_routes_odd_lengths_to_the_einsum():
    """S % 256 != 0 takes the reference's f32 einsum, on the dequantized
    values for int8, and agrees with the plain version's f32 numerics."""
    q, kv, pos = _case(3, 2, 200, 4, 2)
    qk, sk = TK._quant_rows(torch.from_numpy(kv[0]))
    qv, sv = TK._quant_rows(torch.from_numpy(kv[1]))
    args = (torch.from_numpy(q), qk, qv, torch.from_numpy(pos), 0.1)
    got = TA.flash_decode(*args, k_scale=sk, v_scale=sv)
    want = TA.flash_decode_plain(*args, k_scale=sk, v_scale=sv)
    assert row_rel_err(got, want) <= 1e-5


def test_quant_rows_bit_exact():
    x = np.random.default_rng(1).standard_normal((3, 40, 2, D)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                     # an all-zero row
    jq, js = jax.jit(JK._quant_rows)(jnp.asarray(x))
    tq, ts = TK._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_int8_update_and_read_layer_match_jitted_reference():
    """Two writes into layer 1 of an int8 cache (40 rows at pos 0, whose
    last 8 fall past S = 32 and are dropped, then one row at pos 30): codes
    and scales bit for bit, and read_layer's f32 dequantization equal."""
    nl, b, s, hkv = 2, 1, 32, 2
    rng = np.random.default_rng(4)
    jc = JK.init_kv(nl, b, s, hkv, D, dtype="int8")
    tc = TK.init_kv(nl, b, s, hkv, D, dtype="int8", device="cpu")
    upd = jax.jit(JK.update_layer, static_argnums=1)
    for p0, t in ((0, 40), (30, 1)):
        new = rng.standard_normal((2, b, t, hkv, D)).astype(np.float32)
        idx = p0 + np.arange(t)[None, :]
        jc = upd(jc, 1, jnp.zeros((b, t), jnp.int32), jnp.asarray(idx, jnp.int32),
                 jnp.asarray(new[0]), jnp.asarray(new[1]))
        TK.update_layer(tc, 1, torch.tensor([p0], dtype=torch.int32),
                        torch.arange(t), torch.from_numpy(new[0]),
                        torch.from_numpy(new[1]))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for a, w in zip(TK.read_layer(tc, 1, hkv), jax.jit(JK.read_layer, static_argnums=1)(jc, 1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
