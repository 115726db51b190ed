"""The port's repack (llamafile_tpu_torch.ops.repack) against the JAX
package's: the device layout must be byte-identical (codes, bf16 scales and
bias, N padding included), and so must the fused projections built from it."""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU before jax is imported)
import jax.numpy as jnp

from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch.gguf import quants as TQ
from llamafile_tpu_torch.ops import repack as TR


def q4k_blocks(rng, n, k):
    spec = JQ.TYPE_BY_NAME["Q4_K"]
    raw = rng.integers(0, 256, size=(n * k // 256, spec.block_bytes), dtype=np.uint8)
    raw[:, 1] &= 0x3B          # keep the f16 d / dmin exponents moderate
    raw[:, 3] &= 0x3B
    return raw


def bits(x) -> np.ndarray:
    """Raw bytes of a torch or JAX array (bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy().view(np.uint8)
    a = np.asarray(x)
    return a.view(np.uint8)


def jax_qt(rng, n, k):
    raw = q4k_blocks(rng, n, k)
    return raw, JR.repack(raw, "Q4_K", (n, k))


def torch_qt(raw, n, k):
    return TR.repack(raw, "Q4_K", (n, k), device="cpu")


@pytest.mark.parametrize("n,k", [(300, 512), (2048, 256), (64, 1024)])
def test_repack_numpy_identical(n, k):
    raw = q4k_blocks(np.random.default_rng(n + k), n, k)
    want = JR.repack_numpy(raw, "Q4_K", (n, k))
    got = TR.repack_numpy(raw, "Q4_K", (n, k))
    assert got[0] == want[0] == "q4b" and got[4] == want[4] == 32
    for a, b in zip(got[1:4], want[1:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("n,k", [(300, 512), (4096, 256)])
def test_repack_device_layout_identical(n, k):
    raw, jqt = jax_qt(np.random.default_rng(7), n, k)
    tqt = torch_qt(raw, n, k)
    assert (tqt.kind, tqt.shape, tqt.g) == (jqt.kind, jqt.shape, jqt.g)
    assert tqt.qs.shape[-1] % 2048 == 0            # storage N padded
    for t, j in ((tqt.qs, jqt.qs), (tqt.scales, jqt.scales), (tqt.bias, jqt.bias)):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(bits(t), bits(j))


@pytest.mark.parametrize("type_name", ["F32", "F16"])
def test_repack_dense_identical(type_name):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 64)).astype(np.float32)
    raw = w.tobytes() if type_name == "F32" else w.astype(np.float16).tobytes()
    raw = np.frombuffer(raw, np.uint8)
    jqt = JR.repack(raw, type_name, (96, 64))
    tqt = TR.repack(raw, type_name, (96, 64), device="cpu")
    assert tqt.kind == jqt.kind == "dense"
    np.testing.assert_array_equal(bits(tqt.qs), bits(jqt.qs))


def test_concat_and_interleave_identical():
    rng = np.random.default_rng(11)
    parts = [(256, 512), (128, 512), (128, 512)]
    j_in, t_in = [], []
    for n, k in parts:
        raw, jqt = jax_qt(rng, n, k)
        j_in.append(jqt)
        t_in.append(torch_qt(raw, n, k))
    jc, tc = JR.concat_qtensors(j_in), TR.concat_qtensors(t_in)
    assert tc.shape == jc.shape
    for t, j in ((tc.qs, jc.qs), (tc.scales, jc.scales), (tc.bias, jc.bias)):
        np.testing.assert_array_equal(bits(t), bits(j))
    raw_g, jg = jax_qt(rng, 2048, 256)
    raw_u, ju = jax_qt(rng, 2048, 256)
    jil = JR.interleave_gateup(jg, ju)
    til = TR.interleave_gateup(torch_qt(raw_g, 2048, 256), torch_qt(raw_u, 2048, 256))
    assert til.il and til.shape == jil.shape
    for t, j in ((til.qs, jil.qs), (til.scales, jil.scales), (til.bias, jil.bias)):
        np.testing.assert_array_equal(bits(t), bits(j))


def test_dequant_matches_reference():
    n, k = 300, 512
    raw, jqt = jax_qt(np.random.default_rng(5), n, k)
    kind, qs, a, b, g = JR.repack_numpy(raw, "Q4_K", (n, k))
    want = JR.dequant_qtensor_numpy(kind, qs, a, b, g, (n, k))
    # the device copy holds bf16 scales/bias: compare with the reference's
    # dequant of those same bf16 values
    want_bf = JR.dequant_qtensor_numpy(
        kind, np.asarray(jqt.qs)[:, :n], np.asarray(jqt.scales.astype(jnp.float32))[:, :n],
        np.asarray(jqt.bias.astype(jnp.float32))[:, :n], g, (n, k))
    got = TR.dequant_qtensor(torch_qt(raw, n, k)).numpy()
    np.testing.assert_array_equal(got, want_bf)
    # bf16 group metadata keeps the weights within bf16 rounding of the f32 ones
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())


def int8_blocks(rng, type_name, n, k):
    """Random Q8_0 / Q6_K blocks with a moderate f16 d (its high byte's
    exponent bits kept small, as q4k_blocks does)."""
    spec = JQ.TYPE_BY_NAME[type_name]
    raw = rng.integers(0, 256, size=(n * k // spec.block_elems, spec.block_bytes),
                       dtype=np.uint8)
    d_hi = 1 if type_name == "Q8_0" else 209          # high byte of the f16 d
    raw[:, d_hi] &= 0x3B
    return raw


@pytest.mark.parametrize("type_name,g", [("Q8_0", 32), ("Q6_K", 16)])
@pytest.mark.parametrize("n,k", [(300, 512), (64, 1024)])
def test_int8_repack_numpy_identical(type_name, g, n, k):
    raw = int8_blocks(np.random.default_rng(n + k), type_name, n, k)
    want = JR.repack_numpy(raw, type_name, (n, k))
    got = TR.repack_numpy(raw, type_name, (n, k))
    assert got[0] == want[0] == "q8b" and got[4] == want[4] == g
    assert got[3] is None and want[3] is None                 # no bias
    for a, b in zip(got[1:3], want[1:3]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("type_name", ["Q8_0", "Q6_K"])
def test_int8_device_layout_and_dequant(type_name):
    """Padded device layout byte-identical to the reference's, q8b concat
    identical, and the dequantized weights equal to the GGUF dequantizer's
    within bf16 rounding of the scales (the host dequantizers agree
    exactly)."""
    n, k = 300, 512
    rng = np.random.default_rng(17)
    raw = int8_blocks(rng, type_name, n, k)
    jqt = JR.repack(raw, type_name, (n, k))
    tqt = TR.repack(raw, type_name, (n, k), device="cpu")
    assert (tqt.kind, tqt.shape, tqt.g, tqt.bias) == (jqt.kind, jqt.shape, jqt.g, None)
    assert tqt.qs.dtype == torch.int8 and tqt.qs.shape[-1] % 2048 == 0
    for t, j in ((tqt.qs, jqt.qs), (tqt.scales, jqt.scales)):
        np.testing.assert_array_equal(bits(t), bits(j))
    spec = TQ.TYPE_BY_NAME[type_name]
    ref = TQ.dequantize(raw, spec.type_id, (n, k))
    np.testing.assert_array_equal(ref, JQ.dequantize(raw, spec.type_id, (n, k)))
    got = TR.dequant_qtensor(tqt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    raw2 = int8_blocks(rng, type_name, 128, k)
    jc = JR.concat_qtensors([jqt, JR.repack(raw2, type_name, (128, k))])
    tc = TR.concat_qtensors([tqt, TR.repack(raw2, type_name, (128, k), device="cpu")])
    assert tc.shape == jc.shape and tc.bias is None
    for t, j in ((tc.qs, jc.qs), (tc.scales, jc.scales)):
        np.testing.assert_array_equal(bits(t), bits(j))


@pytest.mark.parametrize("type_name", ["Q8_1"])
def test_unported_format_raises(type_name):
    spec = TQ.TYPE_BY_NAME[type_name]
    raw = np.zeros(4 * 256 // spec.block_elems * spec.block_bytes, np.uint8)
    with pytest.raises(NotImplementedError, match=type_name):
        TR.repack(raw, type_name, (4, 256))
