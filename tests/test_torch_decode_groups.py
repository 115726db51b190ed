"""The port's decode attention at head groups G = Hq / Hkv outside 1, 2, 4, 8
against the JAX package's, on the CPU: G = 3 (6 query heads over 2 KV
heads), 7 (7 over 1) and 16 (16 over 1) at D = 128, and at head dim D = 256
(gemma's) G = 2 (4 over 2) and 8 (8 over 1).

The reference runs its decode kernels for any group where D % 128 == 0,
S % 256 == 0 and Hq <= 256, and the port's CUDA kernels take the same
groups at D = 128 and 256: up to 8 query heads (16 in flash_decode at D =
128) are one chunk of a kernel's work, a larger group several chunks. On the CPU the port's wrappers run their plain
versions, so these cases hold what the kernels are held to on the card
(tests/test_torch_cuda.py) against the reference's own kernels:
- flash_decode_write_stacked against _flash_decode_write_kernel in Pallas
  interpret mode (the pallas_kernels fixture of tests/test_torch_attention.py),
  within 2e-2 of the largest output (p is rounded to bf16 against a running
  max that moves with the block size), the written cache rows exactly
  equal, except the 7 rows beside pos where pos >= s_limit, which the
  reference overwrites by a fault of its own (ROADMAP C.6);
- flash_decode_stacked (bf16 flat cache) and flash_decode (int8 codes with
  f32 scales, the reference handed the dequantized K/V) against
  _flash_decode_qt_kernel / _flash_decode_kernel in interpret mode, row by
  row within 1e-5 of each row's largest output, as
  tests/test_torch_flash_decode.py holds them (S = 512, one tile: only
  the order of the f32 sums differs);
- paged_attention against paged_attend's f32 gather reference (the JAX CPU
  backend), bf16 and int8 pages, within 1e-5 of each (row, head)'s largest
  output, as tests/test_torch_paged.py holds it.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.runtime import kvcache as JK
from llamafile_tpu.runtime import paged as JP
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.testing import paged_case, rel_err, row_rel_err
from tests.test_torch_attention import pallas_kernels  # noqa: F401  (fixture)

L, B, S = 3, 2, 512
SCALE = 0.088
# (Hq, Hkv, D): G = 3, 7, 16 at D = 128; G = 2, 8 at D = 256
GROUPS = ([pytest.param(hq, hkv, 128, id=f"{hq}-{hkv}") for hq, hkv in ((6, 2), (7, 1), (16, 1))]
          + [pytest.param(hq, hkv, 256, id=f"{hq}-{hkv}-d256") for hq, hkv in ((4, 2), (8, 1))])


def _np(a):
    return np.array(a.astype(jnp.float32))


def _case(seed, hq, hkv, D):
    rng = np.random.default_rng(seed)
    bf = lambda a: _np(jnp.asarray(a, jnp.bfloat16))
    k3 = bf(rng.standard_normal((L, B, S, hkv * D)))
    v3 = bf(rng.standard_normal((L, B, S, hkv * D)))
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, hkv, D)).astype(np.float32)
    return k3, v3, q, kn, vn


@pytest.mark.parametrize("hq,hkv,d", GROUPS)
@pytest.mark.parametrize("pos,s_limit", [((37, 301), None), ((0, 300), 256)])
def test_flash_decode_write_groups_match_pallas(pallas_kernels, hq, hkv, d, pos, s_limit):
    k3, v3, q, kn, vn = _case(hq + sum(pos) + (d if d != 128 else 0), hq, hkv, d)
    want, jk3, jv3 = JA.flash_decode_write_stacked(
        jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(1), jnp.asarray(pos, jnp.int32),
        SCALE, hkv=hkv, s_limit=s_limit)
    tk3 = torch.from_numpy(k3).to(torch.bfloat16)
    tv3 = torch.from_numpy(v3).to(torch.bfloat16)
    got = TA.flash_decode_write_stacked(
        torch.from_numpy(q), tk3, tv3, torch.from_numpy(kn), torch.from_numpy(vn), 1,
        torch.from_numpy(np.asarray(pos, np.int32)), SCALE, hkv=hkv, s_limit=s_limit)
    assert rel_err(got, torch.from_numpy(_np(want))) <= 2e-2
    keep = np.ones((L, B, S), bool)               # ROADMAP C.6: rows beside pos
    for b, pb in enumerate(pos):
        if s_limit is not None and pb >= s_limit:
            keep[1, b, pb // 8 * 8:pb // 8 * 8 + 8] = False
            keep[1, b, pb] = True
    for mine, ref in ((tk3, jk3), (tv3, jv3)):
        np.testing.assert_array_equal(mine.float().numpy()[keep], _np(ref)[keep])


@pytest.mark.parametrize("hq,hkv,d", GROUPS)
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_decode_groups_match_pallas(pallas_kernels, hq, hkv, d, cache):
    k3, v3, q, _, _ = _case(2 * hq + hkv + (d if d != 128 else 0), hq, hkv, d)
    pos = np.asarray([5, 400], np.int32)
    if cache == "bf16":
        want = JA.flash_decode_stacked(jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16),
                                       jnp.asarray(v3, jnp.bfloat16), jnp.int32(1),
                                       jnp.asarray(pos), SCALE, hkv)
        got = TA.flash_decode_stacked(torch.from_numpy(q),
                                      torch.from_numpy(k3).to(torch.bfloat16),
                                      torch.from_numpy(v3).to(torch.bfloat16), 1,
                                      torch.from_numpy(pos), SCALE, hkv)
    else:
        kv = [jnp.asarray(a[1].reshape(B, S, hkv, d)) for a in (k3, v3)]
        (qk, sk), (qv, sv) = JK._quant_rows(kv[0]), JK._quant_rows(kv[1])
        # the reference hands its kernel f32 K/V, dequantized beforehand
        want = JA.flash_decode(jnp.asarray(q), qk.astype(jnp.float32) * sk[..., None],
                               qv.astype(jnp.float32) * sv[..., None], jnp.asarray(pos),
                               SCALE)
        t = lambda a: torch.from_numpy(np.asarray(a))
        got = TA.flash_decode(torch.from_numpy(q), t(qk), t(qv), torch.from_numpy(pos),
                              SCALE, k_scale=t(sk), v_scale=t(sv))
    assert row_rel_err(got, torch.from_numpy(_np(want))) <= 1e-5


@pytest.mark.parametrize("hq,hkv,d", GROUPS)
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_groups_match_reference(hq, hkv, d, int8):
    g = torch.Generator().manual_seed(hq * 10 + hkv + int8 + (d if d != 128 else 0))
    q, kp, vp, ks, vs, lens, tables = paged_case(g, [1, 15, 16, 17, 128], hq, hkv, d, 16,
                                                 8, n_layers=2, int8=int8)
    args = (q, kp[1], vp[1], lens, tables, None if ks is None else ks[1],
            None if vs is None else vs[1])
    got = TA.paged_attention(*args)
    jnp_of = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16) \
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
    want = torch.from_numpy(np.asarray(JP.paged_attend(
        jnp.asarray(q.numpy()), jnp_of(kp[1]), jnp_of(vp[1]), jnp.asarray(lens.numpy()),
        jnp.asarray(tables.numpy()),
        k_scale_l=None if ks is None else jnp.asarray(ks[1].numpy()),
        v_scale_l=None if vs is None else jnp.asarray(vs[1].numpy()))))
    assert got.shape == (5, hq, d)
    assert row_rel_err(got, want) <= 1e-5
