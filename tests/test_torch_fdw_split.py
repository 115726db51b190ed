"""The cluster split of the port's flash_decode_write kernel, on the CPU.

The kernel (llamafile_tpu_torch/csrc/flash_decode_write.cu) runs only on
the card; its schedule is emulated in PyTorch by testing.fdw_split_emulate:
the rank ranges of testing.fdw_rank_ranges, 16-row slabs a warp with one max
and one rescale of acc a slab (bf16 p for P.V, the f32 p into l), the warps'
partials merged in warp order and the ranks' in rank order with the new
token last. Held here:
- the ranges cover every visible row once and in order, for cluster sizes
  8 and 16;
- the emulation against flash_decode_write_plain within 2e-2 of the largest
  output, the card test's tolerance for the kernel against its plain
  version (p rounded to bf16 against another running max), and against the
  JAX package's Pallas kernel in interpret mode (the pallas_kernels fixture
  of tests/test_torch_attention.py) within the same, with the written cache
  rows exactly equal (where pos >= s_limit the reference also overwrites
  the 7 rows beside pos with a capture that never ran, a fault of its own,
  ROADMAP C.6: those rows are left out of that comparison, and the plain
  version holds them);
- a control: the emulation with one rank's partial dropped reads above that
  tolerance (0.07-0.7 of the largest output on these inputs);
- the same with the window and softcap options (gemma2): the visible rows
  start at pos - window + 1, and the ranks split those.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.testing import fdw_rank_ranges, fdw_split_emulate, rel_err
from tests.test_torch_attention import pallas_kernels  # noqa: F401  (fixture)

L, B, S, Hkv, D, Hq = 3, 2, 2048, 2, 128, 8
TOL = 2e-2
SCALE = 0.088

# (pos per batch row, s_limit): a row at pos 0 beside a short one; visible
# rows a multiple of both cluster sizes (every rank boundary on a row count
# that divides evenly, and 16-row slabs that end on it); both rows at or past
# s_limit, at different pos; 2000 visible rows, four slabs a warp at cluster
# size 8
CASES = [((0, 37), None), ((256, 1024), None), ((1500, 2000), 1024), ((2000, 1999), None)]


def _case(seed):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    k3 = bf(rng.standard_normal((L, B, S, Hkv * D)))
    v3 = bf(rng.standard_normal((L, B, S, Hkv * D)))
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    return k3, v3, q, kn, vn


def _torch(k3, v3, q, kn, vn, pos):
    t = torch.from_numpy
    return (t(q), t(k3).to(torch.bfloat16), t(v3).to(torch.bfloat16), t(kn), t(vn),
            t(np.asarray(pos, np.int32)))


N_VIS = {"0": lambda cs: 0, "1": lambda cs: 1, "cs-1": lambda cs: cs - 1,
         "cs": lambda cs: cs, "cs+1": lambda cs: cs + 1, "700": lambda cs: 700,
         "2047": lambda cs: 2047}


@pytest.mark.parametrize("cs", [8, 16])
@pytest.mark.parametrize("n_vis", list(N_VIS))
def test_rank_ranges_cover_rows_once_in_order(n_vis, cs):
    n = N_VIS[n_vis](cs)
    ranges = fdw_rank_ranges(n, cs)
    assert len(ranges) == cs
    assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(n))
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("cs", [8, 16])
@pytest.mark.parametrize("pos,s_limit", CASES)
def test_split_matches_plain(pos, s_limit, cs):
    k3, v3, q, kn, vn = _case(sum(pos))
    s_eff = s_limit or S
    q_, k3a, v3a, kn_, vn_, p = _torch(k3, v3, q, kn, vn, pos)
    k3b, v3b = k3a.clone(), v3a.clone()
    got = fdw_split_emulate(q_, k3a, v3a, kn_, vn_, 1, p, SCALE, Hkv, s_eff, cs)
    want = TA.flash_decode_write_plain(q_, k3b, v3b, kn_, vn_, 1, p, SCALE, Hkv, s_eff)
    assert rel_err(got, want) <= TOL
    assert torch.equal(k3a, k3b) and torch.equal(v3a, v3b)


@pytest.mark.parametrize("pos,s_limit", CASES)
def test_split_matches_pallas(pallas_kernels, pos, s_limit):
    k3, v3, q, kn, vn = _case(sum(pos))
    want, jk3, jv3 = JA.flash_decode_write_stacked(
        jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(1), jnp.asarray(pos, jnp.int32),
        SCALE, hkv=Hkv, s_limit=s_limit)
    want = torch.from_numpy(np.asarray(want))
    # rows the reference overwrites by fault when pos >= s_limit (ROADMAP
    # C.6): the 7 others of the 8-row block holding pos, from a capture
    # that never ran
    keep = np.ones((L, B, S), bool)
    for b, pb in enumerate(pos):
        if s_limit is not None and pb >= s_limit:
            keep[1, b, pb // 8 * 8:pb // 8 * 8 + 8] = False
            keep[1, b, pb] = True
    for cs in (8, 16):
        q_, k3a, v3a, kn_, vn_, p = _torch(k3, v3, q, kn, vn, pos)
        got = fdw_split_emulate(q_, k3a, v3a, kn_, vn_, 1, p, SCALE, Hkv, s_limit or S, cs)
        assert rel_err(got, want) <= TOL, cs
        for mine, ref in ((k3a, jk3), (v3a, jv3)):
            np.testing.assert_array_equal(mine.float().numpy()[keep],
                                          np.asarray(ref.astype(jnp.float32))[keep])


# (pos per batch row, s_limit, window, softcap): the window inside and past
# the visible rows, with and without the softcap; the softcap alone
OPT_CASES = [((37, 1500), None, 700, 50.0), ((900, 1000), 1024, 256, 0.0),
             ((256, 1999), None, 4096, 30.0), ((0, 700), None, None, 50.0)]


@pytest.mark.parametrize("pos,s_limit,win,cap", OPT_CASES)
def test_split_window_softcap(pallas_kernels, pos, s_limit, win, cap):
    """The emulated schedule over the window's rows only (vis_lo = pos - win
    + 1), every score softcapped, against the plain version and the Pallas
    kernel in interpret mode with both options; a dropped rank still fails."""
    k3, v3, q, kn, vn = _case(sum(pos) + 7)
    q = q * 8.0                         # scores of tens: the softcap bends them
    s_eff = s_limit or S
    want_j, _, _ = JA.flash_decode_write_stacked(
        jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(1), jnp.asarray(pos, jnp.int32),
        SCALE, hkv=Hkv, s_limit=s_limit, win_l=win, softcap=cap)
    q_, k3a, v3a, kn_, vn_, p = _torch(k3, v3, q, kn, vn, pos)
    want = TA.flash_decode_write_plain(q_, k3a.clone(), v3a.clone(), kn_, vn_, 1, p, SCALE,
                                       Hkv, s_eff, win, cap)
    assert rel_err(want, torch.from_numpy(np.asarray(want_j))) <= TOL
    for cs in (8, 16):
        got = fdw_split_emulate(q_, k3a.clone(), v3a.clone(), kn_, vn_, 1, p, SCALE, Hkv,
                                s_eff, cs, win_l=win, softcap=cap)
        assert rel_err(got, want) <= TOL, cs
    bad = fdw_split_emulate(q_, k3a, v3a, kn_, vn_, 1, p, SCALE, Hkv, s_eff, 8,
                            drop_rank=4, win_l=win, softcap=cap)
    assert rel_err(bad, want) > TOL


@pytest.mark.parametrize("cs", [8, 16])
@pytest.mark.parametrize("pos,s_limit", CASES)
def test_dropped_rank_fails_tolerance(pos, s_limit, cs):
    """The control: a merge that loses one rank's partial (here the middle
    rank's) is rejected by the tolerance the kernel is held to."""
    k3, v3, q, kn, vn = _case(sum(pos))
    s_eff = s_limit or S
    q_, k3a, v3a, kn_, vn_, p = _torch(k3, v3, q, kn, vn, pos)
    want = TA.flash_decode_write_plain(q_, k3a.clone(), v3a.clone(), kn_, vn_, 1, p,
                                       SCALE, Hkv, s_eff)
    bad = fdw_split_emulate(q_, k3a, v3a, kn_, vn_, 1, p, SCALE, Hkv, s_eff, cs,
                            drop_rank=cs // 2)
    assert rel_err(bad, want) > TOL
