"""The cluster split of the port's paged_attention kernel, on the CPU.

The kernel (llamafile_tpu_torch/csrc/paged_attention.cu) runs only on the
card; its schedule is emulated in PyTorch by testing.pa_split_emulate: the
rank ranges of testing.pa_rank_ranges over each row's visible keys, each
key found through the row's page table, 32-key slabs a warp with one max
and one rescale of acc a slab, the warps' partials merged in warp order and
the ranks' in rank order, all in f32. Held here:
- the ranks' slabs read every visible key of a row exactly once, at its
  (page, offset) through the table, and nothing else; each rank's keys lie
  in the table entries it stages (testing.pa_rank_pages);
- the emulation against paged_gather (the kernel's plain version) within
  1e-5 of each (row, head)'s largest output, the card test's tolerance,
  over rows of unequal lengths (1 key to the whole table), bf16 and int8
  pages, head groups up to 16 and beyond, D = 128 and 256;
- a control: the emulation with one rank's partial dropped reads above that
  tolerance.
"""
import pytest
import torch

from llamafile_tpu_torch.ops.attention import paged_gather
from llamafile_tpu_torch.testing import (PA_CLUSTER, pa_rank_pages, pa_rank_ranges,
                                         pa_slabs, pa_split_emulate, paged_case,
                                         row_rel_err)

TOL = 1e-5
PS, MAXP = 64, 32
LENGTHS = [1, 63, 64, 65, 700, 1024, 1500, 2048]


@pytest.mark.parametrize("ps,maxp", [(64, 32), (16, 8), (48, 5)])
@pytest.mark.parametrize("length", [1, 7, 31, 32, 33, 63, 64, 65, 255, 700, 2047, 2048, 5000])
def test_slabs_read_every_visible_key_once(length, ps, maxp):
    gen = torch.Generator().manual_seed(length + ps)
    table = (torch.randperm(4 * maxp, generator=gen)[:maxp] + 1).tolist()
    n = min(length, maxp * ps)
    read = []
    ranges = pa_rank_ranges(length, ps, maxp)
    assert len(ranges) == PA_CLUSTER
    for lo, hi in ranges:
        p0, np_ = pa_rank_pages(lo, hi, ps)
        for slabs in pa_slabs(lo, hi):
            for j0, j1 in slabs:
                assert j1 - j0 <= 32
                for j in range(j0, j1):
                    assert p0 <= j // ps < p0 + np_       # a staged table entry
                    read.append((table[j // ps], j % ps))
    assert sorted(read) == sorted((table[j // ps], j % ps) for j in range(n))
    assert len(set(read)) == n


def _case(lengths, hq, hkv, d, int8, seed):
    gen = torch.Generator().manual_seed(seed)
    q, kp, vp, ks, vs, lens, tables = paged_case(gen, lengths, hq, hkv, d, PS, MAXP,
                                                 int8=int8)
    sc = (lambda t: None) if ks is None else (lambda t: t[0])
    return q, kp[0], vp[0], lens, tables, sc(ks), sc(vs)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (12, 4, 128), (32, 8, 128), (64, 4, 128),
                                      (32, 1, 128), (16, 8, 256), (16, 1, 256)])
def test_split_matches_gather(int8, hq, hkv, d):
    """Rows of very unequal lengths in one call, tables shuffled over the
    pool's pages (testing.paged_case)."""
    args = _case(LENGTHS[::3] if d == 256 else LENGTHS, hq, hkv, d, int8, hq + hkv + d)
    got = pa_split_emulate(*args)
    want = paged_gather(*args)
    assert row_rel_err(got, want) <= TOL


@pytest.mark.parametrize("drop", [0, PA_CLUSTER // 2, PA_CLUSTER - 1])
def test_dropped_rank_fails_tolerance(drop):
    """The control: a merge that loses one rank's partial is rejected by the
    tolerance the kernel is held to."""
    args = _case([64, 700, 1024], 16, 4, 128, False, drop)
    bad = pa_split_emulate(*args, drop_rank=drop)
    assert row_rel_err(bad, paged_gather(*args)) > TOL
