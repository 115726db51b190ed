"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere. They import neither jax
nor the JAX package, so they run on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of the CPU parity tests: int8-activation products
(q4b and q8b) within 1e-5 of their largest magnitude (exact int32 group
dots, f32 sums in another order), the fused FFN within 2e-3 (one requantized
code may move by one step), decode attention within 2e-2 (bf16 p rounded
against another running max) with the written cache rows exactly equal. The dequant
GEMM is held within 1e-3 of its largest magnitude: its bf16 products are
exact, but the tensor cores sum up to 14336 of them in f32 in their own
order against cuBLAS's f32 product. The flash prefill is held row by row
(testing.row_rel_err) within 1.5e-2, two bf16 steps of an output: the
kernel rounds p against its running max, the plain version against the
row's maximum, and both round the output to bf16; a kernel that skipped the
diagonal key tile reads above 0.75 and is rejected. The two-plane GEMM
(qmm_planes) is held as the dequant GEMM, within 1e-3 of its largest
magnitude; its bf16 output (M >= 256) within one bf16 step of that
magnitude (2**-7 of it at most), as the sums in another order may round an
element to the neighbouring bf16 value. A faulty control that swaps the lo and hi scale rows must fail
that. The dense-cache decode attention (flash_decode) is held row by row:
within 2e-2 of a row's max over a bf16 cache (p rounded to bf16 against
another running max) and 1e-5 over an int8 cache (all f32); a control with
one masked key made visible must fail the int8 bound. Paged attention is
f32 on both sides over the same page values: it is held row by row within
1e-5 of each (row, head)'s largest output, and its two faulty versions (one
masked key made visible, each row's last page dropped) must fail that.
qmm_txn, qmm_txn_g, qmm_int8 and the M = 1 body (qmm_txn_m1, qmm_txn_m1_r,
qmm_moe_m1) sum their K splits in a fixed order: a second launch on the
same inputs gives the same bits, and qmm_txn with each superblock's lo and
hi scale rows swapped must fail its 1e-5 limit. The M = 1 body is also held
at one K split, at m1_split's and at a split a chunk.
The MoE kernels (routed GEMVs, routed fused FFN, grouped products) keep
the tolerances of their dense forms, and a control with two slots' or
tiles' expert ids swapped must read above 0.1 of the largest output. The
int8 prefill GEMM (qmm_i8p) runs its plain version's roundings in the same
order (exact int32 block dots, the f32 block updates in K order): it is held
bitwise equal to it at both of its n tiles (and within 1e-6 of its largest
magnitude), and a control with two blocks' weight scales swapped must fail
that. The three decode kernels run at every kind of head group: 1, 2, 4
and 8 query heads a KV head, 3, 5, 6 and 7 (masked columns of one chunk),
and 12, 16 and 32 (several chunks; flash_decode and paged_attention hold
16 in one), and at head_dim 256; flash_decode also with a sliding window,
paged_attention also at page sizes of 16, 48 and 128 (slabs and rank
boundaries anywhere in a page); two launches of flash_decode,
paged_attention or flash_prefill on the same inputs are bitwise equal. The int8 flavour's q4b product (qmm_int8)
is an int8-activation product, held within 1e-5, and a control with each
superblock's lo and hi scale rows swapped must fail that. A head_dim-64
llama runs Engine and the batcher on the reference's einsum and gather
decode routes; the tiny llama under LLAMAFILE_TPU_Q4B=int8 runs Engine on
qmm_int8 with exact launch counts.
"""
import pytest
import torch

from llamafile_tpu_torch.ops import attention as A
from llamafile_tpu_torch.ops import qmatmul as Q
from llamafile_tpu_torch.testing import (flash_prefill_tile_fault, i8p_fault,
                                         paged_case, paged_controls, planes_fault,
                                         q4b_scale_swap, rand_i8p, rand_q4b, rand_q8b,
                                         rel_err, row_rel_err, txn_scale_swap)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from llamafile_tpu_torch import resolve_device
    return resolve_device("cuda")


def assert_close(got, want, rel):
    err = rel_err(got, want)
    assert err <= rel, err


@pytest.mark.parametrize("n,k", [(4096, 4096), (6144, 1024), (1040, 512), (2048, 14336)])
@pytest.mark.parametrize("bias", [True, False])
def test_txn_m1_matches_plain(dev, n, k, bias):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    qs, sc, b = rand_q4b(gen, 2, n, k, dev)
    b = b[1] if bias else None
    xq, sx = Q.quantize_activations_g32(torch.randn(1, k, generator=gen, device=dev),
                                        torch.rand(k, generator=gen, device=dev) + 0.5, 1e-5)
    n0 = Q.qmm_txn_m1.launches
    got = Q.qmm_txn_m1(xq, sx, qs[1], sc[1], b)
    assert Q.qmm_txn_m1.launches == n0 + 1
    assert_close(got, Q.qmm_txn_m1_plain(xq, sx, qs[1], sc[1], b), 1e-5)
    assert torch.equal(Q.qmm_txn_m1(xq, sx, qs[1], sc[1], b), got)


def _m1_entry(xq, sx, qs, sc, b, s):
    """qmm_txn_m1's C entry at K split s (the wrapper takes m1_split's)."""
    from llamafile_tpu_torch.ops import _build
    k, ns = xq.shape[1], qs.shape[-1]
    y = torch.empty((1, ns), device=xq.device)
    f = _build.fn("qmm_txn_m1", "qmm_txn_m1", [_build.P] * 6 + [_build.I] * 3 + [_build.P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), sc.data_ptr(),
                   None if b is None else b.data_ptr(), y.data_ptr(), k, ns, s,
                   torch.cuda.current_stream().cuda_stream), "qmm_txn_m1")
    return y


@pytest.mark.parametrize("n,k", [(6144, 4096), (4096, 4096), (4096, 14336), (1040, 1024),
                                 (8192, 5376), (6144, 21504)])
@pytest.mark.parametrize("split", ["one", "rule", "most"])
def test_m1_body_splits_match_plain(dev, n, k, split):
    """The M = 1 body at qkv, o, down and a ragged Ns (a multiple of 16, not
    of 128), and at Gemma-3-27B's qkv and down (K = 5376 and 21504: 84 and
    336 chunks, split unevenly over 8), at one K split (every warp's ring
    over all of K), at m1_split's and at the most (a cluster of 8 blocks a
    tile); two launches give the same bits, and the splits agree within
    1e-5."""
    gen = torch.Generator(device=dev).manual_seed(n * 3 + k)
    qs, sc, b = rand_q4b(gen, 1, n, k, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(1, k, generator=gen, device=dev),
                                        torch.rand(k, generator=gen, device=dev) + 0.5, 1e-5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = {"one": 1, "rule": Q.m1_split(-(-n // 128), k // 64, sms),
         "most": min(k // 64, Q.M1_MAX_SPLITS)}[split]
    got = _m1_entry(xq, sx, qs[0], sc[0], b[0], s)
    assert_close(got, Q.qmm_txn_m1_plain(xq, sx, qs[0], sc[0], b[0]), 1e-5)
    assert torch.equal(_m1_entry(xq, sx, qs[0], sc[0], b[0], s), got)
    if split == "rule":
        assert torch.equal(Q.qmm_txn_m1(xq, sx, qs[0], sc[0], b[0]), got)


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 16, 17, 24, 25, 31, 32])
@pytest.mark.parametrize("n,k,bias,splits", [
    (4096, 4096, True, None), (1040, 1024, True, None), (1040, 256, False, None),
    (512, 14336, True, None), (128, 14336, True, "most"), (67584, 256, True, 1)])
def test_txn_matches_plain(dev, m, n, k, bias, splits):
    """Every n8 row-tile count (NT = 1..4) and its edges, a partial column
    tile (1040), one superblock (K = 256), no bias, uneven K splits (4
    column tiles over 224 chunks), a grid of one K split (528 column tiles)
    and one of a split a chunk (1 tile, 224 chunks).
    Two launches give the same bits; each superblock's lo and hi scale rows
    swapped must fail the limit."""
    gen = torch.Generator(device=dev).manual_seed(m * n + k)
    qs, sc, b = rand_q4b(gen, 2, n, k, dev)
    b = b[0] if bias else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = Q.n_split(-(-n // 128), k // 64, k // 64, sms)
    if splits is not None:
        assert s == (k // 64 if splits == "most" else splits), s
    xq, sx = Q.quantize_activations_g32(torch.randn(m, k, generator=gen, device=dev))
    n0 = Q.qmm_txn.launches
    got = Q.qmm_txn(xq, sx, qs[0], sc[0], b)
    assert Q.qmm_txn.launches == n0 + 1
    want = Q.qmm_txn_plain(xq, sx, qs[0], sc[0], b)
    assert_close(got, want, 1e-5)
    assert torch.equal(Q.qmm_txn(xq, sx, qs[0], sc[0], b), got)
    assert rel_err(txn_scale_swap(xq, sx, qs[0], sc[0], b), want) > 1e-5


# K an odd count of 256-blocks above 4096 (Gemma-3-27B: 5376 = 21 x 256 on
# qkv and gate|up, 21504 = 84 x 256 on down; o and down padded to 6144
# columns, and a ragged width) on every product kernel of its paths
GEMMA_K_SHAPES = [(8192, 5376), (6144, 21504), (1040, 5376)]


@pytest.mark.parametrize("kernel", ["txn_m1", "txn_m32", "int8_m8", "dequant_m1024",
                                    "planes_m2048", "q8_m1_g16", "dequant_q8b_g16_m300"])
@pytest.mark.parametrize("n,k", GEMMA_K_SHAPES)
def test_gemma_k_products_match_plain(dev, kernel, n, k):
    """Each product kernel at K = 5376 and 21504 on layer 1 of a 2-layer
    stack: the decode GEMV (bias), the prefill's qmm_txn at M = 32, the
    int8 flavour at M = 8, the dequant GEMM at phase 10's bucket, the
    unrolled Q4_K_M prefill's two-plane GEMM at bucket 2048, and the Q6_K
    (g 16) V and down of that recipe at decode and prefill; the limits of
    their own tests, and a second launch gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(n + k + len(kernel))
    m = {"txn_m1": 1, "txn_m32": 32, "int8_m8": 8, "dequant_m1024": 1024,
         "planes_m2048": 2048, "q8_m1_g16": 1, "dequant_q8b_g16_m300": 300}[kernel]
    if "g16" in kernel:
        qs, sc, b = rand_q8b(gen, 2, n, k, 16, dev)
    else:
        qs, sc, b = rand_q4b(gen, 2, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x)
    run, plain, tol = {
        "txn_m1": (lambda: Q.qmm_txn_m1(xq, sx, qs[1], sc[1], b[1]),
                   lambda: Q.qmm_txn_m1_plain(xq, sx, qs[1], sc[1], b[1]), 1e-5),
        "txn_m32": (lambda: Q.qmm_txn(xq, sx, qs[1], sc[1], b[1]),
                    lambda: Q.qmm_txn_plain(xq, sx, qs[1], sc[1], b[1]), 1e-5),
        "int8_m8": (lambda: Q.qmm_int8(xq, sx, qs[1], sc[1]),
                    lambda: Q.qmm_int8_plain(xq, sx, qs[1], sc[1]), 1e-5),
        "dequant_m1024": (lambda: Q.qmm_dequant(x, qs[1], sc[1]),
                          lambda: Q.qmm_dequant_plain(x, qs[1], sc[1]), 1e-3),
        "planes_m2048": (lambda: Q.qmm_planes(x, qs[1], sc[1]),
                         lambda: Q.qmm_planes_plain(x, qs[1], sc[1]), 2 ** -7),
        "q8_m1_g16": (lambda: Q.qmm_q8_m1(xq, sx, qs[1], sc[1]),
                      lambda: Q.qmm_q8_m1_plain(xq, sx, qs[1], sc[1]), 1e-5),
        "dequant_q8b_g16_m300": (lambda: Q.qmm_dequant(x, qs[1], sc[1]),
                                 lambda: Q.qmm_dequant_plain(x, qs[1], sc[1]), 1e-3)}[kernel]
    got = run()
    assert_close(got, plain(), tol)
    assert torch.equal(run(), got)


@pytest.mark.parametrize("d,dff", [(256, 1024), (4096, 14336)])
def test_moe_m1_matches_plain(dev, d, dff):
    """The dense FFN's call: one slot, the layer id as expert, a view of a
    device arange (its offset is not 16-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    gq, gs, gb = rand_q4b(gen, 2, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(gen, 2, d, dff, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(1, d, generator=gen, device=dev))
    ids = torch.arange(2, dtype=torch.int32, device=dev)
    topw = torch.full((1,), 0.75, device=dev)
    args = (xq, sx, gq, gs, gb, dq, ds, db, ids[1:2], None, topw)
    n0 = Q.qmm_moe_m1.launches
    got = Q.qmm_moe_m1(*args)
    assert Q.qmm_moe_m1.launches == n0 + 2        # gate|up kernel, down kernel
    assert_close(got, Q.qmm_moe_m1_plain(*args), 2e-3)
    assert torch.equal(Q.qmm_moe_m1(*args), got)


def _experts(gen, e, n, k, dev):
    qs, sc, b = rand_q4b(gen, e, n, k, dev)
    return qs, sc, b


@pytest.mark.parametrize("ids,rows", [((1, 1), (0, 0)), ((3, 0, 2, 1), (0, 0, 1, 1))])
def test_routed_moe_m1_matches_plain(dev, ids, rows, d=256, dff=1024):
    """All slots of a routed step in one launch pair: expert ids, token rows
    and routing weights read from device memory; two launches give the same
    bits, and swapping two slots' ids must fail the tolerance."""
    e = 4
    gen = torch.Generator(device=dev).manual_seed(len(ids))
    gq, gs, gb = _experts(gen, e, 2 * dff, d, dev)
    dq, ds, db = _experts(gen, e, d, dff, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(2, d, generator=gen, device=dev))
    ei = torch.tensor(ids, dtype=torch.int32, device=dev)
    ti = torch.tensor(rows, dtype=torch.int32, device=dev)
    topw = torch.rand(len(ids), generator=gen, device=dev) + 0.1
    got = Q.qmm_moe_m1(xq, sx, gq, gs, gb, dq, ds, db, ei, ti, topw)
    want = Q.qmm_moe_m1_plain(xq, sx, gq, gs, gb, dq, ds, db, ei, ti, topw)
    assert_close(got, want, 2e-3)
    assert torch.equal(Q.qmm_moe_m1(xq, sx, gq, gs, gb, dq, ds, db, ei, ti, topw), got)
    if len(set(ids)) > 1:
        bad = Q.qmm_moe_m1_plain(xq, sx, gq, gs, gb, dq, ds, db, ei.flip(0), ti, topw)
        assert rel_err(bad, want) > 0.1


@pytest.mark.parametrize("ids", [(2, 2), (1, 3)])
def test_routed_moe_m1_two_slots_mixtral(dev, ids):
    """A decode step's 2 slots at Mixtral-8x7B's widths (d 4096, d_ff
    14336), one expert twice or two experts: the routed fused FFN within
    2e-3 of its plain version, two launches bitwise equal."""
    test_routed_moe_m1_matches_plain(dev, ids, (0, 0), 4096, 14336)


@pytest.mark.parametrize("quant", ["q4b", "q8b16", "q8b32"])
@pytest.mark.parametrize("n,k", [(2048, 256), (4096, 14336)])
def test_routed_gemv_matches_plain(dev, quant, n, k):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    e = 4
    if quant == "q4b":
        qs, sc, b = rand_q4b(gen, e, n, k, dev)
        fn, plain = Q.qmm_txn_m1_r, Q.qmm_txn_m1_r_plain
    else:
        qs, sc, b = rand_q8b(gen, e, n, k, int(quant[3:]), dev)
        fn, plain = Q.qmm_q8_m1_r, Q.qmm_q8_m1_r_plain
    xq, sx = Q.quantize_activations_g32(torch.randn(2, k, generator=gen, device=dev))
    ei = torch.tensor([2, 0, 3, 2], dtype=torch.int32, device=dev)
    ti = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    n0 = fn.launches
    got = fn(xq, sx, qs, sc, b, ei, ti)
    assert fn.launches == n0 + 1
    want = plain(xq, sx, qs, sc, b, ei, ti)
    assert_close(got, want, 1e-5)
    assert torch.equal(fn(xq, sx, qs, sc, b, ei, ti), got)
    bad = plain(xq, sx, qs, sc, b, ei[[1, 0, 2, 3]], ti)
    assert rel_err(bad, want) > 0.1


@pytest.mark.parametrize("n,k", [(28672, 4096), (4096, 14336), (1040, 1024)])
@pytest.mark.parametrize("ids", [(3, 1), (2, 2)])
def test_routed_txn_m1_two_slots(dev, n, k, ids):
    """qmm_txn_m1_r at a decode step's 2 slots (Mixtral-8x7B's gate|up and
    down, a ragged Ns), two experts or one expert twice: within 1e-5 of the
    plain version, two launches bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(n + k + ids[0])
    qs, sc, b = rand_q4b(gen, 4, n, k, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(1, k, generator=gen, device=dev))
    ei = torch.tensor(ids, dtype=torch.int32, device=dev)
    ti = torch.zeros(2, dtype=torch.int32, device=dev)
    got = Q.qmm_txn_m1_r(xq, sx, qs, sc, b, ei, ti)
    assert_close(got, Q.qmm_txn_m1_r_plain(xq, sx, qs, sc, b, ei, ti), 1e-5)
    assert torch.equal(Q.qmm_txn_m1_r(xq, sx, qs, sc, b, ei, ti), got)


@pytest.mark.parametrize("tm", [8, 32])
@pytest.mark.parametrize("n,k", [(2048, 256), (28672, 4096), (4096, 14336)])
@pytest.mark.parametrize("te", [[0, 0, 2, 3, 3, 1], [2, 2, 2, 2], [3, 0, 0, 1]])
def test_txn_g_matches_plain(dev, tm, n, k, te):
    """Tiles of several experts, of one expert (every tile reads its
    weights), and with an expert (2) that no tile names; a group's padding
    rows give zeros, and two launches give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(tm * n + k + len(te))
    qs, sc, b = rand_q4b(gen, 4, n, k, dev)
    te = torch.tensor(te, dtype=torch.int32, device=dev)
    x = torch.randn(te.shape[0] * tm, k, generator=gen, device=dev)
    x[tm - 2:tm] = 0                               # a group's padding rows
    xq, sx = Q.quantize_activations_g32(x)
    n0 = Q.qmm_txn_g.launches
    got = Q.qmm_txn_g(xq, sx, qs, sc, b, te, tm)
    assert Q.qmm_txn_g.launches == n0 + 1
    want = Q.qmm_txn_g_plain(xq, sx, qs, sc, b, te, tm)
    assert_close(got, want, 1e-5)
    assert not got[tm - 2:tm].any()
    assert torch.equal(Q.qmm_txn_g(xq, sx, qs, sc, b, te, tm), got)
    other = (te + 1) % 4                           # every tile on another expert
    assert rel_err(Q.qmm_txn_g_plain(xq, sx, qs, sc, b, other, tm), want) > 0.1


@pytest.mark.parametrize("tiles,bias,valid", [(1, True, None), (3, True, None), (3, False, None),
                                              (3, True, 320), (1, False, 100)])
@pytest.mark.parametrize("n,k", [(2048, 256), (4096, 14336), (1040, 1024)])
def test_planes_g_matches_plain(dev, tiles, bias, valid, n, k):
    """Every row random (valid None), or the rows from `valid` on padding
    (zero), as group_layout leaves a group's last tile, so a tile's second
    warpgroup (rows 64-127) is only partly valid (320: tile 2's rows 64-127
    all padding, 100: rows 100-127)."""
    gen = torch.Generator(device=dev).manual_seed(tiles * n + k + (valid or 0) % 128)
    qs, sc, b = rand_q4b(gen, 4, n, k, dev)
    b = b if bias else None
    te = torch.tensor([3, 0, 1][:tiles], dtype=torch.int32, device=dev)
    x = torch.randn(tiles * 128, k, generator=gen, device=dev)
    if valid is not None:
        x[valid:] = 0
    n0 = Q.qmm_planes_g.launches
    got = Q.qmm_planes_g(x, qs, sc, b, te)
    assert Q.qmm_planes_g.launches == n0 + 1
    want = Q.qmm_planes_g_plain(x, qs, sc, b, te)
    assert got.dtype == want.dtype == (torch.bfloat16 if tiles * 128 >= 256 else torch.float32)
    tol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-3
    assert_close(got, want, tol)
    if tiles > 1:
        assert rel_err(Q.qmm_planes_g_plain(x, qs, sc, b, te.flip(0)), want) > 0.1


# head groups G = Hq / Hkv of the decode kernels: 1, 2, 4, 8 (one chunk of
# G heads), 3, 5, 6, 7 (one chunk, columns masked), 12, 16, 32 (chunks of
# at most 8 heads in flash_decode_write, 16 in the other two, each reading
# the K/V rows again)
GROUP_CASES = [(32, 8), (8, 8), (16, 4), (4, 2), (24, 8), (40, 8), (48, 8), (56, 8),
               (96, 8), (128, 8), (64, 2)]


@pytest.mark.parametrize("hq,hkv", [(32, 8), (8, 8), (16, 8), (16, 2)] + GROUP_CASES[4:])
@pytest.mark.parametrize("pos,s_limit", [((0, 5), None), ((700, 1023), 1024),
                                         ((1, 2000), None), ((0, 701), None),
                                         ((1500, 1030), 1024)])
def test_flash_decode_write_matches_plain(dev, hq, hkv, pos, s_limit):
    """The cluster kernel against its plain version: a row at pos 0 beside
    one whose 701 visible rows split unevenly over the cluster's ranks, and
    rows at or past s_limit (all s_limit rows visible, the write at pos), at
    every kind of head group (a group of more than 8 heads runs as chunks,
    chunk 0 alone writing the row). Two launches on the same inputs are
    bitwise equal (a fixed-order split)."""
    _fdw_check(dev, hq, hkv, pos, s_limit, 128)


# D = 256 (gemma's head dim): Gemma-2-9B's 16 query heads over 8 KV heads,
# Gemma-2B's 8 over 1, a group of 3, 16 over 1 (chunks in every kernel
# at D = 256), and Gemma-7B's 16 over 16 (a group of 1)
D256_CASES = [(16, 8), (8, 1), (24, 8), (16, 1), (16, 16)]


@pytest.mark.parametrize("hq,hkv", D256_CASES)
@pytest.mark.parametrize("pos,s_limit", [((0, 701), None), ((1500, 1030), 1024)])
def test_flash_decode_write_d256_matches_plain(dev, hq, hkv, pos, s_limit):
    _fdw_check(dev, hq, hkv, pos, s_limit, 256)


# gemma2's options: the window (past and inside the visible rows) and the
# softcap, at 50 and at 1.5 (where it bends every score); gemma3's window
# of 1024 alone
OPTION_CASES = [(100, 0.0), (None, 50.0), (100, 50.0), (4096, 1.5), (700, 1.5), (1024, 0.0)]


@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 256), (32, 8, 128), (128, 8, 128), (8, 1, 256),
                                      (32, 16, 128)])
@pytest.mark.parametrize("win,cap", OPTION_CASES)
def test_flash_decode_write_options_match_plain(dev, hq, hkv, d, win, cap):
    """The window (the visible rows start at pos - win + 1, split over the
    ranks from there) and the softcap (every score, the new token's too)."""
    _fdw_check(dev, hq, hkv, (700, 2000), None, d, win, cap)


def _fdw_check(dev, hq, hkv, pos, s_limit, d, win=None, cap=0.0, dtype=torch.bfloat16,
               tol=2e-2):
    gen = torch.Generator(device=dev).manual_seed(hq * 10 + hkv + (d if d != 128 else 0))
    nl, b, s = 3, 2, 2048
    k3 = torch.randn((nl, b, s, hkv * d), generator=gen, device=dev).to(dtype)
    v3 = torch.randn((nl, b, s, hkv * d), generator=gen, device=dev).to(dtype)
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    kn = torch.randn((b, hkv, d), generator=gen, device=dev)
    vn = torch.randn((b, hkv, d), generator=gen, device=dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    k3b, v3b = k3.clone(), v3.clone()
    k3c, v3c = k3.clone(), v3.clone()
    n0 = A.flash_decode_write_stacked.launches
    got = A.flash_decode_write_stacked(q, k3, v3, kn, vn, 1, p, 0.088, hkv,
                                       s_limit=s_limit, win_l=win, softcap=cap)
    assert A.flash_decode_write_stacked.launches == n0 + 1
    s_eff = s_limit if s_limit is not None else s
    want = A.flash_decode_write_plain(q, k3b, v3b, kn, vn, 1, p, 0.088, hkv, s_eff, win, cap)
    assert_close(got, want, tol)
    assert torch.equal(k3, k3b) and torch.equal(v3, v3b)
    if cap == 1.5 or win == 100:                        # the options change the output
        plain = A.flash_decode_write_plain(q, k3b.clone(), v3b.clone(), kn, vn, 1, p, 0.088,
                                           hkv, s_eff)
        assert (got - plain).abs().max() > 2e-2 * plain.abs().max()
    again = A.flash_decode_write_stacked(q, k3c, v3c, kn, vn, 1, p, 0.088, hkv,
                                         s_limit=s_limit, win_l=win, softcap=cap)
    assert A.flash_decode_write_stacked.launches == n0 + 2
    assert torch.equal(again, got)
    assert torch.equal(k3c, k3) and torch.equal(v3c, v3)


@pytest.mark.parametrize("n,k", [(4096, 4096), (6144, 1024), (1044, 512), (2048, 14336)])
@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("bias", [True, False])
def test_q8_m1_matches_plain(dev, n, k, g, bias):
    gen = torch.Generator(device=dev).manual_seed(n + k + g)
    qs, sc, b = rand_q8b(gen, 2, n, k, g, dev)
    b = b[1] if bias else None
    xq, sx = Q.quantize_activations_g32(torch.randn(1, k, generator=gen, device=dev),
                                        torch.rand(k, generator=gen, device=dev) + 0.5, 1e-5)
    n0 = Q.qmm_q8_m1.launches
    got = Q.qmm_q8_m1(xq, sx, qs[1], sc[1], b)
    assert Q.qmm_q8_m1.launches == n0 + 1
    assert_close(got, Q.qmm_q8_m1_plain(xq, sx, qs[1], sc[1], b), 1e-5)


@pytest.mark.parametrize("kind", ["q4b", "q8b32", "q8b16", "q8b8"])
@pytest.mark.parametrize("m", [1, 33, 64, 65, 128, 129, 192, 200, 512])
@pytest.mark.parametrize("n,k", [(4096, 4096), (1040, 1024), (512, 14336)])
def test_dequant_matches_plain(dev, kind, m, n, k):
    gen = torch.Generator(device=dev).manual_seed(m * n + k)
    if kind == "q4b":
        qs, sc, _ = rand_q4b(gen, 2, n, k, dev)
    else:
        qs, sc, _ = rand_q8b(gen, 2, n, k, int(kind[3:]), dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    n0 = Q.qmm_dequant.launches
    got = Q.qmm_dequant(x, qs[1], sc[1])
    assert Q.qmm_dequant.launches == n0 + 1
    assert_close(got, Q.qmm_dequant_plain(x, qs[1], sc[1]), 1e-3)


@pytest.mark.parametrize("m", [33, 64, 65, 128, 129, 192, 200, 256, 1024])
@pytest.mark.parametrize("n,k", [(4096, 4096), (1040, 1024), (512, 14336)])
def test_planes_matches_plain(dev, m, n, k):
    gen = torch.Generator(device=dev).manual_seed(m * n + k + 1)
    qs, sc, _ = rand_q4b(gen, 2, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    n0 = Q.qmm_planes.launches
    got = Q.qmm_planes(x, qs[1], sc[1])
    assert Q.qmm_planes.launches == n0 + 1
    want = Q.qmm_planes_plain(x, qs[1], sc[1])
    assert got.dtype == want.dtype == (torch.bfloat16 if m >= 256 else torch.float32)
    tol = 1e-3 if m < 256 else 2 ** -7       # bf16 out: one step of the largest
    assert_close(got, want, tol)
    assert rel_err(planes_fault(x, qs[1], sc[1]), want) > tol


def wide_scales(gen, shape, dev):
    """bf16 scales of random bit patterns: magnitudes 2^-40 to 2^40 (no
    subnormal product, no overflow of 128 x scale), both signs."""
    exp = torch.randint(127 - 40, 127 + 40, shape, generator=gen, device=dev)
    mant = torch.randint(0, 128, shape, generator=gen, device=dev)
    sign = torch.randint(0, 2, shape, generator=gen, device=dev)
    bits = (sign << 15) | (exp << 7) | mant
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(
        torch.bfloat16)


@pytest.mark.parametrize("scales", ["rand", "wide"])
@pytest.mark.parametrize("kind", ["q4b", "q8b32", "q8b16", "q8b8", "planes"])
def test_dequant_tile_bits_one_hot(dev, kind, scales):
    """The dequantized B tile, bit for bit: with x = I (K = 1024 one-hot
    rows) every output sum has one nonzero term, so y[k, :] is W[k, :]
    exactly and must equal dequant_bf16 (values compared, so a -0 product
    that the f32 sum turns into +0 counts as equal). q4b covers both planes;
    "planes" is the q4b planes entry, whose bf16 output at M = 1024 holds the
    same bf16 values. Every byte value occurs; "wide" scales span 2^-40 to
    2^40 of both signs, so the products round at every exponent of that range."""
    k, n = 1024, 1040
    gen = torch.Generator(device=dev).manual_seed(7)
    if kind in ("q4b", "planes"):
        qs, sc, _ = rand_q4b(gen, 2, n, k, dev)
    else:
        qs, sc, _ = rand_q8b(gen, 2, n, k, int(kind[3:]), dev)
        qs = torch.randint(-128, 128, qs.shape, generator=gen, device=dev, dtype=torch.int8)
    assert torch.unique(qs[1]).numel() == 256
    if scales == "wide":
        sc = wide_scales(gen, sc.shape, dev)
    eye = torch.eye(k, device=dev)
    got = (Q.qmm_planes if kind == "planes" else Q.qmm_dequant)(eye, qs[1], sc[1])
    assert got.dtype == (torch.bfloat16 if kind == "planes" else torch.float32)
    assert torch.equal(got.float(), Q.dequant_bf16(qs[1], sc[1]).float())


@pytest.mark.parametrize("m", [33, 64, 128, 300, 1024])
@pytest.mark.parametrize("n,k", [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336),
                                 (2560, 5632), (1040, 1024)])
def test_i8p_matches_plain(dev, m, n, k):
    """llama3-8b's qkv, o, gate|up and down, TinyLlama's qkv at K 5632 (22
    blocks, not a multiple of 2048) and an Ns of 1040 (a multiple of 16,
    not of 128), on layer 1 of a 3-layer stack (the stacked form: views by
    pointer), at ragged and full row tiles: bitwise equal to the plain
    version, at the n tile the wrapper picks."""
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    w8, sw = rand_i8p(gen, 3, n, k, dev)
    xq, sxa = Q.i8p_prep(torch.randn(m, k, generator=gen, device=dev))
    n0 = Q.qmm_i8p.launches
    got = Q.qmm_i8p(xq, sxa, w8[1], sw[1])
    assert Q.qmm_i8p.launches == n0 + 1
    want = Q.qmm_i8p_plain(xq, sxa, w8[1], sw[1])
    assert_close(got, want, 1e-6)
    assert torch.equal(got, want)
    assert rel_err(i8p_fault(xq, sxa, w8[1], sw[1]), want) > 1e-6
    assert torch.equal(got, Q.qmm_i8p(xq, sxa, w8[1], sw[1]))


@pytest.mark.parametrize("m", [33, 64, 128, 300, 1024])
@pytest.mark.parametrize("n,k", [(1040, 1024), (4096, 4096), (1040, 1280)])
def test_i8p_unrolled_and_stacked_bitwise(dev, m, n, k):
    """An unrolled layer (its own allocation) and layer 1 of a stack, both
    bitwise equal to the plain version, at both n tiles (64 up to M = 300
    at Ns 1040 and up to M = 128 at Ns 4096, 128 beyond) and at an odd
    count of 256-blocks (K 1280); the control with two blocks' weight scales
    swapped differs."""
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    w8, sw = rand_i8p(gen, 3, n, k, dev)
    xq, sxa = Q.i8p_prep(torch.randn(m, k, generator=gen, device=dev))
    want = Q.qmm_i8p_plain(xq, sxa, w8[1], sw[1])
    for w, s in ((w8[1].clone(), sw[1].clone()), (w8[1], sw[1])):
        assert torch.equal(Q.qmm_i8p(xq, sxa, w, s), want)
    assert not torch.equal(i8p_fault(xq, sxa, w8[1], sw[1]), want)


def test_i8p_qmatmul_stacked_and_unrolled(dev):
    """qmatmul on an I8PQTensor built from Q4_K weights: a stacked leaf's
    layer li and the same layer unstacked launch qmm_i8p and agree with the
    CPU's plain path on the same inputs within 1e-6."""
    from llamafile_tpu_torch.models.synthetic import _rand_qtensor
    from llamafile_tpu_torch.ops.repack import attach_int8_prefill
    from llamafile_tpu_torch.models.llama import _stack_leaf
    gen = torch.Generator(device=dev).manual_seed(5)
    qts = [attach_int8_prefill(_rand_qtensor(gen, 1500, 2304, "Q4_K", dev)) for _ in range(3)]
    st = _stack_leaf(qts)
    x = torch.randn(300, 2304, generator=gen, device=dev)
    nrm = 1 + 0.1 * torch.randn(2304, generator=gen, device=dev)
    n0 = Q.qmm_i8p.launches
    got = Q.qmatmul(x, st, 1, prenorm=(nrm, 1e-5))
    assert torch.equal(got, Q.qmatmul(x, qts[1], prenorm=(nrm, 1e-5)))
    assert Q.qmm_i8p.launches == n0 + 2 and got.shape == (300, 1500)
    want = Q.qmatmul(x.cpu(), qts[1].to("cpu"), prenorm=(nrm.cpu(), 1e-5))
    assert_close(got.cpu(), want, 1e-6)


@pytest.mark.parametrize("m", [1, 5, 8, 16, 24, 32])
@pytest.mark.parametrize("n,k", [(6144, 4096), (28672, 4096), (4096, 14336), (1040, 1024)])
def test_int8_matches_plain(dev, m, n, k):
    """llama3-8b's qkv, gate|up and down, and a narrow odd width, on layer 1
    of a 2-layer stack (views by pointer), at every padded M and below."""
    gen = torch.Generator(device=dev).manual_seed(m + n + k + 3)
    qs, sc, _ = rand_q4b(gen, 2, n, k, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(m, k, generator=gen, device=dev))
    n0 = Q.qmm_int8.launches
    got = Q.qmm_int8(xq, sx, qs[1], sc[1])
    assert Q.qmm_int8.launches == n0 + 1
    want = Q.qmm_int8_plain(xq, sx, qs[1], sc[1])
    assert_close(got, want, 1e-5)
    assert rel_err(q4b_scale_swap(xq, sx, qs[1], sc[1]), want) > 1e-5
    assert torch.equal(got, Q.qmm_int8(xq, sx, qs[1], sc[1]))


@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 16, 31, 32])
@pytest.mark.parametrize("k", [256, 4096])
@pytest.mark.parametrize("n", [16, 2048, 6144])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unrolled"])
def test_int8_txn_body_matches_plain(dev, m, k, n, stacked):
    """qmm_int8 on qmm_txn's body with no bias: every n8 row-tile count and
    its edges, one superblock and a K of 16 superblocks, one 16-column
    piece of a tile, whole tiles; on layer 1 of a stack (views by pointer)
    and on an unstacked weight. Within 1e-5 of the plain version, two
    launches bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
    qs, sc, _ = rand_q4b(gen, 2, n, k, dev)
    if stacked:
        qs, sc = qs[1], sc[1]
    else:
        qs, sc = qs[1].clone(), sc[1].clone()
    xq, sx = Q.quantize_activations_g32(torch.randn(m, k, generator=gen, device=dev))
    got = Q.qmm_int8(xq, sx, qs, sc)
    assert_close(got, Q.qmm_int8_plain(xq, sx, qs, sc), 1e-5)
    assert torch.equal(Q.qmm_int8(xq, sx, qs, sc), got)


@pytest.mark.parametrize("flavour,m,kernel", [("planes", 8, "qmm_planes"),
                                              ("planes", 300, "qmm_planes"),
                                              ("int8", 8, "qmm_int8"),
                                              ("int8", 300, "qmm_planes")])
def test_flavour_stacked_products(dev, flavour, m, kernel, monkeypatch):
    """qmatmul under a q4b flavour on layer 1 of a stacked Q4_K leaf (row 12
    for the planes kernel, row 14 for qmm_int8) launches its kernel once,
    equals the same layer unstacked bit for bit, and agrees with the CPU's
    plain path on the same inputs (bf16 out from 256 rows: one bf16 step
    and the bias term added in bf16)."""
    from llamafile_tpu_torch.models.llama import _stack_leaf
    from llamafile_tpu_torch.models.synthetic import _rand_qtensor
    monkeypatch.setattr(Q, "Q4B_KERNEL", flavour)
    gen = torch.Generator(device=dev).manual_seed(m + 11)
    qts = [_rand_qtensor(gen, 1500, 2048, "Q4_K", dev) for _ in range(2)]
    st = _stack_leaf(qts)
    x = torch.randn(m, 2048, generator=gen, device=dev)
    nrm = 1 + 0.1 * torch.randn(2048, generator=gen, device=dev)
    assert Q.product_route(st, m, 2048, 1) == kernel
    fn = getattr(Q, kernel)
    n0 = fn.launches
    got = Q.qmatmul(x, st, 1, prenorm=(nrm, 1e-5))
    assert fn.launches == n0 + 1 and got.shape == (m, 1500)
    assert torch.equal(got, Q.qmatmul(x, qts[1], prenorm=(nrm, 1e-5)))
    want = Q.qmatmul(x.cpu(), qts[1].to("cpu"), prenorm=(nrm.cpu(), 1e-5))
    assert got.dtype == want.dtype
    assert_close(got.cpu(), want, 2 * 2 ** -7 if m >= 256 else 1e-3)


def test_int8_flavour_engine_launch_counts(dev, monkeypatch):
    """The tiny llama (2 layers, fused qkv and gate|up, d_ff 512) under
    LLAMAFILE_TPU_Q4B=int8: a 24-token prompt (bucket 32) and 11 decode
    steps run every q4b product on qmm_int8 (4 a layer, then the head at
    M = 1), and nothing on the txn kernels."""
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import kernel_wrappers, reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    monkeypatch.setattr(Q, "Q4B_KERNEL", "int8")
    cfg, params = make_synthetic_llama("tiny", "Q4_K", seed=4, fuse=True, device=dev)
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=256, device=dev)
    reset_launch_counts()
    ids = [t for t, _ in eng.generate("", max_tokens=12, sampling=SamplingParams(temperature=0.0),
                                      stop_on_eog=False, prompt_ids=list(range(5, 29)))]
    assert len(ids) == 12
    n = cfg.n_layers
    counts = {w.__name__: w.launches for w in kernel_wrappers()}
    assert counts == {name: {"qmm_int8": 4 * n + 1 + (4 * n + 1) * 11}.get(name, 0)
                      for name in counts}


def test_head_dim_64_engine_and_batcher(dev):
    """A head_dim-64 llama (the tiny preset: 4 heads of 64, 2 KV heads) with
    a max_seq_len that is not a multiple of 256, through Engine (bf16 cache)
    and the batcher (paged pool, 3 rows) on the card: decode attention takes
    the reference's einsum and gather routes with no decode kernel launch,
    and the Engine's prefill and first decode logits agree with the CPU's."""
    from llamafile_tpu_torch.models.llama import forward
    from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
    from llamafile_tpu_torch.ops import reset_launch_counts
    from llamafile_tpu_torch.runtime.engine import Engine
    from llamafile_tpu_torch.runtime.sampling import SamplingParams
    from llamafile_tpu_torch.runtime.tokenizer import Tokenizer
    from llamafile_tpu_torch.server.batcher import Batcher
    cfg, params = make_synthetic_llama("tiny", "Q4_K", seed=3, fuse=True, device=dev)
    assert cfg.head_dim == 64
    eng = Engine(cfg, params, Tokenizer({}), max_seq_len=300, device=dev)
    prompt = list(range(5, 45))
    sp = SamplingParams(temperature=0.0)
    reset_launch_counts()
    ids = [t for t, _ in eng.generate("", max_tokens=12, sampling=sp, stop_on_eog=False,
                                      prompt_ids=prompt)]
    assert len(ids) == 12 and all(0 <= t < cfg.n_vocab for t in ids)
    assert A.ROUTE_COUNTS["einsum"] == 11 * cfg.n_layers
    assert A.flash_decode_write_stacked.launches == A.flash_decode.launches == 0
    logits = []
    for d, p in (("cuda", eng.params), ("cpu", _cpu(eng.params))):
        c = eng.new_cache() if d == "cuda" else _cpu_cache(eng)
        toks = torch.tensor([prompt + [0] * 24], device=d)
        lg0, _ = forward(p, cfg, toks, torch.zeros(1, dtype=torch.int32, device=d), c,
                         fresh_prefill=True, last_idx=torch.tensor([len(prompt) - 1], device=d))
        lg1, _ = forward(p, cfg, torch.tensor([[ids[0]]], device=d),
                         torch.tensor([len(prompt)], dtype=torch.int32, device=d), c,
                         attn_len=300)
        logits.append([lg0.cpu(), lg1.cpu()])
    for a, b in zip(*logits):
        assert_close(a, b, 2e-2)
    reset_launch_counts()
    bt = Batcher(eng, rows=3)
    try:
        reqs = [bt.submit(prompt[:n], sp, 6) for n in (9, 20, 33)]
        for r in reqs:
            toks = []
            while True:
                kind, val = r.out.get(timeout=300)
                assert kind != "error", val
                if kind == "done":
                    break
                toks.append(val)
            assert len(toks) == 6
    finally:
        bt.shutdown()
    assert A.ROUTE_COUNTS["gather"] > 0 and A.paged_attention.launches == 0


def _cpu(params):
    import dataclasses
    from llamafile_tpu_torch.models.llama import LlamaParams
    layer = dataclasses.replace(params.layers, **{
        f.name: getattr(params.layers, f.name).to("cpu")
        for f in dataclasses.fields(params.layers) if getattr(params.layers, f.name) is not None})
    return LlamaParams(params.tok_embd.cpu(), layer, params.out_norm.cpu(),
                       params.output.to("cpu"))


def _cpu_cache(eng):
    from llamafile_tpu_torch.models.llama import init_cache
    return init_cache(eng.cfg, 1, eng.max_seq_len, device="cpu")


def decode_case(gen, dev, b, s, hq, hkv, int8, d=128, dtype=torch.bfloat16):
    """q f32 [B, Hq, D]; a 3-layer cache (flat [L, B, S, Hkv*D] of dtype,
    or int8 [L, B, S, Hkv, D] with f32 scales [L, B, S, Hkv])."""
    q = torch.randn((b, hq, d), generator=gen, device=dev)
    if int8:
        kv = [torch.randint(-127, 128, (3, b, s, hkv, d), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2)]
        sc = [torch.empty((3, b, s, hkv), device=dev).uniform_(2e-3, 2e-2, generator=gen)
              for _ in range(2)]
        return q, kv, sc
    kv = [torch.randn((3, b, s, hkv * d), generator=gen, device=dev).to(dtype)
          for _ in range(2)]
    return q, kv, [None, None]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv", GROUP_CASES)
@pytest.mark.parametrize("pos,s_eff", [((0, 5), 256), ((700, 1023), 1024), ((1, 2047), 2048)])
def test_flash_decode_matches_plain(dev, int8, hq, hkv, pos, s_eff):
    """The cluster kernel (one launch, every head of a group of up to 16
    from one K/V read at D = 128, chunks above) against its plain version;
    two launches on the same inputs are bitwise equal."""
    _fd_check(dev, int8, hq, hkv, pos, s_eff, 128)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv", D256_CASES)
@pytest.mark.parametrize("pos,s_eff", [((0, 5), 256), ((700, 1023), 1024), ((1, 2047), 2048)])
def test_flash_decode_d256_matches_plain(dev, int8, hq, hkv, pos, s_eff):
    _fd_check(dev, int8, hq, hkv, pos, s_eff, 256)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (16, 1, 128), (8, 1, 256)])
@pytest.mark.parametrize("window", [1, 100, 1500])
def test_flash_decode_window_matches_plain(dev, int8, hq, hkv, d, window):
    """The sliding window: keys j > pos - window only, split over the
    cluster's ranks from the window's first row."""
    _fd_check(dev, int8, hq, hkv, (700, 2047), 2048, d, window)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 256), (32, 8, 128), (8, 1, 256)])
@pytest.mark.parametrize("window,cap", [(0, 50.0), (0, 1.5), (100, 1.5), (1500, 50.0)])
def test_flash_decode_softcap_matches_plain(dev, int8, hq, hkv, d, window, cap):
    """gemma2's score softcap, alone and with the window."""
    _fd_check(dev, int8, hq, hkv, (700, 2047), 2048, d, window, cap)


def _fd_check(dev, int8, hq, hkv, pos, s_eff, d, window=0, cap=0.0, dtype=torch.bfloat16,
              tol=2e-2):
    gen = torch.Generator(device=dev).manual_seed(hq * 10 + hkv + s_eff + int8 + window
                                                  + (d if d != 128 else 0))
    q, (k, v), (ks, vs) = decode_case(gen, dev, 2, 2048, hq, hkv, int8, d, dtype)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    n0 = A.flash_decode.launches
    if int8:
        sl = lambda t: t[1, :, :s_eff]
        args = (q, sl(k), sl(v), p, 0.088, window, cap)
        run = lambda: A.flash_decode(*args, k_scale=sl(ks), v_scale=sl(vs))
        got = run()
        want = A.flash_decode_plain(*args, k_scale=sl(ks), v_scale=sl(vs))
        assert row_rel_err(got, want) <= 1e-5
        more = A.flash_decode_plain(q, sl(k), sl(v), p + 1, 0.088, window, cap,
                                    k_scale=sl(ks), v_scale=sl(vs))
        assert row_rel_err(more, want) > 1e-5           # one masked key made visible
    else:
        kc, vc = (t[1, :, :s_eff].reshape(2, s_eff, hkv, d) for t in (k, v))
        run = ((lambda: A.flash_decode(q, kc, vc, p, 0.088, window, cap)) if window or cap
               else (lambda: A.flash_decode_stacked(q, k, v, 1, p, 0.088, hkv, s_limit=s_eff)))
        got = run()
        want = A.flash_decode_plain(q, kc, vc, p, 0.088, window, cap)
        assert row_rel_err(got, want) <= tol
    if cap == 1.5:                                      # the softcap changes the output
        uncapped = (A.flash_decode_plain(q, sl(k), sl(v), p, 0.088, window, k_scale=sl(ks),
                                         v_scale=sl(vs)) if int8
                    else A.flash_decode_plain(q, kc, vc, p, 0.088, window))
        assert row_rel_err(uncapped, want) > 2e-2
    assert A.flash_decode.launches == n0 + 1
    assert bool(torch.isfinite(got).all())
    assert torch.equal(run(), got)                      # a fixed-order merge


@pytest.mark.parametrize("t", [128, 384, 512, 2048])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (4, 4, 64), (4, 2, 256), (16, 1, 128),
                                      (8, 8, 128), (16, 1, 256), (32, 16, 128), (16, 16, 256)])
def test_flash_prefill_matches_plain(dev, t, hq, hkv, d):
    """The wgmma kernel at head groups of 1, 2, 4 and 16, D = 64, 128 and
    256 (Gemma-3-27B's 32 over 16 at D = 128, Gemma-7B's 16 over 16 at D =
    256), one and several query tiles; two launches on the same inputs are
    bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(t + hq + d)
    q = torch.randn((2, t, hq, d), generator=gen, device=dev)
    k = torch.randn((2, t, hkv, d), generator=gen, device=dev)
    v = torch.randn((2, t, hkv, d), generator=gen, device=dev)
    n0 = A.flash_prefill.launches
    got = A.flash_prefill(q, k, v, d ** -0.5)
    assert A.flash_prefill.launches == n0 + 1
    assert bool(torch.isfinite(got).all())
    want = A.flash_prefill_plain(q, k, v, d ** -0.5)
    assert row_rel_err(got, want) <= 1.5e-2
    fault = flash_prefill_tile_fault(q, k, v, d ** -0.5)
    assert row_rel_err(fault, want) > 0.75          # the control fails the bound
    assert torch.equal(A.flash_prefill(q, k, v, d ** -0.5), got)


PAGED_LENGTHS = {1: [64], 3: [1, 63, 65],
                 8: [1, 63, 64, 65, 700, 1024, 1500, 2048]}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("hq,hkv", GROUP_CASES)
def test_paged_attention_matches_plain(dev, int8, r, hq, hkv):
    _paged_check(dev, int8, r, hq, hkv, 128)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("hq,hkv", D256_CASES)
def test_paged_attention_d256_matches_plain(dev, int8, r, hq, hkv):
    _paged_check(dev, int8, r, hq, hkv, 256)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ps,maxp,lengths", [
    (16, 64, [1, 15, 16, 17, 33, 500, 1023, 1024]),       # a slab spans two pages
    (48, 8, [47, 48, 49, 95, 300, 384]),                  # pages not a multiple of the slab
    (128, 16, [1, 127, 128, 129, 2048])])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (128, 8, 128), (16, 1, 256)])
def test_paged_attention_page_sizes(dev, int8, ps, maxp, lengths, hq, hkv, d):
    """Page sizes other than the batcher's 64: the rank split is over keys,
    so slabs and rank boundaries fall anywhere in a page."""
    _paged_check(dev, int8, len(lengths), hq, hkv, d, ps, maxp, lengths)


def _paged_check(dev, int8, r, hq, hkv, d, ps=64, maxp=32, lengths=None,
                 dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(r * 100 + hq + hkv + int8
                                                  + (d if d != 128 else 0)
                                                  + (ps if ps != 64 else 0))
    q, kp, vp, ks, vs, lens, tables = paged_case(
        gen, lengths or PAGED_LENGTHS[r], hq, hkv, d, ps, maxp, n_layers=2, int8=int8,
        device=dev, dtype=dtype)
    sc = (lambda t: None) if ks is None else (lambda t: t[1])
    args = (q, kp[1], vp[1], lens, tables, sc(ks), sc(vs))
    n0 = A.paged_attention.launches
    got = A.paged_attention(*args)
    assert A.paged_attention.launches == n0 + 1
    want = A.paged_attention_plain(*args)
    assert row_rel_err(got, want) <= 1e-5
    for control in paged_controls(q, kp[1], vp[1], sc(ks), sc(vs), lens, tables, ps):
        assert row_rel_err(control, want) > 1e-5
    assert torch.equal(got, A.paged_attention(*args))    # fixed-order merge


# f16 and f32 caches and pages (--kv-dtype f16|f32): f16 rounds q and p to
# f16 as bf16 does to bf16, three mantissa bits finer, so the kernels are
# held within 5e-3 (2e-2 for bf16); f32 rounds nothing, and the kernels
# differ from their plain versions only in the order of f32 sums: within
# 1e-4 of the largest output (flash_decode_write) and 1e-5 of each row's
# (flash_decode, as its int8 form; paged_attention, as every page type)
KV_FLOATS = {"f16": (torch.float16, 5e-3, 5e-3), "f32": (torch.float32, 1e-4, 1e-5)}
KV_GROUPS = [(32, 8, 128), (8, 8, 128), (24, 8, 128), (64, 2, 128), (8, 1, 128),
             (16, 8, 256), (8, 1, 256), (16, 16, 256)]


@pytest.mark.parametrize("kv", list(KV_FLOATS))
@pytest.mark.parametrize("hq,hkv,d", KV_GROUPS)
@pytest.mark.parametrize("pos,s_limit", [((0, 701), None), ((700, 1023), 1024),
                                         ((1500, 1030), 1024), ((1, 2000), None)])
def test_flash_decode_write_kv_floats_match_plain(dev, kv, hq, hkv, d, pos, s_limit):
    dtype, tol, _ = KV_FLOATS[kv]
    _fdw_check(dev, hq, hkv, pos, s_limit, d, dtype=dtype, tol=tol)


@pytest.mark.parametrize("kv", list(KV_FLOATS))
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 256), (32, 8, 128), (8, 1, 256)])
@pytest.mark.parametrize("win,cap", [(100, 0.0), (None, 50.0), (700, 1.5)])
def test_flash_decode_write_kv_floats_options(dev, kv, hq, hkv, d, win, cap):
    dtype, tol, _ = KV_FLOATS[kv]
    _fdw_check(dev, hq, hkv, (700, 2000), None, d, win, cap, dtype=dtype, tol=tol)


@pytest.mark.parametrize("kv", list(KV_FLOATS))
@pytest.mark.parametrize("hq,hkv,d", KV_GROUPS + [(128, 8, 128)])
@pytest.mark.parametrize("pos,s_eff", [((0, 5), 256), ((700, 1023), 1024), ((1, 2047), 2048)])
def test_flash_decode_kv_floats_match_plain(dev, kv, hq, hkv, d, pos, s_eff):
    dtype, _, tol = KV_FLOATS[kv]
    _fd_check(dev, False, hq, hkv, pos, s_eff, d, dtype=dtype, tol=tol)


@pytest.mark.parametrize("kv", list(KV_FLOATS))
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (16, 8, 256)])
@pytest.mark.parametrize("window,cap", [(100, 0.0), (0, 1.5), (1500, 50.0)])
def test_flash_decode_kv_floats_options(dev, kv, hq, hkv, d, window, cap):
    dtype, _, tol = KV_FLOATS[kv]
    _fd_check(dev, False, hq, hkv, (700, 2047), 2048, d, window, cap, dtype=dtype, tol=tol)


@pytest.mark.parametrize("kv", list(KV_FLOATS))
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("hq,hkv,d", KV_GROUPS)
def test_paged_attention_kv_floats_match_plain(dev, kv, r, hq, hkv, d):
    _paged_check(dev, False, r, hq, hkv, d, dtype=KV_FLOATS[kv][0])


def test_wrapper_rejects_bad_inputs(dev):
    xq = torch.zeros(1, 256, dtype=torch.int8, device=dev)
    sx = torch.zeros(1, 8, device=dev)
    qs = torch.zeros(128, 512, dtype=torch.uint8, device=dev)
    sc = torch.zeros(8, 512, device=dev)                      # f32, not bf16
    with pytest.raises(TypeError):
        Q.qmm_txn_m1(xq, sx, qs, sc)
    with pytest.raises(ValueError):
        Q.qmm_txn_m1(xq, sx, qs.cpu(), sc.to(torch.bfloat16).cpu())
    with pytest.raises(ValueError):                           # Ns % 16 != 0
        Q.qmm_dequant(torch.zeros(40, 256, device=dev),
                      torch.zeros(256, 520, dtype=torch.int8, device=dev),
                      torch.zeros(8, 520, dtype=torch.bfloat16, device=dev))
    # the M = 1 body and qmm_int8 (qmm_txn's body) copy 16 bytes at a time:
    # Ns % 16 != 0 (1044) is refused before any launch
    qs16 = torch.zeros(1, 128, 1044, dtype=torch.uint8, device=dev)
    sc16 = torch.zeros(1, 8, 1044, dtype=torch.bfloat16, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    counted = (Q.qmm_txn_m1, Q.qmm_int8, Q.qmm_txn_m1_r, Q.qmm_moe_m1)
    before = [f.launches for f in counted]
    with pytest.raises(ValueError):
        Q.qmm_txn_m1(xq, sx, qs16[0], sc16[0])
    with pytest.raises(ValueError):
        Q.qmm_int8(xq, sx, qs16[0], sc16[0])
    with pytest.raises(ValueError):
        Q.qmm_txn_m1_r(xq, sx, qs16, sc16, None, one, one)
    with pytest.raises(ValueError):                           # the down product's Ns
        Q.qmm_moe_m1(xq, sx, torch.zeros(1, 128, 2048, dtype=torch.uint8, device=dev),
                     torch.zeros(1, 8, 2048, dtype=torch.bfloat16, device=dev), None,
                     torch.zeros(1, 512, 1044, dtype=torch.uint8, device=dev),
                     torch.zeros(1, 32, 1044, dtype=torch.bfloat16, device=dev), None,
                     one, None, torch.ones(1, device=dev))
    assert [f.launches for f in counted] == before
    q, kp, vp, _, _, lens, tables = paged_case(
        torch.Generator(device=dev), [5], 12, 8, 128, 64, 4, device=dev)
    with pytest.raises(ValueError):                           # Hq % Hkv != 0
        A.paged_attention(q, kp[0], vp[0], lens, tables)
    q, kp, vp, _, _, lens, tables = paged_case(
        torch.Generator(device=dev), [5], 8, 8, 128, 64, 4, device=dev)
    with pytest.raises(ValueError):                           # int64 tables
        A.paged_attention(q, kp[0], vp[0], lens, tables.long())
    # D = 64 takes the reference's gather route, with no launch
    n0, g0 = A.paged_attention.launches, A.ROUTE_COUNTS["gather"]
    args = (q[..., :64].contiguous(), kp[0, ..., :64].contiguous(),
            vp[0, ..., :64].contiguous(), lens, tables)
    assert torch.equal(A.paged_attention(*args), A.paged_gather(*args))
    assert A.paged_attention.launches == n0 and A.ROUTE_COUNTS["gather"] == g0 + 1


# Qwen3-32B's products (storage N): qkv (N 10240, K 5120), o (N 5120 in
# 6144, K 8192), the interleaved gate|up (N 51200), down (K 25600); and
# Qwen2.5-7B's: qkv (N 4608 in 6144, K 3584), o, the concatenated gate|up
# (N 37888 in 38912), down (K 18944)
QWEN_SHAPES = [(10240, 5120), (6144, 8192), (51200, 5120), (6144, 25600),
               (6144, 3584), (4096, 3584), (38912, 3584), (4096, 18944)]


@pytest.mark.parametrize("kernel", ["txn_m1", "txn_m32", "txn_m4", "dequant_m1024"])
@pytest.mark.parametrize("n,k", QWEN_SHAPES)
def test_qwen_products_match_plain(dev, kernel, n, k):
    """Each q4b product kernel of the qwen paths at their shapes, on layer 1
    of a 2-layer stack: the decode GEMV, the 24-token prefill's and the
    4-slot server's qmm_txn, the 1000-token prefill's dequant GEMM; the
    limits of their own tests, a second launch bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(n + k + len(kernel))
    m = {"txn_m1": 1, "txn_m32": 32, "txn_m4": 4, "dequant_m1024": 1024}[kernel]
    qs, sc, b = rand_q4b(gen, 2, n, k, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    xq, sx = Q.quantize_activations_g32(x)
    if kernel == "txn_m1":
        run = lambda: Q.qmm_txn_m1(xq, sx, qs[1], sc[1], b[1])
        plain, tol = Q.qmm_txn_m1_plain(xq, sx, qs[1], sc[1], b[1]), 1e-5
    elif kernel == "dequant_m1024":
        run = lambda: Q.qmm_dequant(x, qs[1], sc[1])
        plain, tol = Q.qmm_dequant_plain(x, qs[1], sc[1]), 1e-3
    else:
        run = lambda: Q.qmm_txn(xq, sx, qs[1], sc[1], b[1])
        plain, tol = Q.qmm_txn_plain(xq, sx, qs[1], sc[1], b[1]), 1e-5
    got = run()
    assert_close(got, plain, tol)
    assert torch.equal(run(), got)


@pytest.mark.parametrize("m,kernel", [(1, "qmm_q8_m1"), (4, "qmm_dequant")])
@pytest.mark.parametrize("n,k", [(151936, 5120), (152064, 3584)])
def test_qwen_heads_match_plain(dev, m, kernel, n, k):
    """The Q6_K heads (vocab 151936 and 152064, not multiples of 2048 and,
    the first, of 256; stored in 153600 columns) through qmatmul: the
    logits the sampler sees are [M, n], the last column tile held like the
    rest, on qmm_q8_m1 at M = 1 and qmm_dequant at M = 4."""
    from llamafile_tpu_torch.ops.repack import QTensor
    gen = torch.Generator(device=dev).manual_seed(n + m)
    qs, sc, _ = rand_q8b(gen, 1, 153600, k, 16, dev)
    head = QTensor("q8b", (n, k), 16, qs[0], sc[0], None)
    x = torch.randn(m, k, generator=gen, device=dev)
    n0 = getattr(Q, kernel).launches
    got = Q.qmatmul(x, head)
    assert getattr(Q, kernel).launches == n0 + 1 and tuple(got.shape) == (m, n)
    xq, sx = Q.quantize_activations_g32(x)
    want = (Q.qmm_q8_m1_plain(xq, sx, qs[0], sc[0]) if m == 1
            else Q.qmm_dequant_plain(x, qs[0], sc[0]))[:, :n]
    tol = 1e-5 if m == 1 else 1e-3
    assert_close(got[:, n - 128:], want[:, n - 128:], tol)
    assert_close(got, want, tol)


def test_qwen3_fused_ffn_matches_plain(dev):
    """Qwen3-32B's fused decode FFN: d 5120, d_ff 25600 = 25 x 1024."""
    d, dff = 5120, 25600
    gen = torch.Generator(device=dev).manual_seed(d + dff)
    gq, gs, gb = rand_q4b(gen, 2, 2 * dff, d, dev)
    dq, ds, db = rand_q4b(gen, 2, d, dff, dev)
    xq, sx = Q.quantize_activations_g32(torch.randn(1, d, generator=gen, device=dev))
    ids = torch.arange(2, dtype=torch.int32, device=dev)
    args = (xq, sx, gq, gs, gb, dq, ds, db, ids[1:2], None, torch.ones(1, device=dev))
    got = Q.qmm_moe_m1(*args)
    assert_close(got, Q.qmm_moe_m1_plain(*args), 2e-3)
    assert torch.equal(Q.qmm_moe_m1(*args), got)


@pytest.mark.parametrize("hq,hkv", [(64, 8), (28, 4)], ids=["qwen3-32b", "qwen2.5-7b"])
@pytest.mark.parametrize("kernel", ["flash_decode_write", "flash_decode_bf16",
                                    "flash_decode_int8", "paged_bf16", "paged_int8"])
def test_qwen_decode_groups_match_plain(dev, hq, hkv, kernel):
    """The three decode kernels at Qwen3-32B's 64 over 8 heads (G = 8) and
    Qwen2.5-7B's 28 over 4 (G = 7)."""
    if kernel == "flash_decode_write":
        _fdw_check(dev, hq, hkv, (700, 1023), 1024, 128)
    elif kernel.startswith("flash_decode"):
        _fd_check(dev, kernel.endswith("int8"), hq, hkv, (700, 1023), 1024, 128)
    else:
        _paged_check(dev, kernel.endswith("int8"), 8, hq, hkv, 128)


@pytest.mark.parametrize("b,t,hq,hkv", [(8, 128, 32, 8), (8, 512, 32, 8), (64, 128, 32, 8),
                                        (64, 512, 32, 8), (1, 1024, 64, 8),
                                        (1, 1024, 28, 4)])
def test_flash_prefill_batched_and_qwen_heads(dev, b, t, hq, hkv):
    """flash_prefill at B = 8 and 64 rows (the embedding batches of llama3-8b
    at buckets 128 and 512), and at Qwen3-32B's and Qwen2.5-7B's heads:
    row by row within 1.5e-2, the diagonal-tile control rejected, two
    launches bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(b + t + hq)
    q = torch.randn((b, t, hq, 128), generator=gen, device=dev)
    k = torch.randn((b, t, hkv, 128), generator=gen, device=dev)
    v = torch.randn((b, t, hkv, 128), generator=gen, device=dev)
    got = A.flash_prefill(q, k, v, 128 ** -0.5)
    want = A.flash_prefill_plain(q, k, v, 128 ** -0.5)
    assert row_rel_err(got, want) <= 1.5e-2
    assert row_rel_err(flash_prefill_tile_fault(q, k, v, 128 ** -0.5), want) > 0.75
    assert torch.equal(A.flash_prefill(q, k, v, 128 ** -0.5), got)
