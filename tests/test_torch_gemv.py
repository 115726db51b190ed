"""The launch rules of the M = 1 q4b body and of qmm_int8, on the CPU.

ops.qmatmul.m1_split gives the K split of every launch of the M = 1 body
(csrc/qmm_m1.cuh: qmm_txn_m1, qmm_txn_m1_r, both phases of qmm_moe_m1):
the fewest splits whose blocks put M1_IN_FLIGHT_PER_SM bytes of chunks in
flight for each SM at the start, each warp's ring full (M1_STAGES - 1
chunks ahead), capped where a warp would get fewer chunks than its ring
holds and at 8 (a column tile's splits are one thread-block cluster of the
portable size). It is held here at the main path's shapes (llama3-8b's qkv, o,
down, gate|up and lm head, Mixtral-8x7B's routed step of 2 slots, the
dense FFN's layer as one slot) on an H100 SXM's 132 SMs and an H100
PCIe's 114. qmm_int8 takes qmm_txn's split (txn_split: 128-column tiles,
3 blocks an SM, at most a split a chunk). The kernels themselves are held
against their plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2).
"""
import os
import re

import pytest

from llamafile_tpu_torch.ops import qmatmul as Q

CSRC = os.path.join(os.path.dirname(Q.__file__), os.pardir, "csrc")
AHEAD = Q.M1_WARPS * (Q.M1_STAGES - 1)           # chunks a block keeps in flight

# (what, blocks a split: column tiles x slots, chunks = K / 64, {SMs: split})
M1_SHAPES = [
    ("qkv N 6144", 48, 64, {132: 4, 114: 3}),
    ("o N 4096", 32, 64, {132: 5, 114: 5}),
    ("down N 4096 K 14336", 32, 224, {132: 5, 114: 5}),
    ("gate|up N 28672", 224, 64, {132: 1, 114: 1}),
    ("lm head N 129024", 1008, 64, {132: 1, 114: 1}),
    ("dense FFN gate|up, one slot", 224, 64, {132: 1, 114: 1}),
    ("dense FFN down, one slot", 32, 224, {132: 5, 114: 5}),
    ("routed gate|up, 2 slots", 2 * 224, 64, {132: 1, 114: 1}),
    ("routed down, 2 slots", 2 * 32, 224, {132: 3, 114: 3}),
    ("Llama-3.2-3B qkv N 5120 K 3072", 40, 48, {132: 4, 114: 4}),
    ("Llama-3.2-3B o N 4096 K 3072", 32, 48, {132: 5, 114: 5}),
    ("Llama-3.2-3B down N 4096 K 8192", 32, 128, {132: 5, 114: 5}),
]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("what,tiles,chunks,want", M1_SHAPES,
                         ids=[s[0] for s in M1_SHAPES])
def test_m1_split_main_path(what, tiles, chunks, want, sms):
    s = Q.m1_split(tiles, chunks, sms)
    assert s == want[sms], what
    _holds(tiles, chunks, sms, s)


@pytest.mark.parametrize("sms", [1, 8, 66, 114, 132])
def test_m1_split_fills_the_card(sms):
    """Over a grid of sizes: at least one split and never more than the
    chunks; every warp gets a full ring's chunks unless one split already
    holds fewer; the bytes in flight reach sms x M1_IN_FLIGHT_PER_SM unless
    that cap binds, with the fewest splits that do."""
    for tiles in (1, 2, 3, 7, 32, 40, 48, 64, 131, 224, 448, 1008, 5000):
        for chunks in (4, 8, 16, 48, 64, 128, 224):
            _holds(tiles, chunks, sms, Q.m1_split(tiles, chunks, sms))


def _holds(tiles, chunks, sms, s):
    most = max(1, min(chunks // AHEAD, Q.M1_MAX_SPLITS))
    per_block = AHEAD * Q.M1_STAGE_BYTES
    assert 1 <= s <= min(most, chunks)
    assert s == 1 or chunks // s >= AHEAD             # each warp's ring full
    assert tiles * s * per_block >= sms * Q.M1_IN_FLIGHT_PER_SM or s == most
    assert s == 1 or tiles * (s - 1) * per_block < sms * Q.M1_IN_FLIGHT_PER_SM


def _constants(text, known=()):
    """{name: value} of the `constexpr int NAME = EXPR;` lines of a header's
    text, each EXPR evaluated over `known` and the names before it."""
    names = dict(known)
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        names[name] = eval(expr, {}, dict(names))
    return names


def _kernel_constants():
    common = _constants(open(os.path.join(CSRC, "qmm_common.cuh")).read())
    text = open(os.path.join(CSRC, "qmm_m1.cuh")).read()
    m1 = _constants(text.split("struct M1Stage")[0], common)
    stage = _constants(re.search(r"struct M1Stage \{(.*?)\n\};", text, re.S).group(1), common)
    return {"M1_WARPS": m1["M1_WARPS"], "M1_STAGES": m1["M1_STAGES"],
            "M1_MAX_SPLITS": m1["M1_MAX_SPLITS"], "M1_STAGE_BYTES": stage["BYTES"]}


@pytest.mark.parametrize("name", ["M1_WARPS", "M1_STAGES", "M1_MAX_SPLITS", "M1_STAGE_BYTES"])
def test_m1_constants_match_the_kernel(name):
    """The Python mirror of csrc/qmm_m1.cuh's warps, ring stages, most
    splits and the bytes of a ring stage (M1Stage::BYTES, worked out from
    the header's layout over qmm_common.cuh's TN and CHUNK_ROWS)."""
    assert getattr(Q, name) == _kernel_constants()[name]


@pytest.mark.parametrize("what,ns,k,want", [
    ("gate|up", 28672, 4096, 2), ("down", 4096, 14336, 13), ("qkv", 6144, 4096, 9),
    ("o", 4096, 4096, 13), ("lm head", 129024, 4096, 1), ("one piece", 16, 256, 4),
    ("one tile", 2048, 256, 4),
])
@pytest.mark.parametrize("sms", [132, 114])
def test_int8_takes_txn_split(what, ns, k, want, sms):
    """qmm_int8 runs qmm_txn's body, so it takes qmm_txn's split: n_split
    of its 128-column tiles, at most a split a chunk (the earlier kernel
    took 32-column tiles and at most K/64/8)."""
    s = Q.txn_split(ns, k, sms)
    assert s == Q.n_split(-(-ns // 128), k // 64, k // 64, sms)
    if sms == 132:
        assert s == want, what
    assert 1 <= s <= k // 64
