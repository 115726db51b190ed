"""The routed MoE FFN of the port against the JAX package on the CPU: the
expert stacks byte for byte, the plain versions of the routed and grouped
kernels against the JAX package's Pallas calls (interpret mode), and
moe_ffn by every branch of its routing.

Shapes: d_model 256, d_ff 1024 (interleaved gate|up, the fused kernel's
layout) or 512 (concatenated gate|up), E = 4 experts, top-2. Weights are
the same GGUF block bytes repacked by each package.

Tolerances, with their reasons:
- The routed and grouped int8 products (qmm_txn_m1_r, qmm_q8_m1_r,
  qmm_txn_g) share every integer dot and rounding rule with the reference;
  only the f32 order of the group sums differs: 1e-5 of the largest output.
- The fused FFN (qmm_moe_m1) requantizes silu(g) * u inside: a last-bit
  difference of g or u moves one code of a group by one step (the dense
  fused FFN's tolerance in tests/test_torch_qmatmul.py): 2e-3.
- The grouped planes product (qmm_planes_g) sums bf16 products in f32 and
  rounds its output once to bf16 from 256 rows: 1e-3 below 256 rows (the
  dense GEMM's), one bf16 step of the largest (2**-7) from 256.
- moe_ffn: the same products, plus the f32 softmax, silu and the slot sums
  in another order: 2e-3 of the largest output for the int8 routes; the
  grouped route at 600 slots, and the dense route at 300 rows (the
  two-plane kernel), carry bf16 gate|up and down products through silu
  and the weights: 2e-2. The router's top-k must pick the
  same experts (the weights are drawn far from ties).
"""
import types

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models import llama as JL
from llamafile_tpu.ops import qmatmul as JQM
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.synthetic import decode_read_bytes, make_synthetic_llama
from llamafile_tpu_torch.ops import qmatmul as TQM
from llamafile_tpu_torch.ops import repack as TR

D, E, K_USED = 256, 4, 2


def raw_weight(rng, n, k, quant, scale=0.08):
    arr = (rng.standard_normal((n, k)) * scale).astype(np.float32)
    if quant == "F32":
        return arr
    return JQ.TYPE_BY_NAME[quant].quantize(arr.reshape(-1))


def both(raw, quant, shape):
    """The same bytes repacked by the JAX package and by the port."""
    if quant == "F32":
        return (JR.repack(raw.reshape(-1).view(np.uint8), "F32", shape),
                TR.repack(raw.reshape(-1).view(np.uint8), "F32", shape, device="cpu"))
    return JR.repack(raw, quant, shape), TR.repack(raw, quant, shape, device="cpu")


def experts(seed, dff, quants=("Q4_K", "Q4_K", "Q4_K")):
    """Per-expert QTensors {role.e} of both packages (gate, up, down quants)."""
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for e in range(E):
        for role, (n, k), q in zip(("gate", "up", "down"),
                                   ((dff, D), (dff, D), (D, dff)), quants):
            qe = q[e] if isinstance(q, tuple) else q
            j[f"{role}.{e}"], t[f"{role}.{e}"] = both(raw_weight(rng, n, k, qe), qe, (n, k))
    return j, t


def np32(a):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a


def assert_same_qt(t, j):
    assert (t.kind, tuple(t.shape), t.g, t.il) == (j.kind, tuple(j.shape), j.g, bool(j.il))
    for a, b in ((t.qs, j.qs), (t.scales, j.scales), (t.bias, j.bias)):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(a.float().numpy() if a.dtype == torch.bfloat16
                                          else a.numpy(), np32(b))


@pytest.mark.parametrize("dff,quant,fuse,key", [
    (1024, "Q4_K", True, "gateup_il"), (512, "Q4_K", True, "gateup"),
    (512, "Q8_0", True, "gateup"), (1024, "Q4_K", False, "gate")])
def test_stack_experts_byte_identical(dff, quant, fuse, key):
    j, t = experts(1, dff, (quant,) * 3)
    js = JR.stack_experts(j, E, fuse_gate_up=fuse)
    ts = TR.stack_experts(t, E, fuse_gate_up=fuse)
    assert set(ts) == set(js) and key in ts
    for role in ts:
        assert_same_qt(ts[role], js[role])
    sl = TR.expert_slice(ts["down"], 2)
    np.testing.assert_array_equal(sl.qs.numpy(), t["down.2"].qs.numpy())


def test_stack_experts_refuses_heterogeneous():
    _, t = experts(2, 1024, ("Q4_K", "Q4_K", ("Q8_0", "Q4_K", "Q4_K", "Q4_K")))
    with pytest.raises(ValueError):
        TR.stack_experts(t, E, fuse_gate_up=True)


def _moe_layer(seed, dff, quants, fuse=True):
    """(jax layer, port layer) namespaces with a dense F32 router and the
    experts stacked (or the per-expert dict when they do not stack)."""
    rng = np.random.default_rng(seed + 100)
    jr, tr = both(raw_weight(rng, E, D, "F32", 0.3), "F32", (E, D))
    j, t = experts(seed, dff, quants)
    try:
        js, ts = JR.stack_experts(j, E, fuse_gate_up=fuse), TR.stack_experts(t, E, fuse_gate_up=fuse)
    except ValueError:
        js, ts = j, t
    return (types.SimpleNamespace(gate_inp=jr, experts=js),
            types.SimpleNamespace(gate_inp=tr, experts=ts))


def _layer_obj(ns):
    return TL.LlamaLayer(attn_norm=torch.ones(D), ffn_norm=torch.ones(D), wo=None,
                         gate_inp=ns.gate_inp, experts=ns.experts)


def test_stack_layers_merges_and_refuses_mixed():
    _, a = _moe_layer(3, 1024, ("Q4_K",) * 3)
    _, b = _moe_layer(4, 1024, ("Q4_K",) * 3)
    la, lb = _layer_obj(a), _layer_obj(b)
    p = TL.LlamaParams(torch.zeros(8, D, dtype=torch.bfloat16), [la, lb], torch.ones(D), None)
    st = TL.stack_layers(p)
    gu = st.layers.experts["gateup_il"]
    assert gu.qs.shape[0] == 2 * E and st.layers.gate_inp.qs.shape[0] == 2
    for li, layer in enumerate((la, lb)):           # expert li*E + e is layer li's e
        for e in range(E):
            np.testing.assert_array_equal(gu.qs[li * E + e].numpy(),
                                          layer.experts["gateup_il"].qs[e].numpy())
            np.testing.assert_array_equal(st.layers.experts["down"].bias[li * E + e].float().numpy(),
                                          layer.experts["down"].bias[e].float().numpy())
    _, c = _moe_layer(5, 1024, ("Q4_K", "Q4_K", "Q6_K"))       # Q6_K down: not q4b
    pm = TL.LlamaParams(p.tok_embd, [la, _layer_obj(c)], p.out_norm, None)
    assert TL.stack_layers(pm) is pm
    _, d = _moe_layer(6, 1024, ("Q4_K", "Q4_K", ("Q8_0", "Q4_K", "Q4_K", "Q4_K")))
    assert isinstance(d.experts, dict) and "down.0" in d.experts   # per-expert dict
    pd = TL.LlamaParams(p.tok_embd, [_layer_obj(d), _layer_obj(d)], p.out_norm, None)
    assert TL.stack_layers(pd) is pd


def _stack(seed, n_exp, n, k, quant, bias):
    rng = np.random.default_rng(seed)
    j, t = zip(*[both(raw_weight(rng, n, k, quant), quant, (n, k)) for _ in range(n_exp)])
    js = [jnp.stack([getattr(q, f) for q in j]) for f in ("qs", "scales")]
    ts = [torch.stack([getattr(q, f) for q in t]) for f in ("qs", "scales")]
    jb = tb = None
    if bias:
        jb = jnp.stack([q.bias if q.bias is not None else jnp.zeros_like(q.scales) for q in j])
        tb = torch.stack([q.bias if q.bias is not None else torch.zeros_like(q.scales)
                          for q in t])
    return js + [jb], ts + [tb]


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()
    assert err <= rel, err
    return err


@pytest.mark.parametrize("ids", [(2, 2, 0, 3), (1, 3, 0, 2)], ids=["repeated", "distinct"])
def test_txn_m1_r_plain_matches_jax(ids):
    (jq, js, jb), (tq, ts, tb) = _stack(7, E, 1024, D, "Q4_K", True)
    x = np.random.default_rng(8).standard_normal((2, D)).astype(np.float32)
    ei = np.asarray(ids, np.int32)
    ti = np.asarray([0, 0, 1, 1], np.int32)
    want = JQM._qmm_call_txn_m1_routed(jnp.asarray(x), jq, js, jnp.asarray(ei), jnp.asarray(ti),
                                       jb, interpret=True)
    xq, sx = TQM.quantize_activations_g32(torch.from_numpy(x))
    got = TQM.qmm_txn_m1_r(xq, sx, tq, ts, tb, torch.from_numpy(ei), torch.from_numpy(ti))
    _close(got.numpy()[:, :1024], np.asarray(want)[:, :1024], 1e-5)


@pytest.mark.parametrize("quant,bias", [("Q6_K", False), ("Q8_0", False), ("Q6_K", True),
                                        ("Q8_0", True)])
def test_q8_m1_r_plain_matches_jax(quant, bias):
    (jq, js, jb), (tq, ts, tb) = _stack(9, E, 512, D, quant, bias)
    g = 16 if quant == "Q6_K" else 32
    if bias:      # q8b experts carry no bias; the kernel's fused term takes one
        rng = np.random.default_rng(10)
        b = (rng.standard_normal(tuple(ts.shape)) * 0.05).astype(np.float32)
        tb = torch.from_numpy(b).to(torch.bfloat16)
        jb = jnp.asarray(tb.float().numpy(), jnp.bfloat16)
    x = np.random.default_rng(11).standard_normal((2, D)).astype(np.float32)
    ei, ti = np.asarray([3, 1, 1, 0], np.int32), np.asarray([0, 0, 1, 1], np.int32)
    want = JQM._qmm_call_q8_m1_routed(jnp.asarray(x), jq, js, jnp.asarray(ei), jnp.asarray(ti),
                                      jb, g=g, interpret=True)
    xq, sx = TQM.quantize_activations_g32(torch.from_numpy(x))
    got = TQM.qmm_q8_m1_r(xq, sx, tq, ts, tb, torch.from_numpy(ei), torch.from_numpy(ti))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("tm", [8, 32])
def test_txn_g_plain_matches_jax(tm):
    (jq, js, jb), (tq, ts, tb) = _stack(12, E, 1024, D, "Q4_K", True)
    tiles = 5
    x = np.random.default_rng(13).standard_normal((tiles * tm, D)).astype(np.float32)
    x[tm - 3:tm] = 0.0                               # padding rows of a group
    te = np.asarray([0, 2, 2, 3, 1], np.int32)
    want = JQM._qmm_call_txn_grouped(jnp.asarray(x), jq, js, jnp.asarray(te), jb, tm=tm,
                                     interpret=True)
    xq, sx = TQM.quantize_activations_g32(torch.from_numpy(x))
    got = TQM.qmm_txn_g(xq, sx, tq, ts, tb, torch.from_numpy(te), tm)
    _close(got.numpy(), want, 1e-5)
    assert not got[tm - 3:tm].any()


@pytest.mark.parametrize("tiles,bias", [(1, True), (3, True), (3, False)])
def test_planes_g_plain_matches_jax(tiles, bias):
    (jq, js, jb), (tq, ts, tb) = _stack(14, E, 1024, 512, "Q4_K", bias)
    x = np.random.default_rng(15).standard_normal((tiles * 128, 512)).astype(np.float32)
    te = np.asarray([3, 0, 3][:tiles], np.int32)
    want = JQM._qmm_call_planes_grouped(jnp.asarray(x), jq, js, jnp.asarray(te), jb, tm=128,
                                        interpret=True)
    got = TQM.qmm_planes_g(torch.from_numpy(x), tq, ts, tb, torch.from_numpy(te), 128)
    bf = tiles * 128 >= 256
    assert got.dtype == (torch.bfloat16 if bf else torch.float32)
    assert (np.asarray(want).dtype == jnp.bfloat16) == bf
    _close(got.float().numpy(), np32(want), 2 ** -7 if bf else 1e-3)


@pytest.mark.parametrize("ids", [(1, 1), (0, 3, 2, 1)], ids=["repeated", "distinct"])
def test_routed_moe_m1_plain_matches_jax(ids):
    (gq, gs, gb), (tgq, tgs, tgb) = _stack(16, E, 1024, D, "Q4_K", True)
    (uq, us, ub), (tuq, tus, tub) = _stack(17, E, 1024, D, "Q4_K", True)
    (dq, ds, db), (tdq, tds, tdb) = _stack(18, E, D, 1024, "Q4_K", True)
    il = lambda a, b: TR.interleave_gateup(TR.QTensor("q4b", (1024, D), 32, a[0], a[1], a[2]),
                                           TR.QTensor("q4b", (1024, D), 32, b[0], b[1], b[2]))
    tgu = il((tgq, tgs, tgb), (tuq, tus, tub))
    to_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    m = len(ids) // 2 if len(ids) > 2 else 1
    x = np.random.default_rng(19).standard_normal((m, D)).astype(np.float32)
    ei = np.asarray(ids, np.int32)
    ti = np.repeat(np.arange(m, dtype=np.int32), len(ids) // m)
    topw = np.random.default_rng(20).uniform(0.2, 0.8, len(ids)).astype(np.float32)
    want = JQM._qmm_call_moe_m1(jnp.asarray(x), jnp.asarray(tgu.qs.numpy()), to_j(tgu.scales),
                                to_j(tgu.bias), dq, ds, db, jnp.asarray(ei), jnp.asarray(ti),
                                jnp.asarray(topw), interpret=True)
    xq, sx = TQM.quantize_activations_g32(torch.from_numpy(x))
    got = TQM.qmm_moe_m1(xq, sx, tgu.qs, tgu.scales, tgu.bias, tdq, tds, tdb,
                         torch.from_numpy(ei), torch.from_numpy(ti), torch.from_numpy(topw))
    _close(got.numpy()[:, :D], np.asarray(want)[:, :D], 2e-3)


def _cfg(mod, dff):
    kw = dict(n_layers=1, d_model=D, n_heads=2, n_kv_heads=1, head_dim=128, d_ff=dff,
              n_vocab=256, n_experts=E, n_experts_used=K_USED, moe_norm_topk=True)
    return mod.LlamaConfig(**kw)


MOE_CASES = {
    # name: (d_ff, (gate, up, down) quants, {M: route})
    "q4k_il": (1024, ("Q4_K",) * 3, {1: "fused", 2: "fused", 4: "grouped", 5: "grouped",
                                     40: "grouped", 300: "grouped"}),
    "q4k_concat": (512, ("Q4_K",) * 3, {1: "routed", 2: "routed", 5: "grouped",
                                        40: "grouped"}),
    "q4k_q6k_down": (1024, ("Q4_K", "Q4_K", "Q6_K"), {1: "routed", 2: "routed", 5: "dense",
                                                      40: "dense", 300: "dense"}),
    "q8_0": (512, ("Q8_0",) * 3, {1: "routed", 4: "dense"}),
    "per_expert": (512, ("Q4_K", "Q4_K", ("Q8_0", "Q4_K", "Q4_K", "Q4_K")),
                   {1: "dense", 5: "dense"}),
}


@pytest.mark.parametrize("case,m", [(c, m) for c, (_, _, r) in MOE_CASES.items() for m in r])
def test_moe_ffn_matches_jax(case, m):
    dff, quants, routes = MOE_CASES[case]
    jl, tl = _moe_layer(21, dff, quants)
    jcfg, tcfg = _cfg(JL, dff), _cfg(TL, dff)
    assert TL.moe_route(tl, tcfg, m) == routes[m]
    if routes[m] == "grouped":
        assert TL.grouped_tm(m * K_USED) == (8 if m <= 32 else 32 if m <= 256 else 128)
    x = np.random.default_rng(m).standard_normal((m, D)).astype(np.float32)
    want = np.asarray(JL.moe_ffn(jnp.asarray(x), jl, jcfg))
    got = TL.moe_ffn(torch.from_numpy(x), tl, tcfg).numpy()
    tol = 2e-2 if m == 300 else 2e-3
    _close(got, want, tol)


def test_grouped_ffn_rows_match_rows_alone():
    """The group layout of grouped_expert_ffn: rows sorted by expert (stable),
    each group padded to tm, the tile map naming each tile's expert."""
    _, tl = _moe_layer(22, 1024, ("Q4_K",) * 3)
    gid = torch.tensor([3, 0, 3, 3, 1, 0, 3, 3, 3, 3], dtype=torch.int32)
    rows = torch.randn(10, D)
    w = torch.rand(10)
    out = TL.grouped_expert_ffn(rows, gid, w, tl.experts, E, 8)
    for i in range(10):                  # each row through its own expert alone
        one = TL.grouped_expert_ffn(rows[i:i + 1], gid[i:i + 1], w[i:i + 1], tl.experts, E, 8)
        _close(out[i:i + 1].numpy(), one.numpy(), 1e-5)


def test_decode_read_bytes_counts_routed_share():
    cfg, p = make_synthetic_llama("tiny-moe", "Q4_K", fuse=True, device="cpu")
    ex = p.layers[0].experts
    routed = sum(ex[r].nbytes for r in ("gateup", "down"))
    total = sum(t.numel() * t.element_size() for t in
                [p.out_norm] + [a for l in p.layers for a in (l.attn_norm, l.ffn_norm)]) + sum(
        q.nbytes for l in p.layers for q in (l.wqkv, l.wo, l.gate_inp)) + p.output.nbytes
    want = total + cfg.n_layers * routed * cfg.n_experts_used // cfg.n_experts
    assert decode_read_bytes(p, cfg) == want
    st = TL.stack_layers(p)
    assert decode_read_bytes(st, cfg) == want
