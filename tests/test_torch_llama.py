"""The port's stacked llama forward against the JAX package's, on a tiny Q4_K
model carried across with params_from_numpy.

Config: d_model 256, 2 layers, d_ff 1024 (so the dense FFN fuses at M = 1),
vocab 1024, head_dim 128 (so decode reaches the fused attention kernel). The
JAX side runs its Pallas kernels in interpret mode, attention included (the
monkeypatch of tests/test_flash_write.py).

Tolerance: the two paths share every integer dot and quantization rule and
differ only in f32 summation order and in last-bit results of rope, rsqrt,
exp and silu. Most steps therefore agree to 1e-5 of the largest logit; but
an ulp that lands on a rounding boundary of one of the per-32 activation
quantizations moves that code by one step, which moved logits by up to 1.2%
of the largest (measured on this model). Hence: every step within 2e-2 of
the largest logit with the same top-1, and at least half the steps within
1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import fuse_projections as j_fuse
from llamafile_tpu.models.synthetic import _rand_qtensor
from llamafile_tpu_torch.convert import params_from_numpy
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.ops import qmatmul as TQ

D, DFF, NL, V, H, HKV = 256, 1024, 2, 1024, 2, 1
MAX_LEN = 256
# one compile per shape: the decode steps reuse the traced kernels
j_forward = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))


@pytest.fixture
def pallas_kernels(monkeypatch):
    orig = JA.pl.pallas_call
    monkeypatch.setattr(JA.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    yield
    jax.clear_caches()


def np32(a):
    return None if a is None else np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def qt_dict(qt):
    if qt is None:
        return None
    return {"kind": qt.kind, "shape": qt.shape, "g": qt.g, "qs": np32(qt.qs),
            "scales": np32(qt.scales), "bias": np32(qt.bias), "il": qt.il}


def jax_model(seed=0, quant="Q4_K"):
    cfg = JL.LlamaConfig(n_layers=NL, d_model=D, n_heads=H, n_kv_heads=HKV,
                         head_dim=D // H, d_ff=DFF, n_vocab=V, max_context=MAX_LEN)
    rng = np.random.default_rng(seed)
    nrm = lambda: jnp.asarray(1 + 0.1 * rng.standard_normal(D), jnp.float32)
    rq = lambda n, k: _rand_qtensor(rng, n, k, quant)
    layers = [JL.LlamaLayer(
        attn_norm=nrm(), ffn_norm=nrm(),
        wq=rq(H * 128, D), wk=rq(HKV * 128, D), wv=rq(HKV * 128, D),
        wo=rq(D, H * 128), w_gate=rq(DFF, D), w_up=rq(DFF, D),
        w_down=rq(D, DFF)) for _ in range(NL)]
    embd = jnp.asarray(rng.standard_normal((V, D)), jnp.bfloat16)
    params = JL.LlamaParams(tok_embd=embd, layers=layers, out_norm=nrm(),
                            output=rq(V, D))
    return cfg, j_fuse(params, cfg)


def carry_across(cfg, params):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    layers = [{f.name: (qt_dict(v) if hasattr(v, "kind") else np32(v))
               for f in dataclasses.fields(l) for v in [getattr(l, f.name)]}
              for l in params.layers]
    tree = {"tok_embd": np32(params.tok_embd), "out_norm": np32(params.out_norm),
            "output": qt_dict(params.output), "layers": layers}
    return params_from_numpy(fields, tree, device="cpu")


def close(got, want, rel=2e-2):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_carry_across_config_and_layout():
    jcfg, jp = jax_model()
    tcfg, tp = carry_across(jcfg, jp)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.head_dim) == (NL, D, 128)
    l0 = tp.layers[0]
    assert l0.wqkv is not None and l0.w_gate_up.il and l0.wq is None
    assert l0.wqkv.shape == (512, D) and l0.w_gate_up.shape == (2 * DFF, D)
    st = TL.stack_layers(tp)
    assert st.layers.wqkv.qs.shape == (NL, D // 2, 512)
    assert TQ.moe_fusable(st.layers.w_gate_up, st.layers.w_down, D, DFF)


@pytest.mark.parametrize("t", [16, 32])
def test_prefill_then_decode_matches_jax(pallas_kernels, t):
    jcfg, jp = jax_model(seed=t)
    tcfg, tp = carry_across(jcfg, jp)
    jst, tst = JL.stack_layers(jp), TL.stack_layers(tp)
    toks = np.random.default_rng(t).integers(3, V, (1, t + 8)).astype(np.int32)
    jc = JL.init_cache(jcfg, 1, MAX_LEN)
    tc = TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    jlg, jc = j_forward(jst, jcfg, jnp.asarray(toks[:, :t]),
                        jnp.zeros((1,), jnp.int32), jc, fresh_prefill=True)
    tlg, tc = TL.forward(tst, tcfg, torch.from_numpy(toks[:, :t]),
                         torch.zeros(1, dtype=torch.int32), tc, fresh_prefill=True)
    errs = [close(tlg.numpy(), jlg)]
    for i in range(t, t + 8):          # teacher-forced decode steps
        tok = toks[:, i:i + 1]
        jlg, jc = j_forward(jst, jcfg, jnp.asarray(tok), jnp.asarray([i], jnp.int32),
                            jc, attn_len=MAX_LEN)
        tlg, tc = TL.forward(tst, tcfg, torch.from_numpy(tok),
                             torch.tensor([i], dtype=torch.int32), tc,
                             attn_len=MAX_LEN)
        errs.append(close(tlg.numpy(), jlg))
        assert np.argmax(tlg.numpy()) == np.argmax(np.asarray(jlg))
    assert sum(e <= 1e-4 for e in errs) >= len(errs) // 2, errs
    close(tc.k.float().numpy()[:, :, :t + 8],
          np.asarray(jc.k.astype(jnp.float32))[:, :, :t + 8])


@pytest.mark.parametrize("quant", ["Q4_K", "Q8_0"])
def test_long_prefill_matches_jax(pallas_kernels, quant):
    """A 200-token prefill (qkv, o, gate|up and down on the dequant GEMM) and
    4 decode steps; for Q8_0 the lm head and every decode product run the
    q8b GEMV and the FFN takes the concatenated gate|up."""
    jcfg, jp = jax_model(seed=7, quant=quant)
    tcfg, tp = carry_across(jcfg, jp)
    jst, tst = JL.stack_layers(jp), TL.stack_layers(tp)
    assert tst.layers.w_gate_up.il == (quant == "Q4_K")
    t = 200
    toks = np.random.default_rng(t).integers(3, V, (1, t + 4)).astype(np.int32)
    jc, tc = JL.init_cache(jcfg, 1, MAX_LEN), TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    last = np.asarray([t - 1], np.int32)
    jlg, jc = j_forward(jst, jcfg, jnp.asarray(toks[:, :t]), jnp.zeros((1,), jnp.int32),
                        jc, fresh_prefill=True, last_idx=jnp.asarray(last))
    tlg, tc = TL.forward(tst, tcfg, torch.from_numpy(toks[:, :t]),
                         torch.zeros(1, dtype=torch.int32), tc, fresh_prefill=True,
                         last_idx=torch.from_numpy(last))
    errs = [close(tlg.numpy(), jlg)]
    assert np.argmax(tlg.numpy()) == np.argmax(np.asarray(jlg))
    for i in range(t, t + 4):
        tok = toks[:, i:i + 1]
        jlg, jc = j_forward(jst, jcfg, jnp.asarray(tok), jnp.asarray([i], jnp.int32),
                            jc, attn_len=MAX_LEN)
        tlg, tc = TL.forward(tst, tcfg, torch.from_numpy(tok),
                             torch.tensor([i], dtype=torch.int32), tc, attn_len=MAX_LEN)
        errs.append(close(tlg.numpy(), jlg))
        assert np.argmax(tlg.numpy()) == np.argmax(np.asarray(jlg))
    assert sum(e <= 1e-4 for e in errs) >= len(errs) // 2, errs
    close(tc.k.float().numpy()[:, :, :t + 4],
          np.asarray(jc.k.astype(jnp.float32))[:, :, :t + 4])


def test_second_prefill_chunk_matches_jax(pallas_kernels):
    """A prefill that starts at pos 16 attends to the cache (einsum path)."""
    jcfg, jp = jax_model(seed=3)
    tcfg, tp = carry_across(jcfg, jp)
    jst, tst = JL.stack_layers(jp), TL.stack_layers(tp)
    toks = np.random.default_rng(3).integers(3, V, (1, 32)).astype(np.int32)
    jc, tc = JL.init_cache(jcfg, 1, MAX_LEN), TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    for p0, fresh in ((0, True), (16, False)):
        jlg, jc = j_forward(jst, jcfg, jnp.asarray(toks[:, p0:p0 + 16]),
                            jnp.asarray([p0], jnp.int32), jc, fresh_prefill=fresh)
        tlg, tc = TL.forward(tst, tcfg, torch.from_numpy(toks[:, p0:p0 + 16]),
                             torch.tensor([p0], dtype=torch.int32), tc,
                             fresh_prefill=fresh)
        close(tlg.numpy(), jlg)


def test_forward_rejects_unstacked_layers():
    """Unstacked layers are no longer refused: they run the unrolled path.
    A 16-token prefill takes the same products on both layouts (equal
    logits); a decode step runs the fused FFN when stacked and the three
    products unrolled, within the fused FFN's 2e-3 (one requantized code)."""
    jcfg, jp = jax_model()
    tcfg, tp = carry_across(jcfg, jp)
    st = TL.stack_layers(tp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(3, V, (1, 17)))
    out = []
    for p in (tp, st):
        c = TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        lg0, _ = TL.forward(p, tcfg, toks[:, :16], torch.zeros(1, dtype=torch.int32),
                            c, fresh_prefill=True)
        lg1, _ = TL.forward(p, tcfg, toks[:, 16:], torch.tensor([16], dtype=torch.int32),
                            c, attn_len=MAX_LEN)
        out.append((lg0, lg1))
    assert torch.equal(out[0][0], out[1][0])
    close(out[0][1].numpy(), out[1][1].numpy(), 2e-3)
