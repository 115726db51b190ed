"""The int8 prefill (LLAMAFILE_TPU_I8P=1) of the port against the JAX
package's, on the CPU.

- The companion (ops.repack.attach_int8_prefill) from the same GGUF blocks
  in Q4_K, Q5_K (codes with a bias), Q6_K (g 16) and Q8_0: the port's qs8
  [Ns, K] is the transpose of the reference's jitted [K, Ns] byte for byte,
  and s8 is bit-identical; the pass-through cases return the tensor itself
  in both packages.
- i8p_prep's codes and scales are bit-identical to the reference's _i8p_prep.
- qmatmul on an I8PQTensor, unrolled and stacked (layer 1 of 3), against
  the reference's kernel in interpret mode: the same int32 block dots and
  f32 block updates in the same order, from activations normed in another
  f32 order; held within 1e-6 of the largest output (measured: 2.3e-7).
  M = 1 and M <= 32 keep the base path, bit for bit.
- stack_layers keeps the companions (dense and tiny-MoE layers), and
  convert.params_from_numpy carries the JAX package's across, per layer or
  stacked, equal to the ones the port builds from the same file.
- Whole models, with LLAMAFILE_TPU_I8P=1 for both packages: the tiny Q4_K
  GGUF of tests/test_int8_prefill.py (d 512, 4 heads, d_ff 512, 2 layers;
  stacked) through a 64-token prefill, and a Q4_K_M file (tests/
  test_torch_q4km.py: d 256, d_ff 1024, 4 layers with Q6_K V and down in
  layers 2-3; unrolled, so q8b g16 companions), logits within 1e-4 of the
  largest (measured: 2.2e-7; every product's activations come from the same
  arithmetic, and one i8p code a step off on a rounding boundary would move
  a logit by about 1e-3). The JAX forward runs op by op (jax.disable_jit):
  under jit XLA fuses and reorders its f32 elementwise work, which moves the
  reference's own logits on the Q4_K_M file by 0.9% (without companions)
  and 1.8% (with) against its op-by-op run. The Engine's 16 greedy ids
  equal (a prompt of 45 tokens: bucket 64, every prefill product on the i8p
  path), the JAX Engine jitted, with its Pallas kernels in interpret mode,
  attention included (the monkeypatch of tests/test_flash_write.py).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.ops import qmatmul as JQM
from llamafile_tpu.ops import repack as JR
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.models.synthetic import make_synthetic_llama
from llamafile_tpu_torch.ops import qmatmul as TQM
from llamafile_tpu_torch.ops import repack as TR
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from tests.test_torch_q4km import make_q4_k_m_gguf
from tests.util_models import make_tiny_llama_gguf

TOL = 1e-6               # a product, of its largest output
LOGIT_TOL = 1e-4         # a whole model, of its largest logit
MAX_LEN = 512
PROMPT = "the int8 prefill runs on the companion weights"      # 45 tokens + BOS


def _raw(quant, n, k, seed):
    arr = (np.random.default_rng(seed).standard_normal((n, k)) * 0.08).astype(np.float32)
    if quant == "F16":
        return arr.astype(np.float16).reshape(-1).view(np.uint8)
    return JQ.TYPE_BY_NAME[quant].quantize(arr.reshape(-1))


@functools.lru_cache(maxsize=None)
def _pair(quant, n, k, seed=0):
    """The same GGUF blocks repacked by both packages: (JAX QTensor, port's).
    Cached: the cases of a shape share their (read-only) weights."""
    raw = _raw(quant, n, k, seed)
    return JR.repack(raw, quant, (n, k)), TR.repack(raw, quant, (n, k), device="cpu")


@pytest.mark.parametrize("quant", ["Q4_K", "Q5_K", "Q6_K", "Q8_0"])
def test_companion_identical_to_jax(quant):
    jq, tq = _pair(quant, 700, 2304)
    ja, ta = JR.attach_int8_prefill(jq), TR.attach_int8_prefill(tq)
    assert isinstance(ta, TR.I8PQTensor) and ta.qs is tq.qs and ta.scales is tq.scales
    assert (ta.kind, ta.g, ta.bias is None) == (ja.kind, ja.g, ja.bias is None)
    np.testing.assert_array_equal(ta.qs8.t().numpy(), np.asarray(ja.qs8))
    np.testing.assert_array_equal(ta.s8.numpy().view(np.uint32),
                                  np.asarray(ja.s8).view(np.uint32))
    assert ta.to("cpu").qs8 is not None


def test_companion_pass_through():
    cases = [_pair("F16", 300, 512), _pair("Q8_0", 300, 544)]     # dense; K % 256
    jq, tq = _pair("Q4_K", 300, 512)
    cases.append((JR.attach_int8_prefill(jq), TR.attach_int8_prefill(tq)))   # attached
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), jq, jq)
    cases.append((jst, TL._stack_leaf([tq, tq])))                          # stacked
    for j, t in cases:
        assert JR.attach_int8_prefill(j) is j and TR.attach_int8_prefill(t) is t


def test_i8p_prep_bitwise():
    x = np.random.default_rng(4).standard_normal((70, 768)).astype(np.float32) * 3
    x[5] = 0.0                                           # amax 0: the 1e-12 floor
    x[6, :256] = np.arange(256) - 127.5                  # halves on the code grid
    jq, js, _, _ = JQM._i8p_prep(jnp.asarray(x))
    tq, ts = TQM.i8p_prep(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq)[:70])
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).T[:70].view(np.uint32))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "stacked"])
@pytest.mark.parametrize("k", [512, 2304])
@pytest.mark.parametrize("m", [33, 64, 300])
def test_qmatmul_i8p_matches_jax(m, k, stacked):
    """Logical N 1500 of Ns 2048 (the output sliced), a Q4_K weight; the
    stacked form on layer 1 of 3."""
    pairs = [_pair("Q4_K", 1500, k, seed) for seed in range(3 if stacked else 1)]
    jts = [JR.attach_int8_prefill(j) for j, _ in pairs]
    tts = [TR.attach_int8_prefill(t) for _, t in pairs]
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    nrm = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    jpn, tpn = (jnp.asarray(nrm), 1e-5), (torch.from_numpy(nrm), 1e-5)
    if stacked:
        jst = jax.tree.map(lambda *xs: jnp.stack(xs), *jts)
        want = JQM.qmatmul(jnp.asarray(x), jst, 1, prenorm=jpn)
        tst = TL._stack_leaf(tts)
        assert tst.qs8.shape == (3, 2048, k) and tst.s8.shape == (3, k // 256, 2048)
        got = TQM.qmatmul(torch.from_numpy(x), tst, 1, prenorm=tpn)
    else:
        want = JQM.qmatmul(jnp.asarray(x), jts[0], prenorm=jpn)
        got = TQM.qmatmul(torch.from_numpy(x), tts[0], prenorm=tpn)
    assert got.shape == (m, 1500) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL


# (M, Ns, n tile) on 132 SMs: llama3-8b's products at the buckets of 128
# and 1024 tokens; the 64-wide tile where the 128-wide grid fills at most
# half the SMs
@pytest.mark.parametrize("m,ns,bn", [(128, 4096, 64), (128, 6144, 64), (33, 4096, 64),
                                     (128, 28672, 128), (512, 4096, 128), (1024, 4096, 128),
                                     (1024, 28672, 128), (300, 28672, 128)])
def test_i8p_tile_rule(m, ns, bn):
    """qmm_i8p's n tile by shape (the kernel's bits are the same at both)."""
    from llamafile_tpu_torch.ops.qmatmul import i8p_tile_n
    assert i8p_tile_n(m, ns, 132) == bn


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("quant", ["Q4_K", "Q6_K"])
def test_small_m_keeps_base_path(quant, m):
    _, tq = _pair(quant, 300, 512)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32))
    assert torch.equal(TQM.qmatmul(x, TR.attach_int8_prefill(tq)), TQM.qmatmul(x, tq))


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_stack_layers_keeps_companions(preset):
    cfg, params = make_synthetic_llama(preset, "Q4_K", seed=1, fuse=True, device="cpu")
    i8 = TL.int8_prefill_params(params)
    st = TL.stack_layers(i8)
    assert isinstance(st.layers, TL.LlamaLayer)
    fields = ["wqkv", "wo"] + (["w_gate_up", "w_down"] if preset == "tiny" else [])
    for f in fields:
        leaf = getattr(st.layers, f)
        assert isinstance(leaf, TR.I8PQTensor) and leaf.qs8.ndim == 3
        for li, layer in enumerate(i8.layers):
            assert torch.equal(leaf.qs8[li], getattr(layer, f).qs8)
            assert torch.equal(leaf.s8[li], getattr(layer, f).s8)
    if preset == "tiny-moe":
        assert not any(isinstance(q, TR.I8PQTensor) for q in st.layers.experts.values())
        assert not isinstance(st.layers.gate_inp, TR.I8PQTensor)
    assert not isinstance(st.output, TR.I8PQTensor)
    assert TL.int8_prefill_params(st) is st


def _interpreted(fn):
    """fn() with the JAX package's Pallas kernels in interpret mode."""
    mp = pytest.MonkeyPatch()
    orig = JA.pl.pallas_call
    mp.setattr(JA.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mp.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        return fn()
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.fixture(scope="module")
def gguf_tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("i8p") / "tiny-q4k-512.gguf")
    return make_tiny_llama_gguf(path, d_model=512, n_layers=2, n_heads=4, n_kv_heads=4,
                                d_ff=512, quant="Q4_K")


@pytest.fixture(scope="module")
def gguf_q4km(tmp_path_factory):
    return make_q4_k_m_gguf(str(tmp_path_factory.mktemp("i8p_q4km") / "q4_k_m.gguf"))


@pytest.mark.parametrize("which", ["gguf_tiny", "gguf_q4km"], ids=["stacked", "q4_k_m"])
def test_prefill_forward_matches_jax(request, which):
    path = request.getfixturevalue(which)
    jcfg, jp, _, _ = j_load_llama(path)
    tcfg, tp, _, _ = load_llama(path, device="cpu")
    jp, tp = JL.int8_prefill_params(jp), TL.int8_prefill_params(tp)
    if which == "gguf_tiny":
        jp, tp = JL.stack_layers(jp), TL.stack_layers(tp)
        assert isinstance(tp.layers, TL.LlamaLayer) and tp.layers.wqkv.qs8.ndim == 3
    else:
        assert isinstance(tp.layers, list) and tp.layers[2].w_down.g == 16
        assert isinstance(tp.layers[2].w_down, TR.I8PQTensor)
    toks = np.random.default_rng(3).integers(3, 250, size=(1, 64)).astype(np.int32)
    last = np.asarray([60], np.int32)
    with jax.disable_jit():
        want, _ = JL.forward(jp, jcfg, jnp.asarray(toks), jnp.zeros((1,), jnp.int32),
                             JL.init_cache(jcfg, 1, 64), fresh_prefill=True,
                             last_idx=jnp.asarray(last))
    got, _ = TL.forward(tp, tcfg, torch.from_numpy(toks), torch.zeros(1, dtype=torch.int32),
                        TL.init_cache(tcfg, 1, 64, device="cpu"), fresh_prefill=True,
                        last_idx=torch.from_numpy(last))
    assert _rel(got.numpy(), want) <= LOGIT_TOL


def _qt_dict(qt):
    f32 = lambda a: None if a is None else np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    d = {"kind": qt.kind, "shape": qt.shape, "g": qt.g, "qs": f32(qt.qs),
         "scales": f32(qt.scales), "bias": f32(qt.bias), "il": qt.il}
    if isinstance(qt, JR.I8PQTensor):
        d.update(qs8=np.asarray(qt.qs8), s8=np.asarray(qt.s8))
    return d


@pytest.mark.parametrize("stacked", [False, True], ids=["unrolled", "stacked"])
def test_convert_carries_companions(gguf_tiny, stacked):
    """params_from_numpy takes the JAX I8PQTensor leaves (per layer, or
    stacked with a leading L): the port's companion is then the one it
    builds itself from the same file."""
    import dataclasses
    from llamafile_tpu_torch.convert import params_from_numpy
    jcfg, jp, _, _ = j_load_llama(gguf_tiny)
    jp = JL.int8_prefill_params(jp)
    _, tp, _, _ = load_llama(gguf_tiny, device="cpu")
    tp = TL.int8_prefill_params(tp)
    if stacked:
        jp, tp = JL.stack_layers(jp), TL.stack_layers(tp)
    layer_dict = lambda l: {f.name: (_qt_dict(v) if hasattr(v, "kind") else None)
                            for f in dataclasses.fields(l) for v in [getattr(l, f.name)]}
    tree = {"tok_embd": np.zeros((1, 1), np.float32), "out_norm": np.zeros(1, np.float32),
            "output": _qt_dict(jp.output),
            "layers": layer_dict(jp.layers) if stacked else [layer_dict(l) for l in jp.layers]}
    _, cp = params_from_numpy({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)},
                              tree, device="cpu")
    pairs = ([(cp.layers, tp.layers)] if stacked else list(zip(cp.layers, tp.layers)))
    n = 0
    for cl, tl in pairs:
        for f in TL.I8P_FIELDS:
            c, t = getattr(cl, f), getattr(tl, f)
            if t is None:
                continue
            assert isinstance(c, TR.I8PQTensor) and c.qs8.is_contiguous()
            assert torch.equal(c.qs8, t.qs8) and torch.equal(c.s8.view(torch.int32),
                                                             t.s8.view(torch.int32))
            n += 1
    # fused qkv, o, gate|up and down in every (stacked) layer; not the head
    assert n == 4 * len(pairs) and not isinstance(cp.output, TR.I8PQTensor)


def test_engine_greedy_ids_match_jax(gguf_tiny, monkeypatch):
    monkeypatch.setenv("LLAMAFILE_TPU_I8P", "1")

    def run_jax():
        cfg, params, tok, _ = j_load_llama(gguf_tiny)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
        assert eng.params.layers.wqkv.qs8.ndim == 3
        return [t for t, _ in eng.generate(PROMPT, max_tokens=16,
                                           sampling=JSP(temperature=0.0), stop_on_eog=False)]
    want = _interpreted(run_jax)
    eng = load_engine(gguf_tiny, device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers.w_down, TR.I8PQTensor)
    assert len(eng.tokenizer.encode(PROMPT)) > 32
    ids = [t for t, _ in eng.generate(PROMPT, max_tokens=16, sampling=TSP(temperature=0.0),
                                      stop_on_eog=False)]
    assert ids == want
