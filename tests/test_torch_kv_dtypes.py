"""--kv-dtype f16 and f32 through the port's Engine, batcher and decode
kernels' plain versions, against the JAX package, on the CPU.

The model is tests/util_models.make_tiny_llama_gguf with F32 weights (d 256,
2 query heads over 1 KV head of head_dim 128, d_ff 512, 2 layers): its
products are exact f32 on both sides, so what parts the two packages is the
attention alone. The JAX side runs its Pallas decode kernels in interpret
mode (the monkeypatch of tests/test_flash_write.py), as its CPU einsum
fallback has other numerics; its run of each dtype is shared by the tests
(jax_side). Tolerances:
- Engine.generate: equal greedy ids;
- the logits of the prefill and of three decode steps (the same tokens fed
  on both sides): within 1e-2 of the largest logit. The products round
  their activations to bf16 on both sides (the reference's jnp.dot of a
  dense weight), so an f32 ulp of a norm or rope parts an activation by a
  bf16 step: the prefill, before any cache is read, parts by 2.5e-3 of the
  largest logit and the decode steps by 2.3e-3 to 4.0e-3 (measured, f16 and
  f32 alike), above the 1e-3 that the cache's own numerics would keep;
- the paged batcher: equal greedy ids (both sides' paged decode is f32 over
  the same f16 or f32 pages);
- each decode kernel's plain version at f16 and f32 against the
  interpreted Pallas kernel, the written cache rows equal: f16 within 2e-2
  of the largest output (q and p rounded to f16 on both sides, in another
  order), f32 within 1e-5 (nothing rounded: only the order of the f32 sums
  differs), where a control, the plain version with q rounded to bf16,
  must part by more. paged_attention against the upstream kernel the
  reference calls within 2e-2 (it loads the pages as bf16 at any dtype),
  and within 1e-5, with the same control, against the reference's gather
  route, which computes in f32 on the pages' values as the port does.
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.models.llama as JL
import llamafile_tpu.ops.attention as JA
import llamafile_tpu.runtime.paged as JP
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu.server.batcher import Batcher as JBatcher
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.paged import init_paged
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from llamafile_tpu_torch.testing import paged_case
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_q4km import _interpreted, _one_torch_thread  # noqa: F401
from tests.util_models import make_tiny_llama_gguf

MAX_LEN = 256
PROMPT = "hello world"
N_NEW = 12
STEPS = 3                       # decode steps whose logits are held
DTYPES = {"f16": (jnp.float16, torch.float16), "f32": (jnp.float32, torch.float32)}
PLAIN_TOL = {"f16": 2e-2, "f32": 1e-5}      # of the largest output


def _held(kv, got, want, control=None):
    """got within PLAIN_TOL[kv] of want's largest |value|; at f32 the
    control (q rounded to bf16) must part by more."""
    got, want = np.asarray(got), np.asarray(want)
    lim = PLAIN_TOL[kv] * np.abs(want).max()
    assert np.abs(got - want).max() <= lim
    if kv == "f32":
        assert np.abs(np.asarray(control()) - want).max() > lim


def _bf16(x):
    return x.to(torch.bfloat16).float()


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kvdt") / "tiny-f32.gguf")
    return make_tiny_llama_gguf(path, quant="F32", d_model=256, d_ff=512, n_heads=2,
                                n_kv_heads=1, n_layers=2)


def _feed(ids, n):
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n] = ids
    return toks


@pytest.fixture(scope="module")
def jax_side(gguf):
    """{kv: (prompt ids, greedy ids of Engine.generate, logits [1 + STEPS, V]
    of the prefill and the decode steps fed those ids)}, interpreted once."""
    fwd = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))
    out = {}
    for kv in DTYPES:
        def run():
            cfg, params, tok, _ = j_load_llama(gguf)
            eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN, kv_dtype=kv)
            ids = [t for t, _ in eng.generate(PROMPT, max_tokens=N_NEW,
                                              sampling=JSP(temperature=0.0),
                                              stop_on_eog=False)]
            p_ids = tok.encode(PROMPT)
            n = len(p_ids)
            cache = JL.init_cache(cfg, 1, MAX_LEN, DTYPES[kv][0])
            lg, cache = fwd(eng.params, cfg, jnp.asarray(_feed(p_ids, n)),
                            jnp.zeros((1,), jnp.int32), cache, fresh_prefill=True,
                            last_idx=jnp.full((1,), n - 1, jnp.int32))
            logits = [np.asarray(lg[0, -1])]
            for i, t in enumerate(ids[:STEPS]):
                lg, cache = fwd(eng.params, cfg, jnp.full((1, 1), t, jnp.int32),
                                jnp.full((1,), n + i, jnp.int32), cache, attn_len=MAX_LEN)
                logits.append(np.asarray(lg[0, -1]))
            return p_ids, ids, np.stack(logits)
        out[kv] = _interpreted(run)
    return out


@pytest.fixture(scope="module")
def engines(gguf):
    return {kv: load_engine(gguf, device="cpu", max_seq_len=MAX_LEN, kv_dtype=kv)
            for kv in DTYPES}


@pytest.mark.parametrize("kv", list(DTYPES))
def test_engine_same_greedy_ids(jax_side, engines, kv):
    eng = engines[kv]
    assert eng.new_cache().k.dtype == DTYPES[kv][1]
    got = [t for t, _ in eng.generate(PROMPT, max_tokens=N_NEW,
                                      sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert got == jax_side[kv][1]


@pytest.mark.parametrize("kv", list(DTYPES))
def test_prefill_and_decode_logits(jax_side, engines, kv):
    """The prefill (fresh, the einsum below bucket 128) and three decode
    steps on the f16 or f32 cache (flash_decode_write's plain version),
    the reference's greedy tokens fed on both sides."""
    p_ids, ids, want = jax_side[kv]
    eng = engines[kv]
    n = len(p_ids)
    cache = eng.new_cache()
    lg, _ = TL.forward(eng.params, eng.cfg, torch.from_numpy(_feed(p_ids, n)),
                       torch.zeros(1, dtype=torch.int32), cache, fresh_prefill=True,
                       last_idx=torch.full((1,), n - 1, dtype=torch.int32))
    got = [lg[0, -1]]
    for i, t in enumerate(ids[:STEPS]):
        lg, _ = TL.forward(eng.params, eng.cfg, torch.full((1, 1), t, dtype=torch.int32),
                           torch.full((1,), n + i, dtype=torch.int32), cache,
                           attn_len=MAX_LEN)
        got.append(lg[0, -1])
    got = torch.stack(got).numpy()
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()


@pytest.mark.parametrize("kv", list(DTYPES))
def test_paged_batcher_same_greedy_ids(gguf, engines, kv):
    """Three rows on an f16 or f32 paged pool (admissions under bucket 128:
    both packages' einsum prefill), then the paged decode."""
    cfg, params, tok, _ = j_load_llama(gguf)
    jeng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN, kv_dtype=kv)
    prompts = [_prompt(s, n) for s, n in ((41, 9), (42, 30), (43, 50))]
    out = {}
    for name, eng, B, SP in (("jax", jeng, JBatcher, JSP), ("port", engines[kv], TBatcher, TSP)):
        b = B(eng, rows=3)
        try:
            if name == "port":
                assert b.pages.k_pages.dtype == DTYPES[kv][1]
            out[name] = _serve(b, [(p, SP(temperature=0.0), 6) for p in prompts])
        finally:
            b.shutdown()
    assert out["port"] == out["jax"] and all(len(t) == 6 for t in out["port"])


def _kv_case(seed, nl, b, s, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    k3, v3 = (jnp.asarray(rng.standard_normal((nl, b, s, hkv * d)), dtype) for _ in range(2))
    return rng, k3, v3


def _t(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 1, 256)])
def test_flash_decode_write_plain_matches_pallas(kv, hq, hkv, d):
    jdt, tdt = DTYPES[kv]
    rng, k3, v3 = _kv_case(hq + d, 3, 2, 512, hkv, d, jdt)
    q = rng.standard_normal((2, hq, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((2, hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray([37, 301], np.int32)

    def run():
        return JA.flash_decode_write_stacked(jnp.asarray(q), k3, v3, jnp.asarray(kn),
                                             jnp.asarray(vn), jnp.int32(1),
                                             jnp.asarray(pos), 0.088, hkv=hkv)
    want, jk3, jv3 = _interpreted(run)
    tk3, tv3 = _t(k3).to(tdt), _t(v3).to(tdt)
    fdw = lambda qq, a, b: TA.flash_decode_write_stacked(
        qq, a, b, torch.from_numpy(kn), torch.from_numpy(vn), 1, torch.from_numpy(pos), 0.088,
        hkv=hkv)
    got = fdw(torch.from_numpy(q), tk3, tv3)
    _held(kv, got, want, lambda: fdw(_bf16(torch.from_numpy(q)), _t(k3).to(tdt),
                                     _t(v3).to(tdt)))
    np.testing.assert_array_equal(tk3.float().numpy(), _t(jk3).numpy())
    np.testing.assert_array_equal(tv3.float().numpy(), _t(jv3).numpy())


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 1, 256)])
def test_flash_decode_plain_matches_pallas(kv, hq, hkv, d):
    jdt, tdt = DTYPES[kv]
    rng, k3, v3 = _kv_case(hq + d + 1, 3, 2, 512, hkv, d, jdt)
    q = rng.standard_normal((2, hq, d)).astype(np.float32)
    pos = np.asarray([5, 400], np.int32)

    def run():
        return JA.flash_decode_stacked(jnp.asarray(q), k3, v3, jnp.int32(1),
                                       jnp.asarray(pos), 0.088, hkv)
    want = np.asarray(_interpreted(run))
    fd = lambda qq: TA.flash_decode_stacked(qq, _t(k3).to(tdt), _t(v3).to(tdt), 1,
                                            torch.from_numpy(pos), 0.088, hkv)
    _held(kv, fd(torch.from_numpy(q)), want, lambda: fd(_bf16(torch.from_numpy(q))))


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 1, 256)])
def test_paged_attention_plain_matches_pallas(kv, hq, hkv, d):
    """The upstream paged kernel, interpreted, over f16 or f32 pages: it
    loads K and V as bf16 whatever the pages' dtype (its
    _maybe_dequantize), so it is held within 2e-2. The reference's gather
    route (paged_attend off the TPU) computes in f32 on the pages' own
    values, as the port's plain version and kernel do at both dtypes: held
    within 1e-5, where q rounded to bf16 must part by more."""
    _, tdt = DTYPES[kv]
    g = torch.Generator().manual_seed(hq + d)
    q, kp, vp, _, _, lens, tables = paged_case(g, [1, 63, 65, 200], hq, hkv, d, 16, 16,
                                               dtype=tdt)
    jnp_of = lambda a: jnp.asarray(a[0].float().numpy(), DTYPES[kv][0])

    def run():
        from jax.experimental.pallas.ops.tpu.paged_attention import paged_attention_kernel as K
        orig = K.pl.pallas_call
        mp = pytest.MonkeyPatch()
        mp.setattr(K.pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        try:
            return np.asarray(JP.paged_attend(jnp.asarray(q.numpy()), jnp_of(kp), jnp_of(vp),
                                              jnp.asarray(lens.numpy()),
                                              jnp.asarray(tables.numpy())))
        finally:
            mp.undo()
    want, gathered = _interpreted(run), run()
    pa = lambda qq: TA.paged_attention(qq, kp[0], vp[0], lens, tables)
    got = pa(q).numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    _held("f32", got, gathered, lambda: pa(_bf16(q)))


@pytest.mark.parametrize("kv", list(DTYPES))
def test_caches_and_pools_take_the_dtype(kv):
    _, tdt = DTYPES[kv]
    cache = TL.init_cache(TL.LlamaConfig(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
                                         d_ff=512, n_vocab=300, head_dim=128), 1, 64, kv,
                          device="cpu")
    assert cache.k.dtype == tdt and not cache.quantized
    pool = init_paged(2, 1, 5, 16, 128, dtype=kv, device="cpu")
    assert pool.k_pages.dtype == tdt and not pool.quantized
    with pytest.raises(ValueError):
        init_paged(2, 1, 5, 16, 128, dtype="f8", device="cpu")
