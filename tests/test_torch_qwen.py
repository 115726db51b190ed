"""Qwen2 and Qwen3 through the port (models.llama's qwen branches), against
the JAX package, on the CPU: qwen2 here, qwen3 in tests/test_torch_qwen3.py,
which imports the shared tests and sets the `arch` fixture.

The GGUFs are written here with the JAX package's GGUFWriter, Q4_K layers
and a separate Q4_K head (a Q6_K head runs its M = 1 decode on int8
activations and its rows of a batched step on the bf16 dequant GEMM, in
both packages: about 0.5% apart, which flips near-tied greedy tokens
between a request served alone and beside others; the gemma files hold the
Q6_K head), norm weights near 1, rope base 1e6:
- qwen2: d 256, 6 query heads over 2 KV heads of head_dim 128 (H * D = 768
  is not d), d_ff 768 (not a multiple of 1024: gate|up concatenated, never
  the fused FFN), q/k/v biases at the scale of the products (std 1);
- qwen3: d 256, 4 query heads over 2 KV heads of head_dim 128, d_ff 1024
  (the interleaved gate|up and the fused FFN), per-head q/k norms of
  weights near QK_NORM = 0.5 (near 1, a bf16 decode step of four parted
  from the reference by 2.2% of the largest logit through int8 activation
  code flips; near 0.25, more);
two layers each. The port runs its kernels' plain versions here; the JAX
side runs its Pallas kernels in interpret mode, one interpreted run a layout
shared by the prefill and decode tests (tests/test_torch_gemma.py's
`_jax_side`, whose prompts these are). Held:
- LlamaConfig.from_gguf field by field, and the weights carried across by
  convert.params_from_numpy, the biases and q/k norms too;
- prefill in the 32- and 256-token buckets (flash_prefill on every layer at
  256 on both sides);
- decode stacked and unrolled over bf16 and int8 caches: logits within 2e-2
  of the largest, the decode route named on both sides. Each step starts
  both sides from the reference's cache of that step: the two sides' K/V
  rows part by rounding order (1e-7), which now and then flips a bf16
  rounding of a cached element or an int8 activation code, and the tiny
  random qwen3 (q/k norms, int8 activations at every product) amplifies
  one such flip to 1-3% of the logits within two layers, where the decode
  kernels agree to 1e-7 on the same cache;
- Engine and --cli greedy tokens on a 16-token answer;
- forward_paged_decode (the biases, the q/k norms) against the reference's;
- the batcher's and the HTTP server's requests against themselves served
  alone;
- qwen2moe and qwen3moe still raise by name (tests/test_torch_qwen3.py);
- flash_decode_write's plain version against the Pallas kernel where the
  new token's score tops the cached ones (here only).
"""
import concurrent.futures as cf

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from llamafile_tpu.gguf import GGUFWriter
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime import paged as JP
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch.convert import paged_from_numpy
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.kvcache import KVCache
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from llamafile_tpu_torch.server.http import Server
from llamafile_tpu_torch.testing import paged_case
from llamafile_tpu_torch.utils.flags import Flags
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_engine import _cli_text, _text_until_eos
from tests.test_torch_gemma import (NXT, PROMPTS, _complete, _jax_side,  # noqa: F401
                                    _one_torch_thread, _port_model, _PrefillRoutes, _tokens)
from tests.test_torch_gemma2 import _Routes
from tests.test_torch_llama import carry_across, close
from tests.test_torch_paged import jnp_of, np32
from tests.test_torch_q4km import _interpreted
from tests.test_torch_server import _start
from tests.util_models import byte_vocab

D, NL = 256, 2
ARCHS = {"qwen2": dict(h=6, hkv=2, dff=768), "qwen3": dict(h=4, hkv=2, dff=1024),
         "qwen2moe": dict(h=6, hkv=2, dff=768), "qwen3moe": dict(h=4, hkv=2, dff=1024)}
HD = 128
MAX_LEN = 256
TOL = 2e-2
QK_NORM = 0.5


def make_tiny_qwen_gguf(path, arch, quant="Q4_K", seed=None):
    a = ARCHS[arch]
    h, hkv, dff = a["h"], a["hkv"], a["dff"]
    rng = np.random.default_rng(a.get("seed", 0) if seed is None else seed)
    tokens, scores, token_type = byte_vocab()
    w = GGUFWriter(path)
    for key, val in (
            ("general.architecture", arch), ("general.name", f"tiny-{arch}"),
            (f"{arch}.block_count", NL), (f"{arch}.embedding_length", D),
            (f"{arch}.attention.head_count", h), (f"{arch}.attention.head_count_kv", hkv),
            (f"{arch}.attention.key_length", HD), (f"{arch}.attention.value_length", HD),
            (f"{arch}.feed_forward_length", dff), (f"{arch}.rope.freq_base", 1e6),
            (f"{arch}.attention.layer_norm_rms_epsilon", 1e-6),
            (f"{arch}.context_length", MAX_LEN), (f"{arch}.vocab_size", len(tokens)),
            ("tokenizer.ggml.model", "llama"), ("tokenizer.ggml.tokens", tokens),
            ("tokenizer.ggml.scores", scores),
            ("tokenizer.ggml.token_type", np.asarray(token_type, np.int32)),
            ("tokenizer.ggml.bos_token_id", 1), ("tokenizer.ggml.eos_token_id", 2),
            ("tokenizer.ggml.unknown_token_id", 0), ("tokenizer.ggml.add_bos_token", True)):
        w.add(key, val)

    def add(name, shape, q=quant, scale=0.08):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        w.add_tensor(name, shape, q, JQ.TYPE_BY_NAME[q].quantize(arr.reshape(-1)))

    def vec(name, n, mean, std):
        w.add_tensor_f32(name, (mean + std * rng.standard_normal(n)).astype(np.float32))

    add("token_embd.weight", (len(tokens), D), "Q6_K", 0.5)
    for i in range(NL):
        p = f"blk.{i}."
        vec(p + "attn_norm.weight", D, 1.0, 0.1)
        add(p + "attn_q.weight", (h * HD, D))
        add(p + "attn_k.weight", (hkv * HD, D))
        add(p + "attn_v.weight", (hkv * HD, D))
        add(p + "attn_output.weight", (D, h * HD))
        vec(p + "ffn_norm.weight", D, 1.0, 0.1)
        add(p + "ffn_gate.weight", (dff, D))
        add(p + "ffn_up.weight", (dff, D))
        add(p + "ffn_down.weight", (D, dff))
        if arch == "qwen2":
            # the products' outputs have a std near 1 here (0.08 * sqrt(256))
            for nm, n in (("attn_q", h * HD), ("attn_k", hkv * HD), ("attn_v", hkv * HD)):
                vec(p + nm + ".bias", n, 0.0, 1.0)
        else:
            vec(p + "attn_q_norm.weight", HD, QK_NORM, 0.1 * QK_NORM)
            vec(p + "attn_k_norm.weight", HD, QK_NORM, 0.1 * QK_NORM)
    vec("output_norm.weight", D, 1.0, 0.1)
    add("output.weight", (len(tokens), D))
    w.write()
    return path


@pytest.fixture(scope="module")
def arch():
    return "qwen2"


@pytest.fixture(scope="module")
def gguf(tmp_path_factory, arch):
    return make_tiny_qwen_gguf(str(tmp_path_factory.mktemp(arch) / f"tiny-{arch}-q4k.gguf"),
                               arch)


def test_qwen_config_matches_jax(gguf, arch):
    jcfg, _, _, _ = j_load_llama(gguf)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    for name in TL.CONFIG_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    a = ARCHS[arch]
    assert tcfg.rope_neox and tcfg.rope_theta == 1e6 and tcfg.rms_eps == np.float32(1e-6)
    assert (tcfg.attn_qkv_bias, tcfg.qk_norm) == (arch == "qwen2", arch == "qwen3")
    assert (tcfg.embd_scale, tcfg.ffn_gelu, tcfg.swa_window, tcfg.attn_scale) == (
        1.0, False, 0, 0.0)
    l0 = tp.layers[0]
    assert l0.wqkv.shape == ((a["h"] + 2 * a["hkv"]) * HD, D) and l0.wo.shape == (D, a["h"] * HD)
    assert l0.w_gate_up.il == (a["dff"] % 1024 == 0) and tp.output.kind == "q4b"
    if arch == "qwen2":
        assert (l0.bq.shape, l0.bk.shape, l0.bv.shape) == ((768,), (256,), (256,))
        assert l0.q_norm is None and l0.bq.dtype == torch.float32
    else:
        assert l0.bq is None and l0.q_norm.shape == l0.k_norm.shape == (HD,)


def test_qwen_carried_weights_equal_loaded(gguf, arch):
    """params_from_numpy takes the JAX config and leaves, the q/k/v biases
    and q/k norms too: the same config and tensors as the port's loader;
    stacking keeps the biases one row a layer."""
    jcfg, jp, _, _ = j_load_llama(gguf)
    ccfg, cp = carry_across(jcfg, jp)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    assert ccfg == tcfg
    vecs = ("attn_norm", "ffn_norm", "bq", "bk", "bv", "q_norm", "k_norm")
    for cl, tl in zip(cp.layers, tp.layers):
        for f in vecs:
            c, t = getattr(cl, f), getattr(tl, f)
            held = f in vecs[:2] or (f[0] == "b") == (arch == "qwen2")
            assert (c is not None) == (t is not None) == held, f
            assert c is None or torch.equal(c, t), f
        for f in ("wqkv", "w_gate_up", "w_down", "wo"):
            c, t = getattr(cl, f), getattr(tl, f)
            assert (c.kind, c.shape, c.il) == (t.kind, t.shape, t.il), f
            assert torch.equal(c.qs, t.qs) and torch.equal(c.scales, t.scales), f
    assert torch.equal(cp.output.qs, tp.output.qs)
    st = TL.stack_layers(tp).layers
    for f in (("bq", "bk", "bv") if arch == "qwen2" else ("q_norm", "k_norm")):
        assert torch.equal(getattr(st, f)[1], getattr(tp.layers[1], f)), f


@pytest.fixture(scope="module")
def jax_refs(gguf):
    """tests/test_torch_gemma.py's _jax_side by layout, each run once."""
    refs = {}

    def get(stacked):
        if stacked not in refs:
            refs[stacked] = _interpreted(lambda: _jax_side(gguf, stacked))
        return refs[stacked]
    return get


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unrolled"])
def test_qwen_prefill_matches_jax(gguf, stacked, jax_refs):
    tcfg, tp = _port_model(gguf, stacked)
    for bucket in (32, 256):
        toks, last = _tokens(bucket)
        want, j_routes = jax_refs(stacked)["prefill"][bucket]
        mp = pytest.MonkeyPatch()
        try:
            routes = _PrefillRoutes(mp, TL, TA._use_flash)
            tc = TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
            lg, _ = TL.forward(tp, tcfg, torch.from_numpy(toks),
                               torch.zeros(1, dtype=torch.int32), tc, fresh_prefill=True,
                               last_idx=torch.from_numpy(last))
        finally:
            mp.undo()
        route = "flash" if bucket >= 128 else "einsum"
        assert j_routes == [route] * (1 if stacked else NL), bucket
        assert routes.seen == [route] * NL, bucket
        close(lg[0, -1].numpy(), want, TOL)


# the decode attention each (stacked, kv) case takes, port and reference:
# the kernels on stacked layers; unrolled int8 layers the port's
# flash_decode where the reference's unrolled loop takes the einsum
ROUTES = {(True, "bf16"): ("flash_decode_write_stacked",) * 2,
          (False, "bf16"): ("flash_decode_write_stacked",) * 2,
          (True, "int8"): ("flash_decode", "flash_decode"),
          (False, "int8"): ("flash_decode", "attention")}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unrolled"])
def test_qwen_decode_matches_jax(gguf, stacked, kv, jax_refs):
    tcfg, tp = _port_model(gguf, stacked)
    n_prompt = len(PROMPTS[32])
    port_route, jax_route = ROUTES[(stacked, kv)]
    logits, j_calls, caches = jax_refs(stacked)["decode"][kv]
    want = logits[1:]                   # the decode steps' (logits[0]: the prefill's)
    assert j_calls[jax_route] > 0       # traced at least once on that route
    codes = torch.int8 if kv == "int8" else torch.bfloat16
    mp = pytest.MonkeyPatch()
    try:
        routes = _Routes(mp, TL, ["flash_decode_write_stacked", "flash_decode", "attention"])
        got = []
        for i, t in enumerate(NXT):
            tc = KVCache(*[None if a is None else torch.from_numpy(a).to(
                codes if n < 2 else torch.float32) for n, a in enumerate(caches[i])])
            lg, _ = TL.forward(tp, tcfg, torch.tensor([[t]]),
                               torch.tensor([n_prompt + i], dtype=torch.int32), tc,
                               attn_len=MAX_LEN)
            got.append(lg[0, -1].numpy())
    finally:
        mp.undo()
    assert routes.n == {**dict.fromkeys(routes.n, 0), port_route: NL * len(NXT)}
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


def test_qwen_engine_and_cli_match_jax(gguf):
    def run():
        cfg, params, tok, _ = j_load_llama(gguf)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
        eng.decode_chunk = 15     # the 15 decode tokens in one dispatch: one scan compiled
        return list(eng.generate("hello", max_tokens=16, sampling=JSP(temperature=0.0),
                                 stop_on_eog=False))
    want = _interpreted(run)
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers, TL.LlamaLayer)
    ids = [t for t, _ in eng.generate("hello", max_tokens=16,
                                      sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert len(ids) == 16 and ids == [t for t, _ in want]
    assert _cli_text(gguf, "hello", 16) == _text_until_eos(want)


j_paged_decode = jax.jit(JL.forward_paged_decode, static_argnames=("cfg",))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_qwen_paged_decode_matches_jax(gguf, arch, int8):
    """forward_paged_decode against the reference's, stacked: R = 3 rows at
    different positions, 4 teacher-forced steps over a pool seeded with
    random K/V; the biases (qwen2) and the q/k norms (qwen3) on the path."""
    jcfg, jp, _, _ = j_load_llama(gguf)
    tcfg, tp = carry_across(jcfg, jp)
    jst, tst = JL.stack_layers(jp), TL.stack_layers(tp)
    a = ARCHS[arch]
    ps, maxp = 16, 8
    g = torch.Generator().manual_seed(2)
    pos0 = [5, 40, 63]
    _, kp, vp, ks, vs, _, tables = paged_case(
        g, [p + 4 for p in pos0], a["h"], a["hkv"], HD, ps, maxp, n_layers=NL, int8=int8)
    tpool = paged_from_numpy(*[None if x is None else np32(x) for x in (kp, vp, ks, vs)],
                             device="cpu")
    jpool = JP.PagedKV(*[None if x is None else jnp_of(x) for x in (kp, vp, ks, vs)])
    toks = np.random.default_rng(4).integers(3, 250, (4, 3)).astype(np.int32)
    for i in range(4):
        pos = np.asarray(pos0, np.int32) + i
        jl, jpool = j_paged_decode(jst, jcfg, jnp.asarray(toks[i]), jnp.asarray(pos),
                                   jpool, jnp.asarray(tables.numpy()))
        tl, _ = TL.forward_paged_decode(tst, tcfg, torch.from_numpy(toks[i]),
                                        torch.from_numpy(pos), tpool, tables)
        close(tl.numpy(), jl, TOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))


def test_qwen_served_alone_and_beside_others(gguf):
    """Each request through the batcher (admission prefill, then the paged
    decode) gives the ids it gives served alone (greedy and seeded). The
    prompts share no first token: a request admitted beside others reuses
    the cached rows of a common prefix (their BOS), computed by another
    prefill (another bucket, or the int8 activations of 32 tokens or
    fewer), which part from its own by a bf16 step; the tiny qwen3
    amplifies that to 2% of the next logits (a 21- beside a 40-token
    prompt, both with BOS, drew other tokens). The prefix reuse itself is
    held in tests/test_torch_batcher.py."""
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    jobs = [(_prompt(20, 22)[1:], TSP(temperature=0.0), 8),
            (_prompt(21, 41)[1:], TSP(temperature=0.8, top_k=40, seed=3), 8),
            (_prompt(22, 6)[1:], TSP(temperature=0.0), 8)]
    b = TBatcher(eng, rows=3)
    try:
        together = _serve(b, jobs)
    finally:
        b.shutdown()
    for job, toks in zip(jobs, together):
        b = TBatcher(eng, rows=3)
        try:
            assert _serve(b, [job]) == [toks] and len(toks) == 8
        finally:
            b.shutdown()


def test_qwen_http_server_alone_and_together(gguf):
    """The port's HTTP server (the --server path, in process): two greedy
    completions sent at once give the texts each gives sent alone."""
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    srv = Server(Flags(model="tiny-qwen.gguf", slots=2, temp=0.0, device="cpu"), eng)
    base, loop = _start(srv)
    try:
        prompts = ["hello", "the quick brown fox"]
        with cf.ThreadPoolExecutor(2) as ex:
            together = list(ex.map(lambda p: _complete(base, p), prompts))
        alone = [_complete(base, p) for p in prompts]
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.shutdown()
    assert together == alone and all(alone)



@pytest.mark.parametrize("s_eff,pos", [(256, 20), (1024, 700), (2048, 1500)])
def test_fdw_plain_follows_the_reference_blocks(s_eff, pos):
    """flash_decode_write's plain version streams the cache rows in the
    reference kernel's blocks (512, or 256 where 512 does not divide s_eff)
    with p rounded to bf16 against the running max, and merges the f32 new
    token last: within 1e-5 of the Pallas kernel (interpret mode) where the
    new token's score tops every cached one, as q/k-normed heads make it
    (rounding p against the joint max parted by 1.0e-3 to 1.7e-3 there)."""
    import llamafile_tpu.ops.attention as JA
    rng = np.random.default_rng(s_eff)
    hq, hkv, d, nl = 4, 2, 128, 2
    k3, v3 = (np.asarray(jnp.asarray(rng.standard_normal((nl, 1, s_eff, hkv * d)),
                                     jnp.bfloat16).astype(jnp.float32)) for _ in range(2))
    kn = rng.standard_normal((1, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((1, hkv, d)).astype(np.float32)
    # each head's new-token score one above its best cached score
    q = rng.standard_normal((1, hq, d)).astype(np.float32)
    for h in range(hq):
        kh = kn[0, h // (hq // hkv)]
        best = (k3[1, 0, :pos].reshape(pos, hkv, d)[:, h // (hq // hkv)] @ q[0, h]).max()
        q[0, h] += (best + 1 / 0.088 - q[0, h] @ kh) / (kh @ kh) * kh
    p = np.asarray([pos], np.int32)
    want = _interpreted(lambda: np.asarray(JA.flash_decode_write_stacked(
        jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(1), jnp.asarray(p), 0.088, hkv=hkv)[0]))
    got = TA.flash_decode_write_stacked(
        torch.from_numpy(q), torch.from_numpy(k3).to(torch.bfloat16),
        torch.from_numpy(v3).to(torch.bfloat16), torch.from_numpy(kn), torch.from_numpy(vn), 1,
        torch.from_numpy(p), 0.088, hkv=hkv)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
