"""Gemma 1 and Gemma 3 through the port (models.llama's gemma and gemma3
branches), against the JAX package, on the CPU: gemma here, gemma3 in
tests/test_torch_gemma3.py, which imports the shared tests and sets the
`arch` fixture.

The GGUFs are written here with the JAX package's GGUFWriter, Q4_K layers
and the head tied to a Q6_K token_embd, norm weights near 1:
- gemma: d 256, 2 query heads over 2 KV heads of head_dim 256 (H * D = 512
  is not d), d_ff 1024, 2 layers;
- gemma3: d 256, 2 query heads over 1 KV head of head_dim 128, d_ff 1024, 6
  layers (layer 5 global, 0-4 windowed at 8), per-head q/k norms, a rope
  base of 1e6 with a linear factor of 8 on the global layer and 10000 on
  the windowed ones.
The port runs its kernels' plain versions here; the JAX side runs its
Pallas kernels in interpret mode (the monkeypatch of
tests/test_flash_write.py). Compiling the JAX side takes nearly all of the
time, so the prefill and decode tests share one interpreted run a layout
(the `jax_refs` fixture), the 32-token bucket's prompt being the decode
test's too. Held:
- LlamaConfig.from_gguf field by field (also the 62-layer query scale of
  Gemma-3-27B from metadata alone), the weights carried across by
  convert.params_from_numpy, the q/k norms too;
- prefill in the 32- and 256-token buckets with the route of each layer's
  prefill attention named on both sides: at bucket 256 the port sends the
  global gemma3 layer to the flash_prefill kernel (its plain version here),
  as the reference's unrolled loop does, where the reference's layer scan
  sends it to the einsum (its traced window is never None): the same
  function;
- decode past the window, stacked and unrolled, bf16 and int8 caches:
  logits within 2e-2 of the largest, the decode route named on both sides;
- Engine and --cli greedy tokens on a 16-token answer;
- gemma's paged decode (forward_paged_decode) against the reference's,
  which multiplies the embedding by sqrt(d) (the port did not: ROADMAP
  C.9); its batcher's and HTTP server's requests against themselves served
  alone;
- (tests/test_torch_gemma3.py) a gemma3 engine under the batcher raises
  NotImplementedError, and the paged decode refuses qk_norm by name.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.gguf import GGUFReader as JReader
from llamafile_tpu.gguf import GGUFWriter
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime import paged as JP
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch.convert import paged_from_numpy
from llamafile_tpu_torch.gguf.reader import GGUFReader as TReader
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from llamafile_tpu_torch.server.http import Server
from llamafile_tpu_torch.testing import paged_case
from llamafile_tpu_torch.utils.flags import Flags
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_engine import _cli_text, _text_until_eos
from tests.test_torch_gemma2 import _Routes
from tests.test_torch_llama import carry_across, close
from tests.test_torch_paged import jnp_of, np32
from tests.test_torch_q4km import _interpreted
from tests.test_torch_server import _start
from tests.util_models import byte_vocab

D, DFF, WIN = 256, 1024, 8
ARCHS = {"gemma": dict(n_layers=2, h=2, hkv=2, hd=256),
         "gemma3": dict(n_layers=6, h=2, hkv=1, hd=128)}
MAX_LEN = 256
TOL = 2e-2


def make_tiny_gemma_gguf(path, arch, quant="Q4_K", seed=0):
    a = ARCHS[arch]
    nl, h, hkv, hd = a["n_layers"], a["h"], a["hkv"], a["hd"]
    rng = np.random.default_rng(seed)
    tokens, scores, token_type = byte_vocab()
    w = GGUFWriter(path)
    meta = [("general.architecture", arch), ("general.name", f"tiny-{arch}"),
            (f"{arch}.block_count", nl), (f"{arch}.embedding_length", D),
            (f"{arch}.attention.head_count", h), (f"{arch}.attention.head_count_kv", hkv),
            (f"{arch}.attention.key_length", hd), (f"{arch}.attention.value_length", hd),
            (f"{arch}.feed_forward_length", DFF),
            (f"{arch}.attention.layer_norm_rms_epsilon", 1e-6),
            (f"{arch}.context_length", MAX_LEN), (f"{arch}.vocab_size", len(tokens)),
            ("tokenizer.ggml.model", "llama"), ("tokenizer.ggml.tokens", tokens),
            ("tokenizer.ggml.scores", scores),
            ("tokenizer.ggml.token_type", np.asarray(token_type, np.int32)),
            ("tokenizer.ggml.bos_token_id", 1), ("tokenizer.ggml.eos_token_id", 2),
            ("tokenizer.ggml.unknown_token_id", 0), ("tokenizer.ggml.add_bos_token", True)]
    if arch == "gemma3":
        meta += [(f"{arch}.attention.sliding_window", WIN), (f"{arch}.rope.freq_base", 1e6),
                 (f"{arch}.rope.scaling.type", "linear"), (f"{arch}.rope.scaling.factor", 8.0)]
    for key, val in meta:
        w.add(key, val)

    def add(name, shape, q=quant, scale=0.08):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        w.add_tensor(name, shape, q, JQ.TYPE_BY_NAME[q].quantize(arr.reshape(-1)))

    def norm(name, n=D):
        w.add_tensor_f32(name, (1 + 0.1 * rng.standard_normal(n)).astype(np.float32))

    add("token_embd.weight", (len(tokens), D), "Q6_K", 0.5)
    for i in range(nl):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight")
        add(p + "attn_q.weight", (h * hd, D))
        add(p + "attn_k.weight", (hkv * hd, D))
        add(p + "attn_v.weight", (hkv * hd, D))
        add(p + "attn_output.weight", (D, h * hd))
        norm(p + "ffn_norm.weight")
        add(p + "ffn_gate.weight", (DFF, D))
        add(p + "ffn_up.weight", (DFF, D))
        add(p + "ffn_down.weight", (D, DFF))
        if arch == "gemma3":
            norm(p + "attn_q_norm.weight", hd)
            norm(p + "attn_k_norm.weight", hd)
            norm(p + "post_attention_norm.weight")
            norm(p + "post_ffw_norm.weight")
    norm("output_norm.weight")
    w.write()
    return path


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work (and its CLI runs) on one thread: with
    pytest-xdist workers on every core, torch's default team of a thread a
    core spins against them (a 16-token Engine run took 32 s instead of
    under 1 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arch():
    return "gemma"


@pytest.fixture(scope="module")
def gguf(tmp_path_factory, arch):
    return make_tiny_gemma_gguf(str(tmp_path_factory.mktemp(arch) / f"tiny-{arch}-q4k.gguf"),
                                arch)


def test_config_matches_jax(gguf, arch):
    jcfg, _, _, _ = j_load_llama(gguf)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    for name in TL.CONFIG_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.rope_neox and tcfg.ffn_gelu and tcfg.embd_scale == D ** 0.5
    assert tcfg.attn_softcap == tcfg.final_softcap == 0.0
    assert tp.output.kind == "q8b"
    if arch == "gemma":
        assert (tcfg.swa_window, tcfg.post_norms, tcfg.qk_norm, tcfg.attn_scale) == (
            0, False, False, 0.0)
        assert tp.layers[0].wqkv.shape == (3 * 512, D) and tp.layers[0].wo.shape == (D, 512)
    else:
        assert (tcfg.swa_window, tcfg.swa_pattern, tcfg.swa_rope_theta) == (WIN, 6, 10000.0)
        assert (tcfg.rope_theta, tcfg.rope_scale) == (1e6, 1 / 8)
        assert tcfg.post_norms and tcfg.qk_norm and tcfg.attn_scale == 1 / 128 ** 0.5
        assert [TL.layer_window(tcfg, li) for li in range(6)] == [WIN] * 5 + [None]
        assert tp.layers[0].q_norm.shape == tp.layers[0].k_norm.shape == (128,)


@pytest.mark.parametrize("arch,n_layers,scale", [
    ("gemma3", 62, 1 / 168 ** 0.5), ("gemma3", 34, 1 / 128 ** 0.5), ("gemma", 28, 0.0)],
    ids=["gemma3-62", "gemma3-34", "gemma-28"])
def test_query_scale_from_metadata(tmp_path, arch, n_layers, scale):
    """Gemma-3-27B's widths from metadata alone: at 62 layers q is scaled
    by (d / h)^-1/2 = 168^-1/2 (d 5376 over 32 heads of head_dim 128), at
    any other depth by 1 / sqrt(head_dim); gemma's attn_scale stays 0 (1 /
    sqrt(head_dim)) whatever {arch}.attention.scale says."""
    path = str(tmp_path / f"{arch}-meta.gguf")
    w = GGUFWriter(path)
    for key, val in (("general.architecture", arch), (f"{arch}.block_count", n_layers),
                     (f"{arch}.embedding_length", 5376), (f"{arch}.attention.head_count", 32),
                     (f"{arch}.attention.head_count_kv", 16),
                     (f"{arch}.attention.key_length", 128),
                     (f"{arch}.feed_forward_length", 21504),
                     (f"{arch}.vocab_size", 262144), (f"{arch}.attention.scale", 0.5)):
        w.add(key, val)
    w.write()
    jcfg = JL.LlamaConfig.from_gguf(JReader(path))
    tcfg = TL.LlamaConfig.from_gguf(TReader(path))
    for name in TL.CONFIG_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.attn_scale == scale
    assert tcfg.swa_window == (1024 if arch == "gemma3" else 0)


def test_carried_weights_equal_loaded(gguf, arch):
    """params_from_numpy takes the JAX config and leaves, the q/k and post
    norms too: the same config and tensors as the port's own loader."""
    jcfg, jp, _, _ = j_load_llama(gguf)
    ccfg, cp = carry_across(jcfg, jp)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    assert ccfg == tcfg
    norms = ("attn_norm", "ffn_norm", "attn_post_norm", "ffn_post_norm", "q_norm", "k_norm")
    for cl, tl in zip(cp.layers, tp.layers):
        for f in norms:
            c, t = getattr(cl, f), getattr(tl, f)
            assert (c is None) == (t is None) == (arch == "gemma" and f not in norms[:2]), f
            assert c is None or torch.equal(c, t), f
        for f in ("wqkv", "w_gate_up", "w_down", "wo"):
            c, t = getattr(cl, f), getattr(tl, f)
            assert (c.kind, c.shape, c.il) == (t.kind, t.shape, t.il), f
            assert torch.equal(c.qs, t.qs) and torch.equal(c.scales, t.scales), f
    assert torch.equal(cp.output.qs, tp.output.qs)


class _PrefillRoutes:
    """The route of each flash_prefill call of one side, by the rule both
    packages share: "flash" (the kernel) or "einsum"."""

    def __init__(self, mp, mod, use_flash):
        self.seen = []
        fn = mod.flash_prefill

        def spy(q, k, v, scale, window=None, softcap=0.0):
            t, d = q.shape[1], q.shape[3]
            self.seen.append("flash" if window is None and not softcap and use_flash(t, d)
                             else "einsum")
            return fn(q, k, v, scale, window=window, softcap=softcap)
        mp.setattr(mod, "flash_prefill", spy)


def _port_model(path, stacked):
    tcfg, tp, _, _ = load_llama(path, device="cpu")
    if stacked:
        tp = TL.stack_layers(tp)
    assert isinstance(tp.layers, TL.LlamaLayer) == stacked
    return tcfg, tp


def _prefill_routes(arch, stacked, side, bucket):
    """The routes each side takes at a bucket: every layer's (the reference's
    scan traces its body once, a traced window on every layer)."""
    n = ARCHS[arch]["n_layers"]
    if bucket < 128:
        return ["einsum"] * (1 if side == "jax" and stacked else n)
    if arch == "gemma":
        return ["flash"] * (1 if side == "jax" and stacked else n)
    if side == "jax" and stacked:
        return ["einsum"]
    return ["einsum"] * 5 + ["flash"]


# the prompts of the prefill test, by bucket (the 32-token bucket's is also
# the decode test's), and the decode test's teacher-forced tokens
PROMPTS = dict(zip((32, 256), (lambda r: (r.integers(3, 250, 20), r.integers(3, 250, 200)))(
    np.random.default_rng(7))))
NXT = [66, 67, 68, 69]
DECODE_ROUTES = {"JA": ("flash_decode_write_stacked", "flash_decode"), "JL": ("attention",)}


def _tokens(bucket):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(PROMPTS[bucket])] = PROMPTS[bucket]
    return toks, np.asarray([len(PROMPTS[bucket]) - 1], np.int32)


def _jax_side(path, stacked):
    """The reference's side of the prefill and decode tests for one layout,
    run in one interpreted context with one jitted forward, so that the bf16
    prefill in the 32-token bucket is compiled once for both: the last
    logits and the flash_prefill routes at each bucket; for each cache
    dtype, the logits of that prefill and of NXT's decode steps, the
    decode attention calls traced by name, and the cache (numpy) before
    each decode step (tests/test_torch_qwen.py starts the port's steps
    from it)."""
    jcfg, jp, _, _ = j_load_llama(path)
    if stacked:
        jp = JL.stack_layers(jp)
    fwd = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))
    mp = pytest.MonkeyPatch()
    try:
        pre = _PrefillRoutes(mp, JA, JA._use_flash)
        dec = {mod: _Routes(mp, {"JA": JA, "JL": JL}[mod], names)
               for mod, names in DECODE_ROUTES.items()}
        traced = lambda: {k: v for r in dec.values() for k, v in r.n.items()}

        def prefill(bucket, dtype):
            toks, last = _tokens(bucket)
            seen = len(pre.seen)
            lg, jc = fwd(jp, jcfg, jnp.asarray(toks), jnp.zeros((1,), jnp.int32),
                         JL.init_cache(jcfg, 1, MAX_LEN, dtype), fresh_prefill=True,
                         last_idx=jnp.asarray(last))
            return np.asarray(lg[0, -1]), pre.seen[seen:], jc

        out = {"prefill": {}, "decode": {}}
        for kv, dtype in (("bf16", jnp.bfloat16), ("int8", jnp.int8)):
            lg, routes, jc = prefill(32, dtype)
            if kv == "bf16":
                out["prefill"][32] = lg, routes
                out["prefill"][256] = prefill(256, dtype)[:2]
            n_prompt, logits, caches, n0 = len(PROMPTS[32]), [lg], [], traced()
            for i, t in enumerate(NXT):
                caches.append([None if a is None else np.array(a.astype(jnp.float32) if
                                                             a.dtype == jnp.bfloat16 else a)
                               for a in (jc.k, jc.v, jc.k_scale, jc.v_scale)])
                lg, jc = fwd(jp, jcfg, jnp.asarray([[t]], jnp.int32),
                             jnp.asarray([n_prompt + i], jnp.int32), jc, attn_len=MAX_LEN)
                logits.append(np.asarray(lg[0, -1]))
            out["decode"][kv] = (logits, {k: v - n0[k] for k, v in traced().items()},
                                 caches)
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_refs(gguf):
    """_jax_side by layout, each run once for the module."""
    refs = {}

    def get(stacked):
        if stacked not in refs:
            refs[stacked] = _interpreted(lambda: _jax_side(gguf, stacked))
        return refs[stacked]
    return get


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unrolled"])
def test_prefill_matches_jax(gguf, arch, stacked, jax_refs):
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
        assert j_routes == _prefill_routes(arch, stacked, "jax", bucket), bucket
        assert routes.seen == _prefill_routes(arch, stacked, "port", bucket), bucket
        close(lg[0, -1].numpy(), want, TOL)


# the decode attention each (arch, stacked, kv) case takes, port and
# reference: gemma3's as gemma2's (a windowed model's stacked int8 layers
# on the einsum in both), gemma's the kernels on stacked layers; unrolled
# int8 layers the port's flash_decode (with the window on gemma3's) where
# the reference's unrolled loop takes the einsum: the same function
ROUTES = {("gemma3", True, "bf16"): ("flash_decode_write_stacked",) * 2,
          ("gemma3", False, "bf16"): ("flash_decode_write_stacked",) * 2,
          ("gemma3", True, "int8"): ("attention", "attention"),
          ("gemma3", False, "int8"): ("flash_decode", "attention"),
          ("gemma", True, "bf16"): ("flash_decode_write_stacked",) * 2,
          ("gemma", False, "bf16"): ("flash_decode_write_stacked",) * 2,
          ("gemma", True, "int8"): ("flash_decode", "flash_decode"),
          ("gemma", False, "int8"): ("flash_decode", "attention")}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unrolled"])
def test_decode_past_window_matches_jax(gguf, arch, stacked, kv, jax_refs):
    tcfg, tp = _port_model(gguf, stacked)
    nl, n_prompt = tcfg.n_layers, len(PROMPTS[32])
    toks, last = _tokens(32)
    port_route, jax_route = ROUTES[(arch, stacked, kv)]
    want, j_calls, _ = jax_refs(stacked)["decode"][kv]
    assert j_calls[jax_route] > 0       # traced at least once on that route
    mp = pytest.MonkeyPatch()
    try:
        routes = _Routes(mp, TL, ["flash_decode_write_stacked", "flash_decode", "attention"])
        tc = TL.init_cache(tcfg, 1, MAX_LEN, dtype=kv, device="cpu")
        lg, _ = TL.forward(tp, tcfg, torch.from_numpy(toks), torch.zeros(1, dtype=torch.int32),
                           tc, fresh_prefill=True, last_idx=torch.from_numpy(last))
        got = [lg[0, -1].numpy()]
        assert sum(routes.n.values()) == 0       # prefill: flash_prefill's einsum
        for i, t in enumerate(NXT):
            lg, _ = TL.forward(tp, tcfg, torch.tensor([[t]]),
                               torch.tensor([n_prompt + i], dtype=torch.int32), tc,
                               attn_len=MAX_LEN)
            got.append(lg[0, -1].numpy())
    finally:
        mp.undo()
    assert routes.n == {**dict.fromkeys(routes.n, 0), port_route: nl * len(NXT)}
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


def test_engine_and_cli_match_jax(gguf):
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
def test_gemma_paged_decode_matches_jax(gguf, int8):
    """gemma's forward_paged_decode against the reference's: R = 3 rows at
    different positions, 4 teacher-forced steps over a pool seeded with
    random K/V. The reference multiplies the embedding by sqrt(d) = 16;
    without it (ROADMAP C.9) the logits part by far more than 2e-2."""
    jcfg, jp, _, _ = j_load_llama(gguf)
    tcfg, tp = carry_across(jcfg, jp)
    assert tcfg.embd_scale == 16.0
    jst, tst = JL.stack_layers(jp), TL.stack_layers(tp)
    ps, maxp = 16, 8
    g = torch.Generator().manual_seed(2)
    pos0 = [5, 40, 63]
    _, kp, vp, ks, vs, _, tables = paged_case(
        g, [p + 4 for p in pos0], 2, 2, 256, ps, maxp, n_layers=2, int8=int8)
    tpool = paged_from_numpy(*[None if a is None else np32(a) for a in (kp, vp, ks, vs)],
                             device="cpu")
    jpool = JP.PagedKV(*[None if a is None else jnp_of(a) for a in (kp, vp, ks, vs)])
    toks = np.random.default_rng(4).integers(3, 250, (4, 3)).astype(np.int32)
    for i in range(4):
        pos = np.asarray(pos0, np.int32) + i
        jl, jpool = j_paged_decode(jst, jcfg, jnp.asarray(toks[i]), jnp.asarray(pos),
                                   jpool, jnp.asarray(tables.numpy()))
        tl, _ = TL.forward_paged_decode(tst, tcfg, torch.from_numpy(toks[i]),
                                        torch.from_numpy(pos), tpool, tables)
        close(tl.numpy(), jl, TOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))


def test_gemma_served_alone_and_beside_others(gguf):
    """Each request through the batcher gives the ids it gives served alone
    (greedy and seeded)."""
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    jobs = [(_prompt(20, 21), TSP(temperature=0.0), 8),
            (_prompt(21, 40), TSP(temperature=0.8, top_k=40, seed=3), 8),
            (_prompt(22, 5), TSP(temperature=0.0), 8)]
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


def _complete(base, prompt):
    req = urllib.request.Request(
        base + "/v1/completions", headers={"Content-Type": "application/json"},
        data=json.dumps({"prompt": prompt, "max_tokens": 8, "temperature": 0}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


def test_gemma_http_server_alone_and_together(gguf):
    """The port's HTTP server (the --server path, in process) over the tiny
    gemma GGUF: two greedy completions sent at once give the texts each
    gives sent alone, which are the Engine's greedy texts."""
    import concurrent.futures as cf
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    srv = Server(Flags(model="tiny-gemma.gguf", slots=2, temp=0.0, device="cpu"), eng)
    base, loop = _start(srv)
    try:
        prompts = ["hello", "the quick brown fox"]
        with cf.ThreadPoolExecutor(2) as ex:
            together = list(ex.map(lambda p: _complete(base, p), prompts))
        alone = [_complete(base, p) for p in prompts]
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.batcher.shutdown()
    assert together == alone and all(alone)
