"""The LayerNorm families through the port (models.llama's norm_type "ln"
branches), against the JAX package, on the CPU: gptneox (parallel and
sequential residual) here; falcon (7B-style shared norm, 40B-style with an
FFN norm) in tests/test_torch_ln_falcon.py; starcoder2 in
tests/test_torch_ln_starcoder2.py; phi2 and command-r in
tests/test_torch_ln_phi2_commandr.py. Those files import the shared tests
and set the `arch` fixture's variants.

The GGUFs are written here with the JAX package's GGUFWriter, with the
tensor names and metadata keys of the reference's converters
(tools/convert_hf.py): 2 layers, d 256 at head_dim 64 (phi2: d 320 at
head_dim 80, rope on 32 dims), d_ff 1024, norm weights near 1, the norms'
biases of std 0.1 and the products' of std 0.5, at F32 and at one
quantized type whose blocks divide the widths (Q4_K layers and head with a
Q6_K token_embd; phi2 Q8_0 throughout, as K = 320 holds no 256-block):
- gptneox: 4 heads, rope on 16 dims, the fused attn_qkv with its fused
  bias, an FFN norm, the parallel residual (gptneox-seq: the sequential
  one, use_parallel_residual false);
- falcon: 4 query heads over 1 KV head, the fused qkv, the norm biases
  only, no ffn_norm (7B-style: the FFN reads the attention norm's output);
  falcon-40b: 4 over 2, an FFN norm with its bias (ln_mlp);
- starcoder2: 4 over 2, separate q/k/v with biases, every bias, the
  sequential residual, full rope;
- phi2: 4 heads of 80, rope on 32 dims, a shared norm, every bias and the
  head's;
- command-r: SwiGLU (gate|up interleaved), LayerNorm without bias, a
  shared norm, logits times logit_scale 0.0625.
The port runs its kernels' plain versions here; the JAX side runs its
Pallas kernels in interpret mode, one interpreted run a file shared by the
prefill and decode tests (`jax_refs`). Held:
- LlamaConfig.from_gguf field by field; the layers stay unrolled, as the
  reference's stack_layers leaves them;
- the weights carried across by convert.params_from_numpy, the LayerNorm
  leaves too (norm and projection biases, ffn_norm None, out_norm_b,
  out_b);
- prefill at buckets 32 (the einsum; the q4b products on qmm_txn), 64
  (qmm_planes, f32 out) and 256 (flash_prefill on both sides; qmm_planes
  rounded to bf16), and 4 teacher-forced decode steps over a bf16 cache,
  each step from the reference's cache of that step: logits within TOL
  (2e-2) of the largest at the quantized type, F32_TOL (1e-2) on the F32
  files (their products round activations to bf16 on both sides). The
  reference's side runs under tests/test_torch_q4km.py's _exact_planes:
  from 256 rows its planes product adds the bias term in bf16 after
  rounding, which parts from the exact product by several percent on the
  gateless FFN's down product (ROADMAP C.11); the witness sums as the port
  does, the bias term in f32 before one rounding;
- forward_paged_decode against the reference's: 3 rows at different
  positions, 4 steps over a pool seeded with random K/V, within the same
  tolerances and the same top-1 but for a near tie within them;
- Engine.generate's greedy ids equal over 8 steps on the F32 files, and
  --cli's text;
- the batcher (the --server path) on the paged pool and in dense rows at 2
  rows: each request's ids those it gives served alone (F32 files);
- (starcoder2) the HTTP server at 2 slots, and /v1/embeddings'
  llama_embed_many within 1e-3 (max abs, unit vectors) of the JAX
  package's, which take the output norm's bias;
- (here only) load_llama(fuse=False)'s column split of a pre-fused qkv,
  the config fields convert.py still refuses, the synthetic LayerNorm
  presets' layouts and byte counts on the meta device, and the trained
  weight draw's spread.
Torch runs on one thread (`_one_torch_thread`).
"""
import dataclasses

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
from llamafile_tpu_torch.convert import paged_from_numpy, params_from_numpy
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.kvcache import KVCache
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from llamafile_tpu_torch.testing import paged_case
from tests.test_torch_batcher import _prompt, _serve
from tests.test_torch_engine import _cli_text, _text_until_eos
from tests.test_torch_gemma import _one_torch_thread  # noqa: F401
from tests.test_torch_llama import close, qt_dict
from tests.test_torch_llama import np32 as jnp32
from tests.test_torch_paged import jnp_of, np32
from tests.test_torch_q4km import _exact_planes, _interpreted
from tests.util_models import byte_vocab

NL, DFF = 2, 1024
MAX_LEN = 256
TOL = 2e-2
F32_TOL = 1e-2
# the architectures' tiny layouts: GGUF arch, widths, and which of the
# converters' tensors each writes
ARCHS = {
    "gptneox": dict(gguf="gptneox", d=256, h=4, hkv=4, hd=64, rope_dim=16, parallel=True,
                    fused_qkv=True, ffn_norm=True, biases=("norm", "qkv", "o", "ffn")),
    "gptneox-seq": dict(gguf="gptneox", d=256, h=4, hkv=4, hd=64, rope_dim=16,
                        parallel=False, fused_qkv=True, ffn_norm=True,
                        biases=("norm", "qkv", "o", "ffn")),
    "falcon": dict(gguf="falcon", d=256, h=4, hkv=1, hd=64, fused_qkv=True, ffn_norm=False,
                   biases=("norm",)),
    "falcon-40b": dict(gguf="falcon", d=256, h=4, hkv=2, hd=64, fused_qkv=True,
                       ffn_norm=True, biases=("norm",)),
    "starcoder2": dict(gguf="starcoder2", d=256, h=4, hkv=2, hd=64, ffn_norm=True,
                       biases=("norm", "qkv", "o", "ffn")),
    "phi2": dict(gguf="phi2", d=320, h=4, hkv=4, hd=80, dff=1280, rope_dim=32,
                 ffn_norm=False, biases=("norm", "qkv", "o", "ffn", "head")),
    "command-r": dict(gguf="command-r", d=256, h=4, hkv=4, hd=64, ffn_norm=False,
                      gated=True, biases=()),
}
QUANT = {"phi2": "Q8_0"}                # the quantized type of each; Q4_K elsewhere


def quant_of(arch):
    return QUANT.get(arch, "Q4_K")


def make_tiny_ln_gguf(path, arch, quant="Q4_K", seed=0):
    """A tiny GGUF of one of ARCHS at quant ("F32" or a block type)."""
    a = ARCHS[arch]
    ga, d, h, hkv, hd = a["gguf"], a["d"], a["h"], a["hkv"], a["hd"]
    dff = a.get("dff", DFF)
    rng = np.random.default_rng(seed)
    tokens, scores, token_type = byte_vocab()
    w = GGUFWriter(path)
    meta = [("general.architecture", ga), ("general.name", f"tiny-{arch}"),
            (f"{ga}.block_count", NL), (f"{ga}.embedding_length", d),
            (f"{ga}.attention.head_count", h), (f"{ga}.attention.head_count_kv", hkv),
            (f"{ga}.feed_forward_length", dff), (f"{ga}.attention.layer_norm_epsilon", 1e-5),
            (f"{ga}.context_length", MAX_LEN), (f"{ga}.vocab_size", len(tokens)),
            (f"{ga}.rope.freq_base", 10000.0)]
    if ga == "gptneox":
        meta.append(("gptneox.use_parallel_residual", a["parallel"]))
    if "rope_dim" in a:
        meta.append((f"{ga}.rope.dimension_count", a["rope_dim"]))
    if ga == "command-r":
        meta += [("command-r.logit_scale", 0.0625),
                 ("command-r.attention.layer_norm_rms_epsilon", 1e-5)]
    meta += [("tokenizer.ggml.model", "llama"), ("tokenizer.ggml.tokens", tokens),
             ("tokenizer.ggml.scores", scores),
             ("tokenizer.ggml.token_type", np.asarray(token_type, np.int32)),
             ("tokenizer.ggml.bos_token_id", 1), ("tokenizer.ggml.eos_token_id", 2),
             ("tokenizer.ggml.unknown_token_id", 0), ("tokenizer.ggml.add_bos_token", True)]
    for key, val in meta:
        w.add(key, val)

    def mat(name, shape, q=quant, scale=0.08):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        if q == "F32":
            w.add_tensor_f32(name, arr)
        else:
            w.add_tensor(name, shape, q, JQ.TYPE_BY_NAME[q].quantize(arr.reshape(-1)))

    def vec(name, n, mean, std):
        w.add_tensor_f32(name, (mean + std * rng.standard_normal(n)).astype(np.float32))

    biases = a["biases"]
    small = "Q8_0" if quant == "Q8_0" else "Q6_K"
    mat("token_embd.weight", (len(tokens), d), "F32" if quant == "F32" else small, 0.5)
    nq, nkv = h * hd, hkv * hd
    for i in range(NL):
        p = f"blk.{i}."
        vec(p + "attn_norm.weight", d, 1.0, 0.1)
        if "norm" in biases:
            vec(p + "attn_norm.bias", d, 0.0, 0.1)
        if a.get("ffn_norm"):
            vec(p + "ffn_norm.weight", d, 1.0, 0.1)
            if "norm" in biases:
                vec(p + "ffn_norm.bias", d, 0.0, 0.1)
        if a.get("fused_qkv"):
            mat(p + "attn_qkv.weight", (nq + 2 * nkv, d))
            if "qkv" in biases:
                vec(p + "attn_qkv.bias", nq + 2 * nkv, 0.0, 0.5)
        else:
            for role, n in (("q", nq), ("k", nkv), ("v", nkv)):
                mat(p + f"attn_{role}.weight", (n, d))
                if "qkv" in biases:
                    vec(p + f"attn_{role}.bias", n, 0.0, 0.5)
        mat(p + "attn_output.weight", (d, nq))
        if "o" in biases:
            vec(p + "attn_output.bias", d, 0.0, 0.5)
        if a.get("gated"):
            mat(p + "ffn_gate.weight", (dff, d))
        mat(p + "ffn_up.weight", (dff, d))
        mat(p + "ffn_down.weight", (d, dff))
        if "ffn" in biases:
            vec(p + "ffn_up.bias", dff, 0.0, 0.5)
            vec(p + "ffn_down.bias", d, 0.0, 0.5)
    vec("output_norm.weight", d, 1.0, 0.1)
    if "norm" in biases:
        vec("output_norm.bias", d, 0.0, 0.1)
    mat("output.weight", (len(tokens), d), "F32" if quant == "F32" else quant)
    if "head" in biases:
        vec("output.bias", len(tokens), 0.0, 0.5)
    w.write()
    return path


@pytest.fixture(scope="module", params=["gptneox", "gptneox-seq"])
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def files(tmp_path_factory, arch):
    """{"F32": path, "quant": path} of the arch's tiny GGUFs."""
    tmp = tmp_path_factory.mktemp(arch)
    return {q: make_tiny_ln_gguf(str(tmp / f"tiny-{arch}-{q}.gguf"), arch,
                                 "F32" if q == "F32" else quant_of(arch))
            for q in ("F32", "quant")}


def tol_of(q):
    return F32_TOL if q == "F32" else TOL


def test_ln_config_matches_jax(files, arch):
    a = ARCHS[arch]
    for q, path in files.items():
        jcfg, _, _, _ = j_load_llama(path)
        tcfg, tp, _, _ = load_llama(path, device="cpu")
        for name in TL.CONFIG_FIELDS:
            assert getattr(tcfg, name) == getattr(jcfg, name), (q, name)
        assert tcfg.norm_type == "ln" and tcfg.rope_neox == (arch != "command-r")
        assert tcfg.parallel_residual == a.get("parallel", a["gguf"] != "starcoder2")
        assert tcfg.rope_dim == a.get("rope_dim", 0)
        assert tcfg.logit_scale == (16.0 if arch == "command-r" else 1.0)
        assert tcfg.attn_qkv_bias == (a["gguf"] in ("gptneox", "starcoder2"))
        l0 = tp.layers[0]
        assert l0.wqkv is not None and l0.wq is None         # fused, or pre-fused
        assert (l0.w_gate_up is not None) == bool(a.get("gated")) and l0.w_gate is None
        assert (l0.ffn_norm is None) == (not a.get("ffn_norm"))
        assert (l0.bo is not None) == ("o" in a["biases"])
        assert (tp.out_b is not None) == ("head" in a["biases"])
        # the LayerNorm layers stay unrolled, in both packages
        assert TL.stack_layers(tp) is tp
        _, jp, _, _ = j_load_llama(path)
        assert JL.stack_layers(jp) is jp


def _carry(jcfg, jp):
    """The JAX config and leaves as numpy, through params_from_numpy (the
    LayerNorm leaves and the head bias too)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    leaf = lambda v: None if v is None else (qt_dict(v) if hasattr(v, "kind") else jnp32(v))
    layers = [{f.name: leaf(getattr(l, f.name)) for f in dataclasses.fields(l)}
              for l in jp.layers]
    tree = {"tok_embd": jnp32(jp.tok_embd), "out_norm": jnp32(jp.out_norm),
            "output": qt_dict(jp.output), "layers": layers,
            "out_norm_b": leaf(jp.out_norm_b), "out_b": leaf(jp.out_b)}
    return params_from_numpy(fields, tree, device="cpu")


LN_LEAVES = ("attn_norm", "ffn_norm", "attn_norm_b", "ffn_norm_b", "bq", "bk", "bv", "bo",
             "b_up", "b_down")


def test_ln_carried_weights_equal_loaded(files, arch):
    jcfg, jp, _, _ = j_load_llama(files["quant"])
    ccfg, cp = _carry(jcfg, jp)
    tcfg, tp, _, _ = load_llama(files["quant"], device="cpu")
    assert ccfg == tcfg
    for cl, tl in zip(cp.layers, tp.layers):
        for f in LN_LEAVES:
            c, t = getattr(cl, f), getattr(tl, f)
            assert (c is None) == (t is None), f
            assert c is None or torch.equal(c, t), f
        for f in ("wqkv", "w_up", "w_gate_up", "w_down", "wo"):
            c, t = getattr(cl, f), getattr(tl, f)
            assert (c is None) == (t is None), f
            if c is not None:
                assert (c.kind, c.shape, c.il) == (t.kind, t.shape, t.il), f
                assert torch.equal(c.qs, t.qs) and torch.equal(c.scales, t.scales), f
    for f in ("out_norm", "out_norm_b", "out_b"):
        c, t = getattr(cp, f), getattr(tp, f)
        assert (c is None) == (t is None) and (c is None or torch.equal(c, t)), f
    assert torch.equal(cp.output.qs, tp.output.qs)


# the prefill test's prompts by bucket (the 32-token bucket's is also the
# decode test's), the buckets of each file, and the decode test's
# teacher-forced tokens
PROMPTS = dict(zip((32, 64, 256), (lambda r: (r.integers(3, 250, 20), r.integers(3, 250, 50),
                                              r.integers(3, 250, 200)))(
    np.random.default_rng(7))))
BUCKETS = {"F32": (32, 64, 256), "quant": (32, 64, 256)}
NXT = [66, 67, 68, 69]


def _tokens(bucket):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(PROMPTS[bucket])] = PROMPTS[bucket]
    return toks, np.asarray([len(PROMPTS[bucket]) - 1], np.int32)


def _jax_side(path, buckets):
    """The reference's side of the prefill and decode tests for one file,
    with one jitted forward: the last logits at each bucket; the logits of
    NXT's decode steps over the bf16 cache of the 32-bucket prefill, and
    that cache (numpy) before each step."""
    jcfg, jp, _, _ = j_load_llama(path)
    fwd = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))
    out = {"prefill": {}}
    for bucket in buckets:
        toks, last = _tokens(bucket)
        lg, jc = fwd(jp, jcfg, jnp.asarray(toks), jnp.zeros((1,), jnp.int32),
                     JL.init_cache(jcfg, 1, MAX_LEN, jnp.bfloat16), fresh_prefill=True,
                     last_idx=jnp.asarray(last))
        out["prefill"][bucket] = np.asarray(lg[0, -1])
        if bucket == 32:
            cache = jc
    n_prompt, logits, caches = len(PROMPTS[32]), [], []
    for i, t in enumerate(NXT):
        caches.append([np.array(a.astype(jnp.float32)) for a in (cache.k, cache.v)])
        lg, cache = fwd(jp, jcfg, jnp.asarray([[t]], jnp.int32),
                        jnp.asarray([n_prompt + i], jnp.int32), cache, attn_len=MAX_LEN)
        logits.append(np.asarray(lg[0, -1]))
    out["decode"] = (logits, caches)
    return out


@pytest.fixture(scope="module")
def jax_refs(files):
    """_jax_side by file, each run once for the module, with the planes
    product's exact-product witness."""
    refs = {}

    def get(q):
        if q not in refs:
            refs[q] = _interpreted(lambda: _exact_planes(
                lambda: _jax_side(files[q], BUCKETS[q])))
        return refs[q]
    return get


@pytest.mark.parametrize("q", ["F32", "quant"])
def test_ln_prefill_matches_jax(files, q, jax_refs):
    tcfg, tp, _, _ = load_llama(files[q], device="cpu")
    for bucket in BUCKETS[q]:
        toks, last = _tokens(bucket)
        tc = TL.init_cache(tcfg, 1, MAX_LEN, device="cpu")
        lg, _ = TL.forward(tp, tcfg, torch.from_numpy(toks), torch.zeros(1, dtype=torch.int32),
                           tc, fresh_prefill=True, last_idx=torch.from_numpy(last))
        close(lg[0, -1].numpy(), jax_refs(q)["prefill"][bucket], tol_of(q))


@pytest.mark.parametrize("q", ["F32", "quant"])
def test_ln_decode_matches_jax(files, q, jax_refs):
    tcfg, tp, _, _ = load_llama(files[q], device="cpu")
    want, caches = jax_refs(q)["decode"]
    n_prompt = len(PROMPTS[32])
    for i, t in enumerate(NXT):
        tc = KVCache(*[torch.from_numpy(a).to(torch.bfloat16) for a in caches[i]], None, None)
        lg, _ = TL.forward(tp, tcfg, torch.tensor([[t]]),
                           torch.tensor([n_prompt + i], dtype=torch.int32), tc,
                           attn_len=MAX_LEN)
        close(lg[0, -1].numpy(), want[i], tol_of(q))


j_paged_decode = jax.jit(JL.forward_paged_decode, static_argnames=("cfg",))


def same_top1_or_near_tie(got, want, tol):
    """Each row's top-1 is the reference's, or a near tie there: the
    reference's logit of the port's choice within tol of its largest logit
    (of the row's largest magnitude), the limit the logits are held to."""
    for g, w in zip(got, want):
        assert g.argmax() == w.argmax() or w.max() - w[g.argmax()] <= tol * np.abs(w).max()


@pytest.mark.parametrize("q", ["F32", "quant"])
def test_ln_paged_decode_matches_jax(files, arch, q):
    """forward_paged_decode against the reference's (its unrolled layers
    close through _finish_layer): R = 3 rows at different positions, 4
    teacher-forced steps over a pool seeded with random K/V, each side
    writing its own pool. The same top-1, but for a near tie
    (gptneox-seq's Q4_K file: a row's two best tokens 0.84% of its largest
    logit apart in the reference, the other way round in the port, the
    logits within 1.3e-2)."""
    a = ARCHS[arch]
    jcfg, jp, _, _ = j_load_llama(files[q])
    tcfg, tp = _carry(jcfg, jp)
    ps, maxp = 16, 8
    g = torch.Generator().manual_seed(2)
    pos0 = [5, 40, 63]
    _, kp, vp, ks, vs, _, tables = paged_case(
        g, [p + 4 for p in pos0], a["h"], a["hkv"], a["hd"], ps, maxp, n_layers=NL)
    tpool = paged_from_numpy(np32(kp), np32(vp), device="cpu")
    jpool = JP.PagedKV(jnp_of(kp), jnp_of(vp))
    toks = np.random.default_rng(4).integers(3, 250, (4, 3)).astype(np.int32)

    def run():
        nonlocal jpool
        out = []
        for i in range(4):
            pos = np.asarray(pos0, np.int32) + i
            jl, jpool = j_paged_decode(jp, jcfg, jnp.asarray(toks[i]), jnp.asarray(pos),
                                       jpool, jnp.asarray(tables.numpy()))
            out.append(np.asarray(jl))
        return out
    want = _interpreted(run)
    for i in range(4):
        pos = np.asarray(pos0, np.int32) + i
        tl, _ = TL.forward_paged_decode(tp, tcfg, torch.from_numpy(toks[i]),
                                        torch.from_numpy(pos), tpool, tables)
        close(tl.numpy(), want[i], tol_of(q))
        same_top1_or_near_tie(tl.numpy(), want[i], tol_of(q))


def test_ln_engine_and_cli_match_jax(files):
    """Greedy ids of Engine.generate over 8 steps on the F32 file, and
    --cli's text, against the JAX Engine's."""
    path = files["F32"]

    def run():
        cfg, params, tok, _ = j_load_llama(path)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
        eng.decode_chunk = 7      # the 7 decode tokens in one dispatch: one scan compiled
        return list(eng.generate("hello", max_tokens=8, sampling=JSP(temperature=0.0),
                                 stop_on_eog=False))
    want = _interpreted(run)
    eng = load_engine(path, device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers, list)
    ids = [t for t, _ in eng.generate("hello", max_tokens=8, sampling=TSP(temperature=0.0),
                                      stop_on_eog=False)]
    assert len(ids) == 8 and ids == [t for t, _ in want]
    assert _cli_text(path, "hello", 8) == _text_until_eos(want)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_ln_served_alone_and_beside_others(files, paged):
    """The batcher at 2 rows (admission prefill, then the paged decode or
    the dense rows' fused decode): each request's ids those it gives served
    alone, greedy and seeded. The prompts share no first token (see
    tests/test_torch_qwen.py)."""
    eng = load_engine(files["F32"], device="cpu", max_seq_len=MAX_LEN)
    jobs = [(_prompt(20, 22)[1:], TSP(temperature=0.0), 8),
            (_prompt(21, 41)[1:], TSP(temperature=0.8, top_k=40, seed=3), 8),
            (_prompt(22, 6)[1:], TSP(temperature=0.0), 8)]
    b = TBatcher(eng, rows=2, paged=paged)
    try:
        assert b.paged_mode == paged
        together = _serve(b, jobs)
    finally:
        b.shutdown()
    for job, toks in zip(jobs, together):
        b = TBatcher(eng, rows=2, paged=paged)
        try:
            assert _serve(b, [job]) == [toks] and len(toks) == 8
        finally:
            b.shutdown()


LN_PRESETS = {"starcoder2-7b": (False, True, 0), "command-r-v01": (True, False, 0),
              "pythia-6.9b-2l": (True, True, 32), "phi-2-2l": (True, True, 32),
              "falcon-7b-2l": (True, True, 0)}


@pytest.mark.parametrize("preset", list(LN_PRESETS))
def test_ln_synthetic_presets(preset):
    """The LayerNorm presets' layouts on the meta device (no data): the
    config's branches, the layers left unrolled, the fused or separate qkv
    (fused by fuse_projections), no gate in a gateless FFN, no ffn_norm
    under a shared norm; decode_read_bytes counts every byte but the
    embedding's: a gateless FFN's two matrices and the biases."""
    from llamafile_tpu_torch.models.synthetic import (PRESETS, decode_read_bytes,
                                                      make_synthetic_llama, param_bytes)
    parallel, gateless, rope_dim = LN_PRESETS[preset]
    cfg, params = make_synthetic_llama(preset, "Q8_0" if "falcon" in preset else "Q4_K",
                                       fuse=True, device="meta")
    layout = PRESETS[preset]["ln_layout"]
    assert (cfg.norm_type, cfg.parallel_residual, cfg.rope_dim) == ("ln", parallel, rope_dim)
    assert cfg.logit_scale == (16.0 if preset.startswith("command-r") else 1.0)
    assert TL.stack_layers(params) is params
    l0 = params.layers[0]
    assert l0.wqkv is not None and l0.wq is None and l0.w_gate is None
    assert (l0.w_gate_up is None) == gateless and (l0.ffn_norm is None) == layout.get(
        "shared_norm", False)
    n = cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
    assert l0.wqkv.shape == (n, cfg.d_model)
    mats = [l0.wqkv, l0.wo, l0.w_down, l0.w_up if gateless else l0.w_gate_up]
    vecs = [v for v in (l0.attn_norm, l0.ffn_norm, l0.attn_norm_b, l0.ffn_norm_b, l0.bq,
                        l0.bk, l0.bv, l0.bo, l0.b_up, l0.b_down) if v is not None]
    per_layer = (sum(q.qs.nbytes + q.scales.nbytes + (0 if q.bias is None else q.bias.nbytes)
                     for q in mats) + sum(v.nbytes for v in vecs))
    head = params.output
    tail = sum(t.nbytes for t in (params.out_norm, params.out_norm_b, params.out_b,
                                  head.qs, head.scales, head.bias) if t is not None)
    assert decode_read_bytes(params, cfg) == cfg.n_layers * per_layer + tail
    assert param_bytes(params) - decode_read_bytes(params, cfg) == params.tok_embd.nbytes


@pytest.mark.parametrize("quant", ["Q4_K", "Q8_0", "Q6_K"])
def test_trained_draw_spread(quant):
    """models.synthetic's trained draw: weights of an RMS near 0.03 and a
    mean near zero, the q4b hi plane's groups (stored as 16q - 128 codes)
    spread as the lo plane's; the default draw's are 16 times wider."""
    from llamafile_tpu_torch.models.synthetic import _rand_qtensor
    from llamafile_tpu_torch.ops.repack import dequant_qtensor
    g = torch.Generator().manual_seed(0)
    w = dequant_qtensor(_rand_qtensor(g, 256, 1024, quant, "cpu", trained=True))
    assert 0.02 < w.pow(2).mean().sqrt().item() < 0.06 and abs(w.mean().item()) < 1e-3
    planes = w.reshape(256, 4, 2, 128)              # the lo and hi plane of each 256 rows
    lo, hi = planes[:, :, 0].std().item(), planes[:, :, 1].std().item()
    assert abs(lo / hi - 1) < 0.1
    if quant == "Q4_K":
        wide = dequant_qtensor(_rand_qtensor(g, 256, 1024, quant, "cpu", centered=True))
        wp = wide.reshape(256, 4, 2, 128)
        assert wp[:, :, 1].std().item() > 10 * wp[:, :, 0].std().item()


def test_ln_unfused_load_splits_qkv(files):
    """load_llama(fuse=False) splits a pre-fused attn_qkv by columns
    (ops.repack.slice_qtensor_cols): the three products give the fused
    one's columns, and the prefill the same logits."""
    tcfg, fused, _, _ = load_llama(files["quant"], device="cpu")
    _, split, _, _ = load_llama(files["quant"], device="cpu", fuse=False)
    l0, s0 = fused.layers[0], split.layers[0]
    assert s0.wqkv is None and s0.wq is not None
    x = torch.randn((3, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    want = TL.qmatmul(x, l0.wqkv)
    got = torch.cat([TL.qmatmul(x, w) for w in (s0.wq, s0.wk, s0.wv)], dim=-1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    toks, last = _tokens(32)
    out = [TL.forward(p, tcfg, torch.from_numpy(toks), torch.zeros(1, dtype=torch.int32),
                      TL.init_cache(tcfg, 1, MAX_LEN, device="cpu"), fresh_prefill=True,
                      last_idx=torch.from_numpy(last))[0] for p in (fused, split)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [("norm_type", "ln_np"), ("gelu_approx", True),
                                         ("residual_scale", 0.5)])
def test_ln_unported_config_fields_raise(files, field, value):
    """params_from_numpy carries "ln" and the parallel residual, partial
    rope and logit scale; olmo's non-parametric norm ("ln_np"), gpt2's tanh
    GELU in the gateless FFN and granite's residual scale still raise."""
    from llamafile_tpu_torch.convert import config_from_fields
    jcfg, _, _, _ = j_load_llama(files["F32"])
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    assert config_from_fields(fields).norm_type == "ln"
    with pytest.raises(NotImplementedError, match=field):
        config_from_fields({**fields, field: value})
