"""Gemma 2 through the port (models.llama's gemma2 branches, the decode
kernels' window and softcap options), against the JAX package, on the CPU.

The GGUFs are written here with the JAX package's GGUFWriter: arch gemma2
at d 256, 2 query heads over 1 KV head of head_dim 128, d_ff 1024, 4
layers, a window of 8 on layers 0 and 2, softcaps 50 / 30, norm weights
near 1, the head tied to a Q6_K token_embd; Q4_K layers (stacked by the
Engine) or F32. Those widths reach the decode kernels' route
(ops.attention.decode_route), so the port runs their plain versions here;
the JAX side runs its Pallas kernels in interpret mode (the monkeypatch of
tests/test_flash_write.py). Held:
- LlamaConfig.from_gguf field by field, the weights carried across by
  convert.params_from_numpy, and other architectures (qwen2, phi3) still
  refused;
- prefill (32-token bucket, the einsum with the window and softcap), then
  decode past the window, stacked and unrolled, bf16 and int8 caches:
  logits within 2e-2 of the largest, with the attention route of each
  decode layer named on both sides (the port's unrolled int8 decode takes
  flash_decode with both options where the reference's unrolled loop takes
  the einsum: the same function);
- Engine and --cli greedy tokens on a 16-token answer;
- the GELU: bitwise against jax.nn.gelu(approximate=True) in bf16; in f32
  within 4e-7 of the largest output, since XLA's f32 tanh on the CPU is its
  own approximation (up to 3.8 ulp from the exact, where torch's is within
  1);
- the plain versions of both decode kernels with the window and softcap
  against the Pallas kernels;
- a gemma2 engine under the batcher raises NotImplementedError (the
  reference's paged decode asserts on a window).
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.gguf import GGUFWriter
from llamafile_tpu.gguf import quants as JQ
from llamafile_tpu.models import llama as JL
from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.models.loader import load_llama
from llamafile_tpu_torch.ops import attention as TA
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from llamafile_tpu_torch.testing import rel_err
from tests.test_torch_engine import _cli_text, _text_until_eos
from tests.test_torch_llama import carry_across
from tests.test_torch_q4km import _interpreted
from tests.util_models import byte_vocab

D, DFF, NL, H, HKV, HD, WIN = 256, 1024, 4, 2, 1, 128, 8
MAX_LEN = 256
TOL = 2e-2


def make_tiny_gemma2_gguf(path, quant="Q4_K", seed=0, arch="gemma2"):
    rng = np.random.default_rng(seed)
    tokens, scores, token_type = byte_vocab()
    w = GGUFWriter(path)
    for key, val in (("general.architecture", arch), ("general.name", "tiny-gemma2"),
                     (f"{arch}.block_count", NL), (f"{arch}.embedding_length", D),
                     (f"{arch}.attention.head_count", H),
                     (f"{arch}.attention.head_count_kv", HKV),
                     (f"{arch}.attention.key_length", HD),
                     (f"{arch}.attention.value_length", HD),
                     (f"{arch}.feed_forward_length", DFF),
                     (f"{arch}.attention.layer_norm_rms_epsilon", 1e-6),
                     (f"{arch}.attention.sliding_window", WIN),
                     (f"{arch}.attn_logit_softcapping", 50.0),
                     (f"{arch}.final_logit_softcapping", 30.0),
                     (f"{arch}.context_length", MAX_LEN), (f"{arch}.vocab_size", len(tokens)),
                     ("tokenizer.ggml.model", "llama"), ("tokenizer.ggml.tokens", tokens),
                     ("tokenizer.ggml.scores", scores),
                     ("tokenizer.ggml.token_type", np.asarray(token_type, np.int32)),
                     ("tokenizer.ggml.bos_token_id", 1), ("tokenizer.ggml.eos_token_id", 2),
                     ("tokenizer.ggml.unknown_token_id", 0),
                     ("tokenizer.ggml.add_bos_token", True)):
        w.add(key, val)

    def add(name, shape, q=quant, scale=0.08):
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        if q == "F32":
            w.add_tensor_f32(name, arr)
        else:
            w.add_tensor(name, shape, q, JQ.TYPE_BY_NAME[q].quantize(arr.reshape(-1)))

    def norm(name):
        w.add_tensor_f32(name, (1 + 0.1 * rng.standard_normal(D)).astype(np.float32))

    add("token_embd.weight", (len(tokens), D), "Q6_K", 0.5)
    for i in range(NL):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight")
        add(p + "attn_q.weight", (H * HD, D))
        add(p + "attn_k.weight", (HKV * HD, D))
        add(p + "attn_v.weight", (HKV * HD, D))
        add(p + "attn_output.weight", (D, H * HD))
        norm(p + "post_attention_norm.weight")
        norm(p + "ffn_norm.weight")
        add(p + "ffn_gate.weight", (DFF, D))
        add(p + "ffn_up.weight", (DFF, D))
        add(p + "ffn_down.weight", (D, DFF))
        norm(p + "post_ffw_norm.weight")
    norm("output_norm.weight")
    w.write()
    return path


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_tiny_gemma2_gguf(str(tmp_path_factory.mktemp("gemma2") / "tiny-gemma2-q4k.gguf"))


def test_config_matches_jax(gguf):
    jcfg, _, _, _ = j_load_llama(gguf)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    for name in TL.CONFIG_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert (tcfg.swa_window, tcfg.swa_pattern, tcfg.attn_softcap, tcfg.final_softcap) == (
        WIN, 2, 50.0, 30.0)
    assert tcfg.rope_neox and tcfg.ffn_gelu and tcfg.post_norms
    assert tcfg.embd_scale == D ** 0.5 and tcfg.attn_scale == 0.0
    assert [TL.layer_window(tcfg, li) for li in range(NL)] == [WIN, None, WIN, None]
    assert tp.output.kind == "q8b" and tp.layers[0].attn_post_norm.shape == (D,)


@pytest.mark.parametrize("arch", ["qwen2moe", "phi3"])
def test_other_gemmas_not_ported(tmp_path, arch):
    """The gemma family is ported (gemma and gemma3 are held in
    tests/test_torch_gemma.py and test_torch_gemma3.py), and qwen2 and
    qwen3 (tests/test_torch_qwen.py); other architectures, such as qwen2moe
    and phi3, still raise."""
    path = make_tiny_gemma2_gguf(str(tmp_path / f"{arch}.gguf"), quant="F32", arch=arch)
    with pytest.raises(NotImplementedError, match="not ported"):
        load_llama(path, device="cpu")


def test_carried_weights_equal_loaded(gguf):
    """params_from_numpy takes the JAX config and leaves, the post norms
    too: the same config and tensors as the port's own loader."""
    jcfg, jp, _, _ = j_load_llama(gguf)
    ccfg, cp = carry_across(jcfg, jp)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    assert ccfg == tcfg
    for cl, tl in zip(cp.layers, tp.layers):
        for f in ("attn_norm", "ffn_norm", "attn_post_norm", "ffn_post_norm"):
            assert torch.equal(getattr(cl, f), getattr(tl, f)), f
        for f in ("wqkv", "w_gate_up", "w_down", "wo"):
            c, t = getattr(cl, f), getattr(tl, f)
            assert (c.kind, c.shape, c.il) == (t.kind, t.shape, t.il), f
            assert torch.equal(c.qs, t.qs) and torch.equal(c.scales, t.scales), f
    assert torch.equal(cp.output.qs, tp.output.qs)


class _Routes:
    """Counts the decode attention calls of one side by function name."""

    def __init__(self, mp, mod, names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)
            mp.setattr(mod, name, spy)


# the decode attention each (stacked, kv) case takes, port and reference
ROUTES = {(True, "bf16"): ("flash_decode_write_stacked", "flash_decode_write_stacked"),
          (False, "bf16"): ("flash_decode_write_stacked", "flash_decode_write_stacked"),
          (True, "int8"): ("attention", "attention"),
          (False, "int8"): ("flash_decode", "attention")}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unrolled"])
def test_forward_past_window_matches_jax(gguf, stacked, kv):
    n_prompt = 20
    jcfg, jp, _, _ = j_load_llama(gguf)
    tcfg, tp, _, _ = load_llama(gguf, device="cpu")
    if stacked:
        jp, tp = JL.stack_layers(jp), TL.stack_layers(tp)
    assert isinstance(tp.layers, TL.LlamaLayer) == stacked
    toks = np.zeros((1, 32), np.int32)
    toks[0, :n_prompt] = np.random.default_rng(5).integers(3, 250, n_prompt)
    nxt = [66, 67, 68, 69]
    last = np.asarray([n_prompt - 1], np.int32)
    port_route, jax_route = ROUTES[(stacked, kv)]
    jdt = jnp.int8 if kv == "int8" else jnp.bfloat16

    def run_jax():
        mp = pytest.MonkeyPatch()
        try:
            routes = _Routes(mp, JA if jax_route != "attention" else JL, [jax_route])
            fwd = jax.jit(JL.forward, static_argnames=("cfg", "fresh_prefill", "attn_len"))
            jc = JL.init_cache(jcfg, 1, MAX_LEN, jdt)
            lg, jc = fwd(jp, jcfg, jnp.asarray(toks), jnp.zeros((1,), jnp.int32), jc,
                         fresh_prefill=True, last_idx=jnp.asarray(last))
            out, n0 = [np.asarray(lg[0, -1])], routes.n[jax_route]
            for i, t in enumerate(nxt):
                lg, jc = fwd(jp, jcfg, jnp.asarray([[t]], jnp.int32),
                             jnp.asarray([n_prompt + i], jnp.int32), jc, attn_len=MAX_LEN)
                out.append(np.asarray(lg[0, -1]))
            return out, routes.n[jax_route] - n0
        finally:
            mp.undo()
    want, j_calls = _interpreted(run_jax)
    assert j_calls > 0                  # traced at least once on that route
    mp = pytest.MonkeyPatch()
    try:
        routes = _Routes(mp, TL, ["flash_decode_write_stacked", "flash_decode", "attention"])
        tc = TL.init_cache(tcfg, 1, MAX_LEN, dtype=kv, device="cpu")
        lg, _ = TL.forward(tp, tcfg, torch.from_numpy(toks), torch.zeros(1, dtype=torch.int32),
                           tc, fresh_prefill=True, last_idx=torch.from_numpy(last))
        got = [lg[0, -1].numpy()]
        assert sum(routes.n.values()) == 0       # prefill: the einsum in flash_prefill
        for i, t in enumerate(nxt):
            lg, _ = TL.forward(tp, tcfg, torch.tensor([[t]]),
                               torch.tensor([n_prompt + i], dtype=torch.int32), tc,
                               attn_len=MAX_LEN)
            got.append(lg[0, -1].numpy())
    finally:
        mp.undo()
    assert routes.n == {**dict.fromkeys(routes.n, 0), port_route: NL * len(nxt)}
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
        assert np.abs(g).max() <= 30.0             # the final softcap


@pytest.fixture(scope="module")
def jax_generation(gguf):
    def run():
        cfg, params, tok, _ = j_load_llama(gguf)
        eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN)
        return list(eng.generate("hello", max_tokens=16, sampling=JSP(temperature=0.0),
                                 stop_on_eog=False))
    return _interpreted(run)


def test_engine_and_cli_match_jax(gguf, jax_generation):
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    assert isinstance(eng.params.layers, TL.LlamaLayer)
    ids = [t for t, _ in eng.generate("hello", max_tokens=16,
                                      sampling=TSP(temperature=0.0), stop_on_eog=False)]
    assert len(ids) == 16 and ids == [t for t, _ in jax_generation]
    assert _cli_text(gguf, "hello", 16) == _text_until_eos(jax_generation)


def test_batcher_refuses_gemma2(gguf):
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TBatcher(eng, rows=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = (np.random.default_rng(3).standard_normal(100000) * 4).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x).astype(dtype), approximate=True)
                      .astype(jnp.float32))
    got = TL.gelu_tanh(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-7 * np.abs(want).max())


# (pos per batch row, s_eff, window, softcap); the window past and inside
# the visible rows
DECODE_CASES = [((300, 1000), 1024, 256, 50.0), ((40, 700), 1024, None, 50.0),
                ((1000, 600), 1024, 700, 0.0)]


@pytest.mark.parametrize("pos,s_eff,win,cap", DECODE_CASES)
def test_plain_decode_kernels_match_pallas(pos, s_eff, win, cap):
    b, hq, hkv, d = 2, 4, 2, 256
    rng = np.random.default_rng(sum(pos))
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    k3 = bf(rng.standard_normal((2, b, s_eff, hkv * d)))
    v3 = bf(rng.standard_normal((2, b, s_eff, hkv * d)))
    q = (rng.standard_normal((b, hq, d)) * 0.5).astype(np.float32)
    kn, vn = (rng.standard_normal((b, hkv, d)).astype(np.float32) for _ in range(2))
    codes = rng.integers(-127, 128, (2, b, s_eff, hkv, d)).astype(np.int8)
    ksc, vsc = (rng.uniform(2e-3, 2e-2, (2, b, s_eff, hkv)).astype(np.float32)
                for _ in range(2))
    p = np.asarray(pos, np.int32)
    scale = d ** -0.5
    t = torch.from_numpy

    def run():
        fdw, _, _ = JA.flash_decode_write_stacked(
            jnp.asarray(q), jnp.asarray(k3, jnp.bfloat16), jnp.asarray(v3, jnp.bfloat16),
            jnp.asarray(kn), jnp.asarray(vn), jnp.int32(1), jnp.asarray(p), scale, hkv=hkv,
            win_l=win, softcap=cap)
        kb = jnp.asarray(k3[1], jnp.bfloat16).reshape(b, s_eff, hkv, d)
        vb = jnp.asarray(v3[1], jnp.bfloat16).reshape(b, s_eff, hkv, d)
        fd = JA.flash_decode(jnp.asarray(q), kb, vb, jnp.asarray(p), scale, window=win or 0,
                             softcap=cap)
        kq = jnp.asarray(codes[1].astype(np.float32) * ksc[1][..., None])
        vq = jnp.asarray(codes[0].astype(np.float32) * vsc[0][..., None])
        fq = JA.flash_decode(jnp.asarray(q), kq, vq, jnp.asarray(p), scale, window=win or 0,
                             softcap=cap)
        return [torch.from_numpy(np.array(a)) for a in (fdw, fd, fq)]
    want = _interpreted(run)
    k3t, v3t = t(k3).to(torch.bfloat16), t(v3).to(torch.bfloat16)
    got = [TA.flash_decode_write_plain(t(q), k3t.clone(), v3t.clone(), t(kn), t(vn), 1, t(p),
                                       scale, hkv, s_eff, win, cap),
           TA.flash_decode_stacked_plain(t(q), k3t, v3t, 1, t(p), scale, hkv, s_eff, win,
                                         cap),
           TA.flash_decode_plain(t(q), t(codes[1]), t(codes[0]), t(p), scale, win or 0, cap,
                                 k_scale=t(ksc[1]), v_scale=t(vsc[0]))]
    for name, g, w, tol in zip(("flash_decode_write", "flash_decode bf16", "flash_decode int8"),
                               got, want, (TOL, TOL, 1e-5)):
        assert rel_err(g, w) <= tol, name
