"""Mirostat, the penalty window in Engine.generate, and grammar-constrained
requests of the port against the JAX package, on the CPU.

Both packages draw their categorical samples as argmax(logits + Gumbel
noise); the port's noise comes from `_gumbel`, which these tests replace by
the JAX package's own noise: for `sample_mirostat`, gumbel(key) of each
call's shape; for Engine.generate, the noise of the key splits its
generate and decode scan make (PRNGKey(seed), one split for the first
token, one a decode step). The JAX Engine runs its Pallas kernels in
interpret mode (tests/test_torch_engine.py's monkeypatch), so both sides
follow the kernels' numerics. The grammar request goes to both HTTP
servers, each over the same tiny F32 GGUF.
"""
import asyncio
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

import llamafile_tpu.ops.attention as JA
from llamafile_tpu.runtime import sampling as JS
from llamafile_tpu.runtime.engine import load_engine as j_load_engine
from llamafile_tpu_torch.runtime import sampling as TS
from llamafile_tpu_torch.runtime.engine import load_engine
from tests.test_torch_engine import _tiny
from tests.test_torch_q4km import _one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_server import _free_port, _post, _start

V = 300
PROMPT = "hello there"
N_NEW = 17                 # the first token and two decode chunks of 8

GENERATE_CASES = {
    # the plain greedy ids repeat one at the 17th token: these penalties
    # (over the last 16) change it
    "penalties_greedy": dict(temperature=0.0, repeat_penalty=1.5,
                             presence_penalty=3.0, frequency_penalty=1.0,
                             penalty_last_n=16),
    "penalties_sampled": dict(temperature=0.9, top_k=20, repeat_penalty=1.3,
                              presence_penalty=0.5, seed=5),
    "mirostat_v1": dict(mirostat=1, temperature=1.0, seed=7),
    "mirostat_v2": dict(mirostat=2, temperature=0.9, mirostat_tau=3.0,
                        mirostat_eta=0.2, repeat_penalty=1.2, seed=9),
}


def _logits(seed, rows=2, v=V, ties=False):
    a = (np.random.default_rng(seed).standard_normal((rows, v)) * 3).astype(np.float32)
    if ties:      # equal values across the top 100: lax.top_k's index order
        a[:, 10:40] = a[:, 5:6]
        a[:, 200:230] = a[:, 5:6]
    return a


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_sample_mirostat_same_ids_and_mu(monkeypatch, version, ties):
    """Eight steps carrying mu, each on new logits (with logit bias and
    penalties through sample_stateful on odd steps)."""
    jsp = JS.SamplingParams(mirostat=version, temperature=0.8, mirostat_tau=4.0,
                            mirostat_eta=0.15, repeat_penalty=1.2,
                            logit_bias=((3, 2.0),))
    tsp = TS.SamplingParams(mirostat=version, temperature=0.8, mirostat_tau=4.0,
                            mirostat_eta=0.15, repeat_penalty=1.2,
                            logit_bias=((3, 2.0),))
    jmu, tmu = JS.mirostat_init(jsp, 2), TS.mirostat_init(tsp, 2, device="cpu")
    np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    counts = np.zeros((2, V), np.float32)
    counts[:, [5, 7, 11]] = [1.0, 2.0, 1.0]
    key = jax.random.PRNGKey(version)
    for step in range(8):
        key, sub = jax.random.split(key)
        logits = _logits(10 * version + step, ties=ties)
        shape = (2, V) if version == 2 else (2, 100)
        noise = torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))
        monkeypatch.setattr(TS, "_gumbel", lambda s, gen, device: noise)
        if step % 2:
            jt, jmu = JS.sample_stateful(jnp.asarray(logits), sub, jsp,
                                         jnp.asarray(counts), jmu)
            tt, tmu = TS.sample_stateful(torch.from_numpy(logits), None, tsp,
                                         torch.from_numpy(counts), tmu)
        else:
            jt, jmu = JS.sample_mirostat(jnp.asarray(logits), sub, jsp, jmu)
            tt, tmu = TS.sample_mirostat(torch.from_numpy(logits), None, tsp, tmu)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {step}")
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0, atol=1e-6)
        assert tt.dtype == torch.int32 and tmu.dtype == torch.float32


def test_mirostat_v2_keeps_everything_when_all_masked(monkeypatch):
    """mu below every candidate's surprise: the reference keeps them all."""
    sp = dict(mirostat=2, temperature=1.0)
    logits = _logits(3, v=50) * 0.01            # near-flat: surprise ~log2 50
    mu = np.full((2,), 0.5, np.float32)
    key = jax.random.PRNGKey(0)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (2, 50))))
    monkeypatch.setattr(TS, "_gumbel", lambda s, gen, device: noise)
    jt, jmu = JS.sample_mirostat(jnp.asarray(logits), key, JS.SamplingParams(**sp),
                                 jnp.asarray(mu))
    tt, tmu = TS.sample_mirostat(torch.from_numpy(logits), None,
                                 TS.SamplingParams(**sp), torch.from_numpy(mu))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    # F32 weights: the Q4_K file's int8 activation codes part the two
    # packages' logits by ~1% (a code one step off), which moves sampled
    # draws; in f32 they part by under 0.1 and every draw agrees
    return _tiny(tmp_path_factory, "F32")


def jax_noise(sp, n_tokens, v):
    """The Gumbel noise of a JAX Engine.generate's draws, one array a
    draw; none for a greedy chain."""
    if sp.greedy:
        return []
    shape = (1, min(100, v)) if sp.mirostat == 1 else (1, v)
    key = jax.random.PRNGKey(sp.seed)
    out = []
    for _ in range(n_tokens):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, shape))))
    return out


@pytest.fixture(scope="module")
def jax_generations(gguf):
    """JAX Engine.generate's ids for every case, its kernels interpreted."""
    mp = pytest.MonkeyPatch()
    orig = JA.pl.pallas_call
    mp.setattr(JA.pl, "pallas_call",
               lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mp.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        eng = j_load_engine(gguf, max_seq_len=256)
        return {case: [t for t, _ in eng.generate(
            PROMPT, max_tokens=N_NEW, sampling=JS.SamplingParams(**kw),
            stop_on_eog=False)] for case, kw in GENERATE_CASES.items()}
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.fixture(scope="module")
def engine(gguf, _one_torch_thread):  # noqa: F811
    return load_engine(gguf, device="cpu", max_seq_len=256)


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_same_tokens_as_jax(monkeypatch, engine, jax_generations, case):
    sp = TS.SamplingParams(**GENERATE_CASES[case])
    noise = iter(jax_noise(sp, N_NEW, engine.cfg.n_vocab))
    monkeypatch.setattr(TS, "_gumbel", lambda shape, gen, device: next(noise))
    got = [t for t, _ in engine.generate(PROMPT, max_tokens=N_NEW, sampling=sp,
                                         stop_on_eog=False)]
    assert got == jax_generations[case]
    assert next(noise, None) is None          # every draw took its noise


def test_penalties_change_the_greedy_tokens(engine, jax_generations):
    """The penalty window is carried: without it the greedy ids differ."""
    plain = [t for t, _ in engine.generate(
        PROMPT, max_tokens=N_NEW, sampling=TS.SamplingParams(temperature=0.0),
        stop_on_eog=False)]
    assert plain != jax_generations["penalties_greedy"]


def test_sampled_generate_is_seeded_with_mirostat(engine):
    sp = TS.SamplingParams(**GENERATE_CASES["mirostat_v2"])
    a = [t for t, _ in engine.generate(PROMPT, 12, sp, stop_on_eog=False)]
    b = [t for t, _ in engine.generate(PROMPT, 12, sp, stop_on_eog=False)]
    assert a == b and len(a) == 12


GRAMMAR = 'root ::= "The " [a-z]+ (" cat" | " dog") "."'


def test_grammar_request_same_text_as_jax_server(gguf, engine):
    """A greedy GBNF-constrained completion: the same text from both
    servers, and it parses under the grammar."""
    from llamafile_tpu.models.loader import load_llama
    from llamafile_tpu.runtime.engine import Engine as JEngine
    from llamafile_tpu.server.http import Server as JServer, _amain as j_amain
    from llamafile_tpu.utils.flags import Flags as JFlags
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    cfg, params, tok, _ = load_llama(gguf)
    jsrv = JServer(JFlags(model="tiny.gguf", slots=2, temp=0.0),
                   JEngine(cfg, params, tok, max_seq_len=256))
    port = _free_port()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(j_amain(jsrv, "127.0.0.1", port))
        except RuntimeError:
            pass
    threading.Thread(target=run, daemon=True).start()
    jbase = f"http://127.0.0.1:{port}"
    for _ in range(200):
        try:
            urllib.request.urlopen(jbase + "/v1/models", timeout=1)
            break
        except Exception:
            time.sleep(0.05)
    tsrv = Server(Flags(model="tiny.gguf", slots=2, temp=0.0, device="cpu"), engine)
    tbase, tloop = _start(tsrv)
    try:
        req = {"prompt": "Say it:", "max_tokens": 14, "temperature": 0.0,
               "grammar": GRAMMAR}
        want = _post(jbase + "/completion", req)
        got = _post(tbase + "/completion", req)
        assert got["content"] == want["content"] and len(got["content"]) > 4
        assert got["tokens_predicted"] == want["tokens_predicted"]
        assert re.fullmatch(r"The [a-z]+( ?| c| ca| cat\.?| d| do| dog\.?)",
                            got["content"]), got["content"]
    finally:
        for lp in (loop, tloop):
            lp.call_soon_threadsafe(lp.stop)
        jsrv.batcher.shutdown()
        tsrv.shutdown()


def test_grammar_request_beside_plain_requests(engine):
    """The constrained request runs on a pool thread beside the batcher's
    device thread: served together on a fresh server, it and two plain
    greedy requests each give the text they give alone, one after another
    on another fresh server. The plain prompts are token arrays of
    distinct first tokens, so no admission reuses another's prefix (a
    reused prefix takes another prefill route, whose numerics part)."""
    from concurrent.futures import ThreadPoolExecutor
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    reqs = [{"prompt": "Say it:", "max_tokens": 14, "temperature": 0.0, "grammar": GRAMMAR},
            {"prompt": [50, 61, 72, 83, 94, 105], "max_tokens": 14, "temperature": 0.0},
            {"prompt": [120, 7, 33, 99], "max_tokens": 14, "temperature": 0.0}]
    texts = []
    for together in (True, False):
        srv = Server(Flags(model="tiny.gguf", slots=3, temp=0.0, device="cpu"), engine)
        base, loop = _start(srv)
        try:
            text = lambda r: _post(base + "/v1/completions", r)["choices"][0]["text"]
            if together:
                with ThreadPoolExecutor(3) as ex:
                    texts.append(list(ex.map(text, reqs)))
            else:
                texts.append([text(r) for r in reqs])
            assert srv.batcher.stats["reused_tokens"] == 0
        finally:
            loop.call_soon_threadsafe(loop.stop)
            srv.shutdown()
    assert texts[0] == texts[1] and all(texts[1])
