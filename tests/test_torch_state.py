"""Session state of the port (llamafile_tpu_torch/runtime/state.py) against
the JAX package's, on the CPU: the `.npz` files move between the packages
both ways (bf16 and int8, trimmed to the history and re-padded on load);
Engine.generate(prompt_cache=...) and `--cli --prompt-cache` resume with
the reference's greedy tokens, from the port's file and from the
reference's; /slots/{id}?action=save|erase|restore answers as the JAX
server does over the same tiny GGUF, and a restored row is reused at
admission with the same greedy text; then the 400, 404 and 409 answers.
"""
import os
import shutil
import subprocess
import sys
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
from llamafile_tpu.runtime import state as JST
from llamafile_tpu.runtime.kvcache import KVCache as JKV
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch.runtime import state as TST
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.kvcache import KVCache as TKV
from llamafile_tpu_torch.runtime.sampling import SamplingParams
from tests.test_torch_engine import ROOT, _tiny
from tests.test_torch_q4km import _one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_server import _free_port, _post, _start, _status

GREEDY = SamplingParams(temperature=0.0)
PROMPT = "The tiny model keeps its state"
MAX_LEN = 256


def _caches(int8, s=40, seed=0):
    """The same random cache in both packages: [L, B, S, ...] leaves."""
    rng = np.random.default_rng(seed)
    if int8:
        k = rng.integers(-127, 128, (2, 1, s, 2, 8), dtype=np.int8)
        v = rng.integers(-127, 128, (2, 1, s, 2, 8), dtype=np.int8)
        ks = rng.random((2, 1, s, 2), np.float32)
        vs = rng.random((2, 1, s, 2), np.float32)
        return (JKV(*(jnp.asarray(a) for a in (k, v, ks, vs))),
                TKV(*(torch.from_numpy(a) for a in (k, v, ks, vs))))
    k = rng.standard_normal((2, 1, s, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1, s, 16)).astype(np.float32)
    return (JKV(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), None, None),
            TKV(torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()))


def _leaves(c):
    return [np.asarray(jax.device_get(a)).view(np.uint16)
            if str(getattr(a, "dtype", "")) == "bfloat16" else
            (a.view(torch.int16).numpy().view(np.uint16) if isinstance(a, torch.Tensor)
             and a.dtype == torch.bfloat16 else np.asarray(a))
            for a in (c.k, c.v, c.k_scale, c.v_scale) if a is not None]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_files_move_between_packages(tmp_path, writer, int8):
    jc, tc = _caches(int8)
    hist = list(range(3, 28))                    # 25 of the 40 positions
    path = str(tmp_path / "s.npz")
    if writer == "jax":
        JST.save_state(path, jc, hist)
    else:
        TST.save_state(path, tc, hist)
    z = np.load(path)
    assert sorted(z.files) == sorted([f"leaf{i}" for i in range(4 if int8 else 2)]
                                     + ["history", "quantized", "dtypes"])
    assert z["leaf0"].shape[2] == len(hist)       # trimmed to the history
    assert z["history"].dtype == np.int64
    for max_len in (0, 40, 64):
        jl, jh = JST.load_state(path, max_len=max_len)
        tl, th = TST.load_state(path, max_len=max_len)
        assert th == jh == hist
        assert tl.quantized == jl.quantized == int8
        for a, b in zip(_leaves(tl), _leaves(jl)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the loaded prefix is the saved cache's, the padding zeros
    tl, _ = TST.load_state(path, max_len=64)
    for a, b in zip(_leaves(tl), _leaves(tc)):
        np.testing.assert_array_equal(a[:, :, :len(hist)], b[:, :, :len(hist)])
        assert not a[:, :, len(hist):].any()


# -- Engine.generate(prompt_cache=...) and --cli --prompt-cache -------------

@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    # F32 weights: on the Q4_K file the int8 activation codes of the two
    # packages part their logits by ~1% (a code one step off), which flips
    # greedy ids for some prompts, this one among them
    return _tiny(tmp_path_factory, "F32")


@pytest.fixture(scope="module")
def engine(gguf, _one_torch_thread):  # noqa: F811
    return load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)


@pytest.fixture(scope="module")
def jax_runs(gguf, tmp_path_factory):
    """The JAX Engine's greedy ids (its kernels interpreted): the prompt
    cold into a session file, the prompt again from it, an extension of
    the prompt from it, and the file it wrote."""
    from llamafile_tpu.runtime.engine import load_engine as j_load_engine
    d = tmp_path_factory.mktemp("jax_session")
    f = str(d / "session.npz")
    mp = pytest.MonkeyPatch()
    orig = JA.pl.pallas_call
    mp.setattr(JA.pl, "pallas_call",
               lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    mp.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    try:
        eng = j_load_engine(gguf, max_seq_len=MAX_LEN)
        run = lambda p, **kw: [t for t, _ in eng.generate(
            p, max_tokens=8, sampling=JSP(temperature=0.0), stop_on_eog=False, **kw)]
        out = {"cold": run(PROMPT, prompt_cache=f), "file": str(d / "cold_copy.npz")}
        shutil.copy(f, out["file"])
        shutil.copy(f, str(d / "after_cold.npz"))
        out["warm"] = run(PROMPT, prompt_cache=f)
        out["ext"] = run(PROMPT + " on disk", prompt_cache=str(d / "after_cold.npz"))
        eng8 = j_load_engine(gguf, max_seq_len=MAX_LEN, kv_dtype="int8")
        f8 = str(d / "int8.npz")
        run8 = lambda p: [t for t, _ in eng8.generate(
            p, max_tokens=8, sampling=JSP(temperature=0.0), stop_on_eog=False,
            prompt_cache=f8)]
        out["int8"] = [run8(PROMPT), run8(PROMPT + " on disk")]
        return out
    finally:
        mp.undo()
        jax.clear_caches()


def test_prompt_cache_resumes_with_the_reference_tokens(engine, jax_runs, tmp_path):
    f = str(tmp_path / "session.npz")
    n = len(engine.tokenizer.encode(PROMPT))
    run = lambda p, path: [t for t, _ in engine.generate(
        p, max_tokens=8, sampling=GREEDY, stop_on_eog=False, prompt_cache=path)]
    assert run(PROMPT, f) == jax_runs["cold"] and engine.last_prompt_reuse == 0
    _, hist = TST.load_state(f)
    assert hist == engine.tokenizer.encode(PROMPT)
    assert run(PROMPT, f) == jax_runs["warm"] == jax_runs["cold"]
    assert engine.last_prompt_reuse == n - 1      # one token short of the prompt
    ext = str(tmp_path / "ext.npz")
    shutil.copy(f, ext)
    assert run(PROMPT + " on disk", ext) == jax_runs["ext"]
    assert engine.last_prompt_reuse == n
    # the reference's file resumes in the port
    theirs = str(tmp_path / "theirs.npz")
    shutil.copy(jax_runs["file"], theirs)
    assert run(PROMPT + " on disk", theirs) == jax_runs["ext"]
    assert engine.last_prompt_reuse == n


def test_prompt_cache_int8_kv(gguf, jax_runs, tmp_path):
    """An int8 KV cache: the file holds codes and scales, and the resumed
    prefill (pos0 > 0 over the int8 cache) gives the reference's ids."""
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN, kv_dtype="int8")
    f = str(tmp_path / "int8.npz")
    run = lambda p: [t for t, _ in eng.generate(p, max_tokens=8, sampling=GREEDY,
                                                stop_on_eog=False, prompt_cache=f)]
    assert run(PROMPT) == jax_runs["int8"][0] and eng.last_prompt_reuse == 0
    c, _ = TST.load_state(f)
    assert c.quantized and c.k.dtype == torch.int8 and c.k_scale.dtype == torch.float32
    assert run(PROMPT + " on disk") == jax_runs["int8"][1]
    assert eng.last_prompt_reuse == len(eng.tokenizer.encode(PROMPT))


@pytest.mark.parametrize("bad", ["corrupt", "int8", "other_model"])
def test_prompt_cache_mismatch_recomputes(engine, jax_runs, tmp_path, bad):
    """A corrupt file, an int8 file for a bf16 engine or another model's
    layout: the prompt is recomputed (the same tokens), and the file is
    rewritten."""
    f = str(tmp_path / "bad.npz")
    if bad == "corrupt":
        open(f, "wb").write(b"not an npz")
    else:
        _, tc = _caches(bad == "int8")
        TST.save_state(f, tc, engine.tokenizer.encode(PROMPT))
    got = [t for t, _ in engine.generate(PROMPT, max_tokens=8, sampling=GREEDY,
                                         stop_on_eog=False, prompt_cache=f)]
    assert got == jax_runs["cold"] and engine.last_prompt_reuse == 0
    c, hist = TST.load_state(f)
    assert not c.quantized and c.k.shape[0] == engine.cfg.n_layers


def test_cli_prompt_cache_resumes(gguf, engine, jax_runs, tmp_path):
    f = str(tmp_path / "cli.npz")
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1"}
    texts = []
    for _ in range(2):
        r = subprocess.run(
            [sys.executable, "-m", "llamafile_tpu_torch.cli", "--device", "cpu", "--cli",
             "-m", gguf, "-p", PROMPT, "-n", "8", "--temp", "0", "-c", str(MAX_LEN),
             "--prompt-cache", f, "--repeat-penalty", "1.0"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        texts.append(r.stdout)
        assert os.path.exists(f)
    want = "".join(engine.tokenizer.decode_token(t).decode("utf-8", errors="replace")
                   for t in jax_runs["cold"])
    assert texts[0].rstrip("\n") == texts[1].rstrip("\n") == want


# -- /slots/{id}?action= -----------------------------------------------------

def _jax_server(gguf, state_dir):
    from llamafile_tpu.models.loader import load_llama
    from llamafile_tpu.runtime.engine import Engine as JEngine
    from llamafile_tpu.server.http import Server as JServer, _amain as j_amain
    from llamafile_tpu.utils.flags import Flags as JFlags
    import asyncio
    cfg, params, tok, _ = load_llama(gguf)
    srv = JServer(JFlags(model="tiny.gguf", slots=2, temp=0.0, state_dir=state_dir),
                  JEngine(cfg, params, tok, max_seq_len=MAX_LEN))
    port = _free_port()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(j_amain(srv, "127.0.0.1", port))
        except RuntimeError:
            pass
    threading.Thread(target=run, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(200):
        try:
            urllib.request.urlopen(base + "/v1/models", timeout=1)
            break
        except Exception:
            time.sleep(0.05)
    return base, srv, loop


def _slot_script(base):
    """A completion, save row 0, erase it, restore it, the completion
    again; returns every answer."""
    req = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.0}
    out = [_post(base + "/v1/completions", req)["choices"][0]["text"]]
    for action, body in (("save", {"filename": "../escape/row.npz"}), ("erase", {}),
                         ("restore", {"filename": "row.npz"})):
        r = _post(base + f"/slots/0?action={action}", body)
        if "filename" in r:
            r["filename"] = os.path.basename(r["filename"])
        out.append(r)
    out.append(_post(base + "/v1/completions", req)["choices"][0]["text"])
    return out


def test_slots_save_erase_restore_as_the_jax_server(gguf, engine, tmp_path):
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jbase, jsrv, jloop = _jax_server(gguf, jdir)
    tsrv = Server(Flags(model="tiny.gguf", slots=2, temp=0.0, device="cpu",
                        state_dir=tdir), engine)
    tbase, tloop = _start(tsrv)
    try:
        want = _slot_script(jbase)
        reused0 = tsrv.batcher.stats["reused_tokens"]
        got = _slot_script(tbase)
        assert got == want
        assert got[0] == got[-1] and len(got[0]) > 0
        assert os.listdir(tdir) == ["row.npz"]            # the basename only
        n = len(engine.tokenizer.encode(PROMPT))
        assert tsrv.batcher.stats["reused_tokens"] - reused0 >= n - 1
        metrics = urllib.request.urlopen(tbase + "/metrics", timeout=30).read().decode()
        assert f"llamafile_tpu_prefix_tokens_reused_total {n - 1}" in metrics
        # the JAX server's file restores in the port, and the reuse holds
        shutil.copy(os.path.join(jdir, "row.npz"), os.path.join(tdir, "theirs.npz"))
        assert _post(tbase + "/slots/0?action=erase", {})["row"] == 0
        assert _post(tbase + "/slots/1?action=erase", {})["row"] == 1
        r = _post(tbase + "/slots/1?action=restore", {"filename": "theirs.npz"})
        assert r["tokens"] == want[1]["tokens"]
        again = _post(tbase + "/v1/completions", {"prompt": PROMPT, "max_tokens": 8,
                                                  "temperature": 0.0})
        assert again["choices"][0]["text"] == want[0]
    finally:
        for lp in (jloop, tloop):
            lp.call_soon_threadsafe(lp.stop)
        jsrv.batcher.shutdown()
        tsrv.shutdown()


def test_slots_400_404_409(engine, tmp_path):
    from llamafile_tpu_torch.server.http import Server
    from llamafile_tpu_torch.utils.flags import Flags
    plain = Server(Flags(model="tiny.gguf", slots=1, temp=0.0, device="cpu"), engine)
    pbase, ploop = _start(plain)
    d = str(tmp_path / "state")
    srv = Server(Flags(model="tiny.gguf", slots=1, temp=0.0, device="cpu", state_dir=d),
                 engine)
    base, loop = _start(srv)
    try:
        code, text = _status(pbase + "/slots/0?action=save", {"filename": "a.npz"})
        assert code == 400 and "--state-dir" in text
        for path, body, code, what in (
                ("/slots/x?action=save", {"filename": "a.npz"}, 400, "slot id"),
                ("/slots/5?action=save", {"filename": "a.npz"}, 400, "slot id"),
                ("/slots/0?action=fly", {"filename": "a.npz"}, 400, "action"),
                ("/slots/0?action=save", {}, 400, "filename"),
                ("/slots/0?action=restore", {"filename": "none.npz"}, 404, "no such"),
                ("/slots/0?action=save", {"filename": "a.npz"}, 409, "no cached state")):
            got = _status(base + path, body)
            assert got[0] == code and what in got[1], (path, got)
        assert _status(base + "/slots/0?action=save", method="GET")[0] == 405
        # an int8 file does not restore into the paged pool
        _, tc = _caches(True)
        os.makedirs(d, exist_ok=True)
        TST.save_state(os.path.join(d, "i8.npz"), tc, [1, 2, 3])
        code, text = _status(base + "/slots/0?action=restore", {"filename": "i8.npz"})
        assert code == 409 and "int8" in text
        # a busy row: saving it while its request decodes
        req = srv.batcher.submit(engine.tokenizer.encode(PROMPT), GREEDY, 200)
        deadline = time.time() + 60
        while srv.batcher.rows[0].req is None and time.time() < deadline:
            time.sleep(0.005)
        code, text = _status(base + "/slots/0?action=save", {"filename": "b.npz"})
        assert code == 409 and "busy" in text
        req.stop = True
        while req.out.get(timeout=60)[0] != "done":
            pass
    finally:
        for lp in (ploop, loop):
            lp.call_soon_threadsafe(lp.stop)
        plain.shutdown()
        srv.shutdown()


def test_batcher_control_fails_after_shutdown(engine, tmp_path):
    from llamafile_tpu_torch.server.batcher import Batcher
    b = Batcher(engine, rows=1)
    b.shutdown()
    with pytest.raises(RuntimeError, match="stopped"):
        b.erase_row(0)
