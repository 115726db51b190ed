"""The port's chat modes against the JAX package's, on the CPU: ChatSession
over three turns, the REPL over scripted stdin, --chat --server, --tokenize
and --version.

Both sides load one tiny F32 GGUF (d_model 256, d_ff 1024, head_dim 128, 2
layers): its greedy ids agree between the packages (the Q4_K file's int8
activation codes part the logits by about 1%). The JAX side runs its Pallas
kernels in interpret mode (tests/test_torch_q4km.py's `_interpreted`), so
both decode on the kernels' numerics. Every turn after the first leaves
more than one token to prefill: a one-token suffix runs as a decode step in
the port and as a bucket-16 prefill in the reference (ROADMAP C, the
parity trap), which part by up to 2e-2 of the largest logit.
"""
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import tests.conftest  # noqa: F401

from llamafile_tpu.runtime.chat import apply_chat_template as j_template
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu_torch import cli as TC
from llamafile_tpu_torch.runtime.chat import apply_chat_template
from llamafile_tpu_torch.runtime.engine import ChatSession, load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.utils.flags import parse_flags
from tests.test_torch_engine import ROOT, _tiny
from tests.test_torch_q4km import _interpreted, _one_torch_thread  # noqa: F401

MAX_LEN = 512
TURNS = ["hello there", "tell me more about it", "and then what happened next?"]
N_NEW = 12


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return _tiny(tmp_path_factory, "F32")


def _conversation(template_fn, tok, session, sp):
    """Three turns; (ids, reused_last, cached_len) of each."""
    messages, out = [], []
    for text in TURNS:
        messages.append({"role": "user", "content": text})
        prompt = template_fn(messages, tok.chat_template)
        ids = [t for t, _ in session.generate(tok.encode(prompt), max_tokens=N_NEW,
                                              sampling=sp, stop_on_eog=False)]
        out.append((ids, session.reused_last, session.cached_len))
        messages.append({"role": "assistant", "content": tok.decode(ids)})
    return out


@pytest.fixture(scope="module")
def jax_conversation(gguf):
    def run():
        from llamafile_tpu.runtime.engine import ChatSession as JChat, load_engine as jl
        eng = jl(gguf, max_seq_len=MAX_LEN)
        return _conversation(j_template, eng.tokenizer, JChat(eng),
                             JSP(temperature=0.0))
    return _interpreted(run)


def test_chat_session_same_ids_and_reuse(gguf, jax_conversation):
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    session = ChatSession(eng)
    got = _conversation(apply_chat_template, eng.tokenizer, session,
                        TSP(temperature=0.0))
    assert got == jax_conversation
    assert all(len(ids) == N_NEW for ids, _, _ in got)
    assert got[0][1] == 0 and 0 < got[1][1] <= got[0][2] and got[2][1] > got[1][1]
    # each later turn prefills more than one token
    tok = eng.tokenizer
    msgs = []
    for i, (text, (ids, _, _)) in enumerate(zip(TURNS, got)):
        msgs += [{"role": "user", "content": text}]
        n = len(tok.encode(apply_chat_template(msgs, tok.chat_template)))
        assert n - got[i][1] > 1
        msgs += [{"role": "assistant", "content": tok.decode(ids)}]


def test_chat_session_reuse_rules(gguf):
    """keep = min(common prefix, cached_len); the whole prompt cached keeps
    all but one token; no common prefix starts a new cache."""
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    s = ChatSession(eng)
    g = TSP(temperature=0.0)
    ids = eng.tokenizer.encode("a prompt of some length")
    first = [t for t, _ in s.generate(ids, max_tokens=5, sampling=g, stop_on_eog=False)]
    assert s.reused_last == 0 and s.cached_len == len(ids) + 4
    assert s.ids == ids + first
    again = [t for t, _ in s.generate(ids, max_tokens=5, sampling=g, stop_on_eog=False)]
    assert s.reused_last == len(ids) - 1 and again == first
    cache = s.cache
    other = [2, 9, 9, 9]
    list(s.generate(other, max_tokens=2, sampling=g, stop_on_eog=False))
    assert s.reused_last == 0 and s.cache is not cache
    fresh = ChatSession(eng)
    want = [t for t, _ in fresh.generate(ids + first + [5, 6], max_tokens=5,
                                         sampling=g, stop_on_eog=False)]
    s2 = ChatSession(eng)
    list(s2.generate(ids, max_tokens=5, sampling=g, stop_on_eog=False))
    got = [t for t, _ in s2.generate(ids + first + [5, 6], max_tokens=5,
                                     sampling=g, stop_on_eog=False)]
    assert s2.reused_last == len(ids) + 4 and got == want


def _script(tmp_path):
    f = tmp_path / "notes.txt"
    f.write_text("the secret word is zanzibar")
    img = tmp_path / "x.png"
    img.write_bytes(b"\x89PNG fake")
    # tests/test_cli_chat.py's scripts, then every other command
    return (f"hello\n/upload {f}\n/push\n/stack\n/pop\n/stack\n"
            f"/upload {tmp_path}/missing.txt\n/upload {img}\n/help\n/context\n"
            "what did you read?\n/stats\n/undo\n/context\n/forget\n/push\n/push\n"
            "/stack\n/clear\n/frob\n/upload\n/quit\n")


def _normalize(text):
    """The /stats line's seconds and rate differ run to run."""
    return re.sub(r"tokens in [0-9.]+s \([0-9.]+ tok/s\)", "tokens in Ts (R tok/s)", text)


ARGS = ["-n", "3", "--temp", "0", "--ctx-size", str(MAX_LEN)]


def test_repl_lines_equal_reference(gguf, tmp_path, monkeypatch, capsys):
    from llamafile_tpu import cli as JC
    from llamafile_tpu.utils.flags import parse_flags as j_parse
    script = _script(tmp_path)

    def run():
        monkeypatch.setattr(sys, "stdin", io.StringIO(script))
        return JC.run_chat(j_parse(["-m", gguf] + ARGS))
    assert _interpreted(run) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    assert TC.main(["--chat", "-m", gguf, "--device", "cpu"] + ARGS) == 0
    got = capsys.readouterr().out
    assert _normalize(got) == _normalize(want)
    for line in ("shared ", "pushed @", "@3 messages", "popped", "stack empty",
                 "no such file", "needs --mmproj", "unknown command /frob",
                 "usage: /upload FILE", "tokens used", "cleared", "undone",
                 "forgot oldest exchange"):
        assert line in got, line


def test_repl_image_with_mmproj_not_ported(gguf, tmp_path):
    img = tmp_path / "x.png"
    img.write_bytes(b"\x89PNG fake")
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    flags = parse_flags(["-m", gguf, "--mmproj", "mm.gguf"])
    out = io.StringIO()
    assert TC.chat_loop(eng, flags, io.StringIO(f"/upload {img}\n"), out) == 0
    assert "not ported" in out.getvalue() and "image input" in out.getvalue()


def test_chat_with_background_server(gguf):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": str(torch.get_num_threads())}
    proc = subprocess.Popen(
        [sys.executable, "-m", "llamafile_tpu_torch.cli", "--chat", "--server",
         "--device", "cpu", "--listen", f"127.0.0.1:{port}", "--model", gguf,
         "-n", "2", "--ctx-size", str(MAX_LEN)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env)
    try:
        deadline = time.time() + 120
        ok = False
        while time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models",
                                            timeout=2) as r:
                    ok = json.loads(r.read())["data"][0]["object"] == "model"
                    break
            except Exception:
                time.sleep(0.5)
        assert ok, "background server never came up"
        out, err = proc.communicate(input="hello\n/exit\n", timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert out.count(">>> ") == 2 and "listening on" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_tokenize_and_version(gguf, capsys, monkeypatch, tmp_path):
    from llamafile_tpu import cli as JC
    from llamafile_tpu.utils.flags import parse_flags as j_parse
    from llamafile_tpu.version import VERSION_STRING
    text = "Hello, world! <s> 12"
    assert JC.run_tokenize(j_parse(["-m", gguf, "-p", text])) == 0
    want = capsys.readouterr().out
    assert TC.main(["--tokenize", "-m", gguf, "-p", text]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 10
    assert TC.main(["--version"]) == 0
    assert capsys.readouterr().out == VERSION_STRING + "\n"
    # --trace, once refused with exit code 2, is ported: the run completes
    # and registers the trace's write at exit
    import atexit
    from llamafile_tpu_torch.utils import tracing
    at_exit = []
    monkeypatch.setattr(atexit, "register", at_exit.append)
    monkeypatch.setattr(tracing, "_tracer", None)
    assert TC.main(["--cli", "-m", gguf, "--device", "cpu", "-p", "hi", "-n", "1",
                    "--trace", str(tmp_path / "t.json")]) == 0
    assert len(at_exit) == 1
