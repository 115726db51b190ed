"""The port's HTTP server (llamafile_tpu_torch.server.http) in process on a
free port, on the CPU, over a tiny Q4_K GGUF (d_model 256, d_ff 1024,
head_dim 128; a byte vocabulary, one token a character). The same fixture
shape as tests/test_server.py. One greedy completion is held against the
JAX package's server on the same GGUF: the texts must be equal.
"""
import asyncio
import concurrent.futures as cf
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

import tests.conftest  # noqa: F401

from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.server.http import Server, _amain
from llamafile_tpu_torch.utils.flags import Flags
from tests.util_models import make_tiny_llama_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 256


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(srv):
    port = _free_port()
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(_amain(srv, "127.0.0.1", port))
        except RuntimeError:
            pass    # loop.stop() from the teardown thread

    threading.Thread(target=run, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(200):
        try:
            urllib.request.urlopen(base + "/health", timeout=1)
            break
        except Exception:
            time.sleep(0.05)
    return base, loop


@pytest.fixture(scope="module")
def server(gguf):
    eng = load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)
    srv = Server(Flags(model="tiny.gguf", slots=2, temp=0.0, device="cpu"), eng)
    base, loop = _start(srv)
    yield base, srv
    loop.call_soon_threadsafe(loop.stop)
    srv.shutdown()


def _post(url, obj, headers=None, raw=None):
    req = urllib.request.Request(url, data=raw if raw is not None
                                 else json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _status(url, obj=None, raw=None, method=None):
    data = raw if raw is not None else (None if obj is None else json.dumps(obj).encode())
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_health_models_flagz_slotz_metrics(server):
    base, _ = server
    assert json.loads(_get(base + "/health"))["status"] == "ok"
    assert json.loads(_get(base + "/v1/models"))["data"][0]["object"] == "model"
    flagz = json.loads(_get(base + "/flagz"))
    assert flagz["slots"] == 2 and flagz["device"] == "cpu"
    slotz = json.loads(_get(base + "/slotz"))
    assert len(slotz["slots"]) == 2 and slotz["cache"]["page_size"] == 64
    assert "llamafile_tpu_requests_total" in _get(base + "/metrics")


def test_tokenize_detokenize(server):
    base, _ = server
    out = _post(base + "/tokenize", {"content": "hello"})
    assert isinstance(out["tokens"], list) and out["tokens"]
    assert "hello" in _post(base + "/detokenize", {"tokens": out["tokens"]})["content"]


def _sse(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps({**obj, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read().decode()
    events = [l[6:] for l in body.splitlines() if l.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _text_of(events, chat):
    if chat:
        return "".join(e["choices"][0]["delta"].get("content", "") for e in events)
    return "".join(e["choices"][0]["text"] for e in events)


@pytest.mark.parametrize("chat", [False, True], ids=["text", "chat"])
@pytest.mark.parametrize("stream", [False, True], ids=["plain", "sse"])
def test_completion_with_stop_string(server, chat, stream):
    base, _ = server
    path = "/v1/chat/completions" if chat else "/v1/completions"
    body = ({"messages": [{"role": "user", "content": "hi there"}]} if chat
            else {"prompt": "Once upon a time"})
    body.update(max_tokens=12, temperature=0.0)
    full = _post(base + path, body)
    text = (full["choices"][0]["message"]["content"] if chat
            else full["choices"][0]["text"])
    assert full["object"] == ("chat.completion" if chat else "text_completion")
    assert full["usage"]["completion_tokens"] == 12 and len(text) >= 6
    stop = text[4:6]
    cut = text.find(stop)
    if stream:
        events = _sse(base, path, {**body, "stop": [stop]})
        got = _text_of(events, chat)
        assert events[-1]["choices"][0]["finish_reason"] == "stop"
    else:
        out = _post(base + path, {**body, "stop": stop})
        got = (out["choices"][0]["message"]["content"] if chat
               else out["choices"][0]["text"])
        assert out["choices"][0]["finish_reason"] == "stop"
    assert got == text[:cut] and stop not in got


def test_completion_token_array_and_legacy(server):
    base, srv = server
    ids = srv.engine.tokenizer.encode("Once upon a time")
    a = _post(base + "/v1/completions", {"prompt": ids, "max_tokens": 5,
                                          "temperature": 0})
    b = _post(base + "/v1/completions", {"prompt": "Once upon a time",
                                          "max_tokens": 5, "temperature": 0})
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    leg = _post(base + "/completion", {"prompt": "Once upon a time",
                                       "n_predict": 5, "temperature": 0})
    assert leg["content"] == b["choices"][0]["text"] and leg["tokens_predicted"] == 5


def test_concurrent_requests_batched(server):
    base, srv = server
    steps0 = srv.batcher.stats["decode_steps"]

    def go(_):
        return _post(base + "/v1/completions", {"prompt": "hello", "max_tokens": 16,
                                                "temperature": 0.0},
                     headers={"X-Priority": "batch"})
    with cf.ThreadPoolExecutor(3) as ex:
        outs = list(ex.map(go, range(3)))
    texts = {o["choices"][0]["text"] for o in outs}
    assert len(texts) == 1 and all(o["usage"]["completion_tokens"] == 16 for o in outs)
    # three 16-token streams over two rows share decode steps
    assert srv.batcher.stats["decode_steps"] - steps0 < 3 * 16


def test_404_bad_json_body_cap_and_429(server, monkeypatch):
    base, srv = server
    assert _status(base + "/nope")[0] == 404
    assert _status(base + "/v1/chat/completions", raw=b"{not json")[0] == 400
    monkeypatch.setattr(srv, "MAX_BODY", 100)
    assert _status(base + "/v1/completions", {"prompt": "x" * 200})[0] == 413
    monkeypatch.setattr(srv.bucket, "acquire", lambda ip: False)
    assert _status(base + "/health")[0] == 429


@pytest.mark.parametrize("path,body,method", [
    ("/v1/embeddings", {"input": "hi"}, None),
    ("/embedding", {"content": "hi"}, None),
    ("/db/chats", None, "GET"),
    ("/slots/0?action=save", {"filename": "a"}, None),
    ("/", None, "GET"),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "grammar": "root ::= \"a\""}, None),
    ("/v1/completions", {"prompt": "hi", "response_format": {"type": "json_object"},
                         "max_tokens": 8}, None),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,AA"}}]}]},
     None),
    ("/v1/completions", {"prompt": "hi", "mirostat": 2}, None),
], ids=["embeddings", "embedding", "db", "slots", "web_ui", "grammar",
        "response_format", "image", "mirostat"])
def test_unported_features_answer_501(server, path, body, method):
    """What the port leaves out answers 501 naming it. The cases once among
    them that are ported now answer as the reference does: the embeddings
    routes 200 with a unit vector (tests/test_torch_embed.py holds them
    against the JAX package); a grammar or response_format 200 with text
    that the grammar admits (tests/test_torch_grammar.py and
    test_torch_stateful_sampling.py); /slots/ 400 on a server started
    without --state-dir (tests/test_torch_state.py); /db/ 404 on a server
    started without --db, and / 200 with the port's copy of the web UI
    (tests/test_torch_db_webui.py)."""
    base, _ = server
    code, text = _status(base + path, body, method=method)
    if path.startswith("/db/"):
        assert code == 404 and json.loads(text) == {"error": "no --db configured"}
        return
    if path == "/":
        www = os.path.join(ROOT, "llamafile_tpu_torch", "server", "www", "index.html")
        with open(www, encoding="utf-8") as f:
            assert code == 200 and text == f.read()
        return
    if path in ("/v1/embeddings", "/embedding"):
        vec = json.loads(text)["data"][0]["embedding"]
        assert code == 200 and len(vec) == 256
        assert abs(sum(v * v for v in vec) - 1.0) < 1e-6
        return
    if path.startswith("/slots/"):
        assert code == 400 and "--state-dir" in text
        return
    if body and "grammar" in body:
        out = json.loads(text)["choices"][0]
        assert code == 200 and out["message"]["content"] == "a"
        assert out["finish_reason"] == "stop"
        return
    if body and "response_format" in body:
        out = json.loads(text)["choices"][0]["text"]
        assert code == 200 and out and out[0] in '{["-0123456789tfn'
        return
    assert code == 501 and "not ported" in text


def test_greedy_text_equals_jax_server(gguf, server):
    """Both servers fresh, so neither admission reuses a cached prefix."""
    from llamafile_tpu.models.loader import load_llama
    from llamafile_tpu.runtime.engine import Engine as JEngine
    from llamafile_tpu.server.http import Server as JServer, _amain as j_amain
    from llamafile_tpu.utils.flags import Flags as JFlags
    cfg, params, tok, _ = load_llama(gguf)
    jsrv = JServer(JFlags(model="tiny.gguf", slots=2, temp=0.0),
                   JEngine(cfg, params, tok, max_seq_len=MAX_LEN))
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
    tsrv = Server(Flags(model="tiny.gguf", slots=2, temp=0.0, device="cpu"),
                  server[1].engine)
    tbase, tloop = _start(tsrv)
    try:
        req = {"prompt": "The tiny model says", "max_tokens": 12, "temperature": 0.0}
        want = _post(jbase + "/v1/completions", req)["choices"][0]["text"]
        got = _post(tbase + "/v1/completions", req)["choices"][0]["text"]
        assert got == want and len(got) > 0
    finally:
        for lp in (loop, tloop):
            lp.call_soon_threadsafe(lp.stop)
        jsrv.batcher.shutdown()
        tsrv.batcher.shutdown()


def test_cli_server_answers_health(gguf):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "llamafile_tpu_torch.cli", "--server", "--device", "cpu",
         "-m", gguf, "--slots", "2", "--listen", f"127.0.0.1:{port}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            try:
                body = _get(f"http://127.0.0.1:{port}/health")
                break
            except Exception:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(proc.stderr.read().decode()[-2000:])
                time.sleep(0.2)
        assert json.loads(body)["status"] == "ok"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_other_architecture_raises_at_start(tmp_path):
    from llamafile_tpu.gguf import GGUFWriter
    path = str(tmp_path / "gpt2.gguf")
    w = GGUFWriter(path)
    w.add("general.architecture", "gpt2")
    w.write()
    with pytest.raises(NotImplementedError, match="gpt2"):
        Server(Flags(model=path, slots=1, device="cpu"))
