"""The port's chat persistence (server/db.py, the /db/* routes under --db)
and its static web UI against the JAX package's, on the CPU.

`Db` runs the same operations on both packages' classes; the HTTP routes
run the sequence of tests/test_server.py::test_db_routes on both servers
(each over its own package's engine of one tiny GGUF) and must answer the
same JSON, the `created_at` timestamps aside. `/` serves the port's copy
of the web UI, byte for byte the reference's file.
"""
import asyncio
import json
import os
import socket
import threading
import time

import pytest

import tests.conftest  # noqa: F401

from llamafile_tpu.server.db import Db as JDb
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.server.db import SCHEMA, Db
from llamafile_tpu_torch.server.http import Server, _amain
from llamafile_tpu_torch.utils.flags import Flags
from tests.test_torch_q4km import _one_torch_thread  # noqa: F401 — module fixture
from tests.test_torch_server import ROOT, _start, _status

MAX_LEN = 256
REF_WWW = os.path.join(ROOT, "llamafile_tpu", "server", "www", "index.html")
PORT_WWW = os.path.join(ROOT, "llamafile_tpu_torch", "server", "www", "index.html")


def _strip(obj):
    """obj without its created_at timestamps (both packages stamp their own
    rows)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "created_at"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _db_script(db):
    """Every operation of Db, and what each returns."""
    out = []
    a = db.create_chat("m.gguf", "first")
    b = db.create_chat("m.gguf")
    out += [a, b]
    out.append(db.add_message(a, "user", "hi"))
    out.append(db.add_message(a, "assistant", "hello", temperature=0.7, top_p=0.9,
                              presence_penalty=0.5, frequency_penalty=0.25))
    out.append(db.add_message(b, "user", "other"))
    db.set_title(b, "second")
    out.append(db.list_chats())
    out.append(db.list_chats(limit=1))
    out.append(db.get_chat(a))
    out.append(db.get_chat(99))
    out.append(db.list_messages(a))
    db.delete_chat(a)
    out.append(db.list_chats())
    out.append(db.list_messages(a))
    out.append(dict(db.conn().execute(
        "SELECT value FROM metadata WHERE key='version'").fetchone()))
    return _strip(out)


def test_db_same_results_as_reference(tmp_path):
    import llamafile_tpu.server.db as JD
    assert SCHEMA == JD.SCHEMA
    startup = tmp_path / "startup.sql"
    startup.write_text("INSERT INTO metadata (key, value) VALUES ('owner', 'x');")
    port = Db(str(tmp_path / "port.db"), startup_sql=str(startup))
    ref = JDb(str(tmp_path / "ref.db"), startup_sql=str(startup))
    assert _db_script(port) == _db_script(ref)
    got = port.conn().execute("SELECT value FROM metadata WHERE key='owner'").fetchone()
    assert tuple(got) == ("x",)

    # one connection a thread, as the reference keeps
    seen = []
    t = threading.Thread(target=lambda: seen.append(port.conn()))
    t.start()
    t.join()
    assert seen[0] is not port.conn()


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    from tests.util_models import make_tiny_llama_gguf
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


def _req(base, path, obj=None, method=None):
    code, text = _status(base + path, obj, method=method)
    return code, _strip(json.loads(text))


def _routes(base):
    """tests/test_server.py::test_db_routes, then the rest of the routes."""
    out = []
    code, made = _req(base, "/db/chats", {"title": "test chat"})
    out.append((code, made))
    cid = made["id"]
    out.append(_req(base, f"/db/chats/{cid}/messages", {"role": "user", "content": "hi"}))
    out.append(_req(base, f"/db/chats/{cid}/messages", {"role": "assistant",
                                                       "content": "yo",
                                                       "temperature": 0.5}))
    out.append(_req(base, f"/db/chats/{cid}"))
    out.append(_req(base, "/db/chats"))
    out.append(_req(base, f"/db/chats/{cid}/messages"))
    out.append(_req(base, "/db/chats/77"))
    out.append(_req(base, "/db/nope"))
    out.append(_req(base, f"/db/chats/{cid}", method="DELETE"))
    out.append(_req(base, "/db/chats"))
    return out


def _jax_server(gguf, flags):
    from llamafile_tpu.models.loader import load_llama
    from llamafile_tpu.runtime.engine import Engine as JEngine
    from llamafile_tpu.server.http import Server as JServer, _amain as j_amain
    cfg, params, tok, _ = load_llama(gguf)
    srv = JServer(flags, JEngine(cfg, params, tok, max_seq_len=MAX_LEN))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(j_amain(srv, "127.0.0.1", port))
        except RuntimeError:
            pass
    threading.Thread(target=run, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(600):             # up to 30 s for the thread to serve
        try:
            if _status(base + "/health")[0] == 200:
                break
        except OSError:             # refused: the thread has not bound its socket yet
            pass
        time.sleep(0.05)
    else:
        raise AssertionError(f"the reference's server at {base} never answered /health")
    return base, loop, srv


@pytest.fixture(scope="module")
def port_engine(gguf):
    return load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)


def _port_server(port_engine, **kw):
    srv = Server(Flags(model="tiny.gguf", slots=1, device="cpu", **kw), port_engine)
    base, loop = _start(srv)
    return base, loop, srv


def test_db_routes_same_as_reference(gguf, port_engine, tmp_path):
    from llamafile_tpu.utils.flags import Flags as JFlags
    base, loop, srv = _port_server(port_engine, db=str(tmp_path / "port.db"))
    try:
        got = _routes(base)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.shutdown()
    jbase, jloop, jsrv = _jax_server(gguf, JFlags(model="tiny.gguf", slots=1,
                                                  db=str(tmp_path / "ref.db")))
    try:
        want = _routes(jbase)
    finally:
        jloop.call_soon_threadsafe(jloop.stop)
        jsrv.batcher.shutdown()
    assert got == want
    assert got[3][1]["title"] == "test chat" and got[3][1]["messages"][0]["content"] == "hi"
    assert got[6][0] == 404 and got[7][0] == 404 and got[-1][1] == {"chats": []}


def _raw_get(base, target):
    """(status, head, body) of a GET of target sent as written (no client-side
    normalization of '..')."""
    host, port = base.rsplit("/", 1)[-1].split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(f"GET {target} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
                  .encode())
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), head.decode(), body


def test_web_ui_static_files(port_engine, tmp_path):
    with open(PORT_WWW, "rb") as f, open(REF_WWW, "rb") as g:
        page = f.read()
        assert page == g.read()
    base, loop, srv = _port_server(port_engine)
    try:
        code, head, body = _raw_get(base, "/")
        assert code == 200 and body == page and "Content-Type: text/html" in head
        assert _raw_get(base, "/index.html")[2] == page
        assert _raw_get(base, "/missing.js")[0] == 404
        assert _raw_get(base, "../secret.txt")[0] == 403
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.shutdown()
    # --www-root: its own files, a directory's index.html, the content types
    root = tmp_path / "www"
    (root / "sub").mkdir(parents=True)
    (root / "sub" / "index.html").write_text("<p>sub</p>")
    (root / "app.js").write_text("let x = 1;")
    (root / "data.bin").write_bytes(b"\x00\x01")
    (root / "s.css").write_text("p {}")
    base, loop, srv = _port_server(port_engine, www_root=str(root))
    try:
        assert _raw_get(base, "/sub")[2] == b"<p>sub</p>"
        for name, ct in (("app.js", "text/javascript"), ("s.css", "text/css"),
                         ("data.bin", "application/octet-stream")):
            code, head, body = _raw_get(base, "/" + name)
            assert code == 200 and f"Content-Type: {ct}" in head
            assert body == (root / name).read_bytes()
        assert _raw_get(base, "/")[0] == 404          # no index.html at its root
        assert _raw_get(base, "../www/app.js")[0] == 200
        assert _raw_get(base, "../other/app.js")[0] == 403
        # the API routes still answer
        assert _status(base + "/health")[0] == 200
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.shutdown()
