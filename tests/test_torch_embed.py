"""The port's embeddings (llamafile_tpu_torch.server.embed and the
/v1/embeddings and /embedding routes), on the CPU.

- batch_bucket, and the EmbedBatcher's collector: requests that pile up
  while a batch runs are drained at once, split at the floor bucket and
  the rest carried (35 waiting texts run as 32, 2 and 1), in arrival
  order; the pipelined
  `device` path finalizes each batch after the next one is dispatched;
- llama_embed_many against the JAX package's llama_embed_many on a tiny
  Q4_K GGUF (d 256, 2 layers, head_dim 128; its Pallas kernels in
  interpret mode): unit vectors within 1e-3 (max abs) of each other;
- batches run back to back on the reused (rows, bucket) cache, each text
  within 1e-3 (max abs) of itself embedded alone, chip_smoke.py's limit:
  the forward writes its cache in place, and a fresh prefill reads only
  the rows it writes (a stale row read would move a vector by far more);
  the CPU matmul's rows part by f32 order between batch shapes (7.5e-5);
- the HTTP response: `object`, `data[i].embedding`, `model` and
  `usage.prompt_tokens`, for `input` (a list) and `content` (a string),
  and `input` as a token array or a list of them (OpenAI's forms).
"""
import threading
import time

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.server.embed import (BATCH_BUCKETS, EmbedBatcher, batch_bucket,
                                              llama_embed_many)
from llamafile_tpu_torch.server.http import Server
from llamafile_tpu_torch.utils.flags import Flags
from tests.test_torch_gemma import _one_torch_thread  # noqa: F401
from tests.test_torch_q4km import _interpreted
from tests.test_torch_server import _post, _start
from tests.util_models import make_tiny_llama_gguf

MAX_LEN = 256
JAX_TOL = 1e-3
ALONE_TOL = 1e-3
# 33 to 63 characters: one token each and BOS, so every text takes the
# 64-token bucket alone and in a batch (the dequant GEMM's rows either way)
TEXTS = ["the quick brown fox jumps over the lazy dog, twice",
         "a tiny model embeds this sentence for the test here",
         "pack my box with five dozen liquor jugs, said the cook"]
TEXTS_B = ["sphinx of black quartz, judge my vow, said the poet",
           "how vexingly quick daft zebras jump in a tiny field"]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("embed") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


@pytest.fixture(scope="module")
def engine(gguf):
    return load_engine(gguf, device="cpu", max_seq_len=MAX_LEN)


def test_batch_bucket():
    assert BATCH_BUCKETS == (1, 2, 4, 8, 16, 32, 64)
    assert [batch_bucket(n) for n in (1, 2, 3, 5, 8, 9, 33, 64, 65, 200)] == \
        [1, 2, 4, 8, 8, 16, 64, 64, 64, 64]


def _fake(gate=None):
    """embed_many over strings "t<i>" -> [[i]], recording each batch; the
    first call waits for `gate`."""
    seen = []

    def embed_many(texts):
        if gate is not None and not seen:
            gate.wait(10)
        seen.append(list(texts))
        return [[float(t[1:])] for t in texts]
    return embed_many, seen


def _wait_queued(b, n):
    for _ in range(500):
        if b.q.qsize() >= n:
            return
        time.sleep(0.01)
    raise AssertionError(f"{b.q.qsize()} of {n} requests queued")


def test_collector_drains_splits_at_floor_bucket_and_carries():
    gate = threading.Event()
    fn, seen = _fake(gate)
    b = EmbedBatcher(fn, window_ms=1.0)
    out = {}
    try:
        first = threading.Thread(target=lambda: out.setdefault(0, b.embed(["t0"])))
        first.start()
        for _ in range(500):          # the first batch is running (held at the gate)
            if b.stats["batches"]:
                break
            time.sleep(0.01)
        threads = [threading.Thread(target=lambda i=i: out.setdefault(i, b.embed([f"t{i}"])))
                   for i in range(1, 36)]
        for i, t in enumerate(threads):
            t.start()
            _wait_queued(b, i + 1)    # queued in order
        gate.set()
        for t in [first] + threads:
            t.join(10)
    finally:
        b.shutdown()
    assert [len(s) for s in seen] == [1, 32, 2, 1]
    assert [t for s in seen for t in s] == [f"t{i}" for i in range(36)]
    assert all(out[i] == [[float(i)]] for i in range(36))
    assert b.stats == {"requests": 36, "batches": 4, "texts": 36}


def test_pipelined_device_path():
    """With `device`, a batch's vectors reach its callers after the next
    batch is dispatched, or when the collector goes idle; a request of
    several texts gets its own slice."""
    calls = []

    def embed_many(texts):
        raise AssertionError("the pipelined path calls device")

    def device(texts):
        calls.append(list(texts))
        return torch.tensor([[float(len(t)), 1.0] for t in texts])
    embed_many.device = device
    b = EmbedBatcher(embed_many)
    try:
        assert b.embed(["ab", "abcd"]) == [[2.0, 1.0], [4.0, 1.0]]
        assert b.embed(["abc"]) == [[3.0, 1.0]]
    finally:
        b.shutdown()
    assert calls == [["ab", "abcd"], ["abc"]]


def test_llama_embed_many_matches_jax(gguf, engine):
    from llamafile_tpu.models.loader import load_llama as j_load_llama
    from llamafile_tpu.runtime.engine import Engine as JEngine
    from llamafile_tpu.server.embed import llama_embed_many as j_embed_many

    def run():
        cfg, params, tok, _ = j_load_llama(gguf)
        return np.asarray(j_embed_many(JEngine(cfg, params, tok, max_seq_len=MAX_LEN))(TEXTS))
    want = _interpreted(run)
    got = np.asarray(llama_embed_many(engine)(TEXTS))
    assert got.shape == (3, 256) and want.shape == got.shape
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert np.abs(got - want).max() <= JAX_TOL


def test_batches_back_to_back_equal_alone(engine):
    """The (rows, bucket) cache is reused: batch A (3 texts, 4 rows of 64)
    then batch B (2 texts, 2 rows) then A's shape again with B's texts
    first; every vector equals its text embedded alone."""
    em = llama_embed_many(engine)
    alone = {t: np.asarray(em([t])[0]) for t in TEXTS + TEXTS_B}
    runs = [TEXTS, TEXTS_B, TEXTS_B + TEXTS[:1]]
    for texts in runs:
        got = em(texts)
        for t, v in zip(texts, got):
            assert np.abs(np.asarray(v) - alone[t]).max() <= ALONE_TOL, t


def test_http_embedding_routes(gguf, engine):
    srv = Server(Flags(model="tiny.gguf", slots=2, temp=0.0, device="cpu"), engine)
    base, loop = _start(srv)
    try:
        a = _post(base + "/v1/embeddings", {"input": TEXTS[:2]})
        c = _post(base + "/embedding", {"content": TEXTS[2]})
        ids = engine.tokenizer.encode(TEXTS[0])
        one, two = (_post(base + "/v1/embeddings", {"input": x}) for x in (ids, [ids, ids]))
    finally:
        loop.call_soon_threadsafe(loop.stop)
        srv.shutdown()
    want = llama_embed_many(engine)(TEXTS)
    tok = engine.tokenizer
    for r, texts, idx in ((a, TEXTS[:2], (0, 1)), (c, TEXTS[2:], (2,))):
        assert r["object"] == "list" and r["model"] == "tiny.gguf"
        assert r["usage"]["prompt_tokens"] == sum(len(tok.encode(t)) for t in texts)
        assert [d["index"] for d in r["data"]] == list(range(len(texts)))
        for d, i in zip(r["data"], idx):
            assert d["object"] == "embedding" and len(d["embedding"]) == 256
            assert np.abs(np.asarray(d["embedding"]) - np.asarray(want[i])).max() <= ALONE_TOL
    # the token-array forms (one array, or a list of arrays) embed those ids
    assert one["usage"]["prompt_tokens"] == len(ids) and len(two["data"]) == 2
    for d in one["data"] + two["data"]:
        assert np.abs(np.asarray(d["embedding"]) - np.asarray(want[0])).max() <= ALONE_TOL
