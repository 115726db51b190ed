"""The port's continuous batcher against the JAX package's, on the CPU.

Each batcher runs over its own package's engine, both loaded from the same
tiny GGUF (d_model 256, d_ff 1024, head_dim 128). Both run paged: the JAX
side's decode attention takes its f32 gather reference on the CPU and its
products interpret their Pallas kernels; the port runs the plain versions
of its kernels. Admission slices stay in buckets under 128 tokens (the JAX
prefill takes its einsum route there, as the port does), so greedy token
ids must be equal.
"""
import queue
import threading
import time

import pytest
import torch

import tests.conftest  # noqa: F401

from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu.server.batcher import Batcher as JBatcher
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from tests.util_models import make_tiny_llama_gguf

MAX_LEN = 256


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny-q4k.gguf")
    return make_tiny_llama_gguf(path, quant="Q4_K", d_model=256, d_ff=1024,
                                n_heads=2, n_kv_heads=1, n_layers=2)


def _engines(path, kv="bf16"):
    cfg, params, tok, _ = j_load_llama(path)
    jeng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN, kv_dtype=kv)
    teng = load_engine(path, device="cpu", max_seq_len=MAX_LEN, kv_dtype=kv)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(gguf):
    return _engines(gguf)


def _collect(req, timeout=300):
    toks = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        kind, val = req.out.get(timeout=timeout)
        if kind == "token":
            toks.append(val)
        elif kind in ("done", "error"):
            return toks, val
    raise TimeoutError(f"incomplete: {toks}")


def _prompt(seed, n):
    g = torch.Generator().manual_seed(seed)
    return [1] + torch.randint(3, 250, (n - 1,), generator=g).tolist()


def _serve(batcher, jobs):
    """Submit every (ids, sp, max_tokens) at once; the tokens of each."""
    reqs = [batcher.submit(ids, sp, n) for ids, sp, n in jobs]
    return [_collect(r)[0] for r in reqs]


@pytest.mark.parametrize("rows", [2, 3])
def test_concurrent_greedy_same_ids(engines, rows):
    jeng, teng = engines
    prompts = [_prompt(s, n) for s, n in ((1, 9), (2, 30), (3, 50), (4, 17))]
    out = {}
    for name, eng, B, SP in (("jax", jeng, JBatcher, JSP),
                             ("port", teng, TBatcher, TSP)):
        b = B(eng, rows=rows)
        try:
            out[name] = _serve(b, [(p, SP(temperature=0.0), 6) for p in prompts])
        finally:
            b.shutdown()
    assert out["port"] == out["jax"]
    assert all(len(t) == 6 for t in out["port"])


STAT_KEYS = ("reused_tokens", "shared_prefix_tokens", "shifted_tokens",
             "prefilled_tokens")


def _scripted(B, SP, eng):
    """A mid-delete context shift on row 0, then a prefix reuse on row 0 and
    a cross-row shared prefix (row 0's first page aliased by row 1)."""
    b = B(eng, rows=2, prefill_chunk=32)
    try:
        p1 = _prompt(10, 100)
        t1 = _serve(b, [(p1, SP(temperature=0.0), 4)])
        hist = p1 + t1[0]
        p3 = hist[:10] + hist[30:100] + _prompt(11, 12)[1:]
        t3 = _serve(b, [(p3, SP(temperature=0.0), 4)])
        hist = p3 + t3[0]
        p4 = hist[:90] + _prompt(12, 6)[1:]
        p5 = hist[:70] + _prompt(13, 9)[1:]
        # p4 decodes long enough to keep row 0 busy while p5 admits
        t45 = _serve(b, [(p4, SP(temperature=0.0), 20), (p5, SP(temperature=0.0), 4)])
        return t1 + t3 + t45, {k: b.describe_stats()[k] for k in STAT_KEYS}
    finally:
        b.shutdown()


def test_scripted_sequence_same_stats_and_tokens(engines):
    jeng, teng = engines
    jt, jst = _scripted(JBatcher, JSP, jeng)
    tt, tst = _scripted(TBatcher, TSP, teng)
    assert tst == jst
    assert tst["shifted_tokens"] > 0 and tst["shared_prefix_tokens"] >= 64
    assert tt == jt


def test_int8_pages_same_greedy_ids(gguf):
    jeng, teng = _engines(gguf, kv="int8")
    prompts = [_prompt(s, n) for s, n in ((5, 12), (6, 40))]
    out = {}
    for name, eng, B, SP in (("jax", jeng, JBatcher, JSP),
                             ("port", teng, TBatcher, TSP)):
        b = B(eng, rows=2)
        try:
            out[name] = _serve(b, [(p, SP(temperature=0.0), 6) for p in prompts])
        finally:
            b.shutdown()
    assert teng.kv_dtype == torch.int8
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("sp", [TSP(temperature=0.8, top_k=40, seed=7),
                                TSP(temperature=0.0)], ids=["seeded", "greedy"])
def test_same_tokens_alone_and_beside_others(engines, sp):
    _, teng = engines
    mine = (_prompt(20, 21), sp, 10)
    others = [(_prompt(21, 40), TSP(temperature=1.0, seed=3), 10),
              (_prompt(22, 5), TSP(temperature=0.0), 10)]
    runs = []
    for jobs in ([mine], [others[0], mine, others[1]]):
        b = TBatcher(teng, rows=3)
        try:
            toks = _serve(b, jobs)
        finally:
            b.shutdown()
        runs.append(toks[0] if len(jobs) == 1 else toks[1])
    assert runs[0] == runs[1] and len(runs[0]) == 10


def test_preempt_oldest_priority_and_cancel(engines):
    _, teng = engines
    g = TSP(temperature=0.0)
    # preempt-oldest: a queued normal request cancels the low-priority stream
    b = TBatcher(teng, rows=1, preempt_after=0.0)
    try:
        low = b.submit(_prompt(30, 8), g, 200, low_priority=True)
        assert low.out.get(timeout=120)[0] == "token"
        normal = b.submit(_prompt(31, 8), g, 3)
        assert _collect(low)[1] == "preempted"
        assert _collect(normal)[1] == "length"
        assert b.describe_stats()["preempted"] == 1
    finally:
        b.shutdown()
    # X-Priority: a normal request queued after a batch one is admitted first
    b = TBatcher(teng, rows=1)
    try:
        first = b.submit(_prompt(32, 8), g, 30)
        assert first.out.get(timeout=120)[0] == "token"
        batch = b.submit(_prompt(33, 8), g, 2, low_priority=True)
        normal = b.submit(_prompt(34, 8), g, 2)
        order = []
        done = threading.Event()

        def watch(name, req):
            _collect(req)
            order.append(name)
            if len(order) == 2:
                done.set()
        for name, req in (("batch", batch), ("normal", normal)):
            threading.Thread(target=watch, args=(name, req), daemon=True).start()
        _collect(first)
        assert done.wait(120)
        assert order == ["normal", "batch"]
    finally:
        b.shutdown()
    # cancellation mid-admission: stop after the first prefill slice
    b = TBatcher(teng, rows=1, prefill_chunk=16)
    try:
        req = b.submit(_prompt(35, 100), g, 4)
        kind, _ = req.out.get(timeout=120)
        assert kind == "progress"
        req.stop = True
        toks, reason = _collect(req)
        assert toks == [] and reason == "stop"
        assert not b.rows[0].active and b.rows[0].req is None
    finally:
        b.shutdown()


def test_device_fault_errors_every_waiting_request(engines, monkeypatch):
    _, teng = engines

    def fault(*a, **kw):
        raise RuntimeError("CUDA launch of paged_attention failed: cudaError 700")
    monkeypatch.setattr(TL, "forward_paged_decode", fault)
    b = TBatcher(teng, rows=1)
    reqs = [b.submit(_prompt(40 + i, 8), TSP(temperature=0.0), 5) for i in range(3)]
    t0 = time.time()
    for r in reqs:
        kind = None
        while kind not in ("error", "done"):
            kind, val = r.out.get(timeout=60)
        assert kind == "error" and "cudaError 700" in val
    assert time.time() - t0 < 30
    b.thread.join(timeout=10)
    assert not b.alive()
    late = b.submit(_prompt(50, 8), TSP(temperature=0.0), 5)
    assert late.out.get(timeout=5)[0] == "error"


def test_unported_modes_raise(engines):
    _, teng = engines
    with pytest.raises(NotImplementedError):
        TBatcher(teng, rows=1, paged=False)
    b = TBatcher(teng, rows=1)
    try:
        with pytest.raises(NotImplementedError):
            b.save_row(0, "x")
        with pytest.raises(NotImplementedError):
            b.submit([1, 2], TSP(mirostat=2), 2)
    finally:
        b.shutdown()
    with pytest.raises(queue.Empty):
        b.queue.get_nowait()


def test_out_of_memory_recovers_and_resumes(engines, monkeypatch):
    """A fault the card survives rebuilds the device state; the stream
    resumes from its host-side history and completes."""
    _, teng = engines
    real = TL.forward_paged_decode
    calls = [0]

    def once(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise torch.cuda.OutOfMemoryError("out of memory (simulated)")
        return real(*a, **kw)
    monkeypatch.setattr(TL, "forward_paged_decode", once)
    b = TBatcher(teng, rows=2)
    try:
        toks, reason = _collect(b.submit(_prompt(60, 12), TSP(temperature=0.0), 12))
        assert reason == "length" and len(toks) == 12
        assert b.describe_stats()["recoveries"] == 1 and b.alive()
    finally:
        b.shutdown()
