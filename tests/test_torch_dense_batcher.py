"""The port's continuous batcher in its dense row mode (`paged=False`)
against the JAX package's dense batcher, on the CPU.

Each batcher runs over its own package's engine, loaded from the same tiny
GGUF (d_model 256, d_ff 1024, head_dim 128, 2 layers). The rows live in the
engine's row-batched cache and every chunk is one fused decode over all
rows. The JAX side runs its Pallas kernels in interpret mode (the
monkeypatch of tests/test_torch_q4km.py), so both sides follow the decode
kernels' numerics: on its CPU fallback the JAX dense decode takes an f32
einsum instead (llamafile_tpu/ops/attention.py:334), whose greedy ids part
from the kernels' on these files. Admission slices stay under bucket 128.

Greedy ids are held equal on an F32 GGUF with the bf16 cache, and on the
Q4_K GGUF with the int8 cache. On the Q4_K GGUF with the bf16 cache they
are held equal up to a parting, and a parting must be a near tie of the
port's own logits (within 2e-2 of the largest): the int8 activation codes
of Q4_K part the two packages' logits by about 1% (the port's own
Engine.generate parts from the JAX Engine at the same step). Seeded sampled
ids run on the F32 GGUF with the JAX package's noise injected through
`_gumbel` (tests/test_torch_stateful_sampling.py).
"""
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax

from llamafile_tpu.models.loader import load_llama as j_load_llama
from llamafile_tpu.runtime.engine import Engine as JEngine
from llamafile_tpu.runtime.sampling import SamplingParams as JSP
from llamafile_tpu.server.batcher import Batcher as JBatcher
from llamafile_tpu_torch.models.llama import forward
from llamafile_tpu_torch.runtime import sampling as TS
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.runtime.sampling import SamplingParams as TSP
from llamafile_tpu_torch.server.batcher import Batcher as TBatcher
from tests.test_torch_batcher import _collect, _prompt, _serve
from tests.test_torch_engine import _tiny
from tests.test_torch_gemma2 import make_tiny_gemma2_gguf
from tests.test_torch_q4km import _interpreted, _one_torch_thread  # noqa: F401

MAX_LEN = 256
PROMPTS = [_prompt(s, n) for s, n in ((1, 9), (2, 30), (3, 50), (4, 17))]
N_NEW = 6


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return _tiny(tmp_path_factory, "Q4_K")


@pytest.fixture(scope="module")
def gguf_f32(tmp_path_factory):
    return _tiny(tmp_path_factory, "F32")


_JAX_RUNS = {}


def _jax_dense(path, kv, rows, jobs):
    """Token ids of each (ids, JSP, n) job served together by the JAX dense
    batcher, its kernels interpreted (memoized: the runs are slow)."""
    key = (path, kv, rows, repr(jobs))
    if key not in _JAX_RUNS:
        def run():
            cfg, params, tok, _ = j_load_llama(path)
            eng = JEngine(cfg, params, tok, max_seq_len=MAX_LEN, kv_dtype=kv)
            b = JBatcher(eng, rows=rows, paged=False)
            try:
                assert not b.paged_mode
                return _serve(b, jobs)
            finally:
                b.shutdown()
        _JAX_RUNS[key] = _interpreted(run)
    return _JAX_RUNS[key]


_ENGINES = {}


def _engine(path, kv="bf16"):
    if (path, kv) not in _ENGINES:
        _ENGINES[path, kv] = load_engine(path, device="cpu", max_seq_len=MAX_LEN,
                                         kv_dtype=kv)
    return _ENGINES[path, kv]


def _port_dense(eng, rows, jobs):
    b = TBatcher(eng, rows=rows, paged=False)
    try:
        assert not b.paged_mode and b.pages is None
        return _serve(b, jobs)
    finally:
        b.shutdown()


def _greedy_jobs(SP):
    return [(p, SP(temperature=0.0), N_NEW) for p in PROMPTS]


def _next_logits(eng, ids):
    """The port's logits after ids (prefill, then one decode step)."""
    cache = eng.new_cache()
    _, cache = eng.prefill(cache, ids[:-1])
    pos = torch.tensor([len(ids) - 1], dtype=torch.int32)
    logits, _ = forward(eng.params, eng.cfg, torch.tensor([[ids[-1]]], dtype=torch.int32),
                        pos, cache, attn_len=MAX_LEN)
    return logits[0, 0]


@pytest.mark.parametrize("case,rows", [
    ("q4k-bf16", 1), ("q4k-bf16", 2), ("q4k-bf16", 4),
    ("q4k-int8", 2), ("f32-bf16", 4)])
def test_greedy_ids_equal_jax_dense(gguf, gguf_f32, case, rows):
    quant, kv = case.split("-")
    path = gguf_f32 if quant == "f32" else gguf
    eng = _engine(path, kv)
    got = _port_dense(eng, rows, _greedy_jobs(TSP))
    want = _jax_dense(path, kv, rows, _greedy_jobs(JSP))
    assert all(len(t) == N_NEW for t in got)
    if case != "q4k-bf16":
        assert got == want
        return
    partings = 0
    for p, g, w in zip(PROMPTS, got, want):
        k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if k is None:
            continue
        partings += 1
        if k:
            logits = _next_logits(eng, p + g[:k])
        else:                    # the first token comes from the prefill
            logits, _ = eng.prefill(eng.new_cache(), p)
        assert int(logits.argmax()) == g[k]
        gap = float(logits[g[k]] - logits[w[k]])
        assert 0 <= gap <= 2e-2 * float(logits.abs().max()), (k, gap)
    assert partings <= 1


class _JaxStream:
    """A request's JAX key stream in place of its torch.Generator: each draw
    splits the key and takes gumbel(sub) (the JAX batcher's admission split,
    then one split a decode step)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def gumbel(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


def test_seeded_sampled_ids_equal_jax_dense(gguf_f32, monkeypatch):
    """Two seeded requests and a greedy one served together at 3 rows."""
    knobs = [dict(temperature=0.9, top_k=40, seed=7),
             dict(temperature=0.7, top_p=0.9, repeat_penalty=1.2, seed=11),
             dict(temperature=0.0)]
    jobs = lambda SP: [(p, SP(**kw), 10) for p, kw in zip(PROMPTS[1:], knobs)]
    want = _jax_dense(gguf_f32, "bf16", 3, jobs(JSP))
    real = TS._gumbel
    monkeypatch.setattr(TS, "_gumbel", lambda shape, gen, device: (
        gen.gumbel(shape) if isinstance(gen, _JaxStream) else real(shape, gen, device)))
    monkeypatch.setattr(TBatcher, "_req_gen", lambda self, req: _JaxStream(req.sp.seed))
    got = _port_dense(_engine(gguf_f32), 3, jobs(TSP))
    assert got == want and all(len(t) == 10 for t in got)
    assert got[0] != got[2][:10]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_same_ids_alone_and_beside_others(gguf, kv):
    eng = _engine(gguf, kv)
    mine = (_prompt(20, 21), TSP(temperature=0.8, top_k=40, seed=7), 10)
    others = [(_prompt(21, 40), TSP(temperature=1.0, seed=3), 12),
              (_prompt(22, 5), TSP(temperature=0.0), 4)]
    alone = _port_dense(eng, 3, [mine])[0]
    together = _port_dense(eng, 3, [others[0], mine, others[1]])
    assert together[1] == alone and len(alone) == 10
    assert together[2] == _port_dense(eng, 1, [others[1]])[0]


def test_parked_row_kv_survives(gguf):
    """A finished row parks at S - 1 while another row decodes: its cache
    rows [0, S - 1) stay as they were (the counterpart of
    tests/test_batcher_fidelity.py:151)."""
    eng = _engine(gguf)
    b = TBatcher(eng, rows=2, paged=False)
    try:
        first, _ = _collect(b.submit(_prompt(30, 20), TSP(temperature=0.0), 5))
        r0 = next(i for i, r in enumerate(b.rows) if r.history)
        before = (b.cache.k[:, r0].clone(), b.cache.v[:, r0].clone())
        # no common prefix with row r0's history: the empty row takes it
        toks, _ = _collect(b.submit(_prompt(31, 12)[1:], TSP(temperature=0.0), 40))
        assert len(toks) == 40 and b.stats["decode_steps"] >= 40
        assert not b.rows[r0].active and len(b.rows[r0].history) == 25
        s = MAX_LEN - 1
        for now, was in zip((b.cache.k[:, r0], b.cache.v[:, r0]), before):
            assert torch.equal(now[:, :s], was[:, :s])
            assert not torch.equal(now[:, s], was[:, s])     # the trash slot
    finally:
        b.shutdown()


IDS = [1, 5, 9, 13, 17, 21, 25, 29]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_dense_save_restore_erase_roundtrip(gguf, tmp_path, kv):
    """As tests/test_state_resume.py:50 with paged=False: a continuation from
    a restored row equals greedy from scratch, and the prefix is reused."""
    eng = _engine(gguf, kv)
    f = str(tmp_path / f"row_{kv}.npz")
    g = TSP(temperature=0.0)
    b = TBatcher(eng, rows=2, paged=False)
    try:
        want, _ = _collect(b.submit(IDS, g, 8))
        assert b.save_row(0, f)["tokens"] == len(IDS) + 8
        assert b.erase_row(0)["erased_tokens"] == len(IDS) + 8
        assert b.describe()[0]["history_tokens"] == 0
        assert "pages" not in b.describe()[0] and "free_pages" not in b.describe_stats()
    finally:
        b.shutdown()
    b2 = TBatcher(eng, rows=2, paged=False)
    try:
        assert b2.restore_row(f)["tokens"] == len(IDS) + 8
        got, _ = _collect(b2.submit(IDS, g, 8))
        assert got == want
        assert b2.stats["reused_tokens"] >= len(IDS) - 1
    finally:
        b2.shutdown()
    other = _engine(gguf, "int8" if kv == "bf16" else "bf16")
    b3 = TBatcher(other, rows=1, paged=False)
    try:
        with pytest.raises(RuntimeError, match="quantization"):
            b3.restore_row(f)
    finally:
        b3.shutdown()
    if kv == "int8":                 # an int8 row never restores into pages
        b4 = TBatcher(other, rows=1)
        try:
            with pytest.raises(RuntimeError, match="int8 row state"):
                b4.restore_row(f)
        finally:
            b4.shutdown()


@pytest.fixture(scope="module")
def gguf_gemma2(tmp_path_factory):
    return make_tiny_gemma2_gguf(str(tmp_path_factory.mktemp("g2") / "tiny-gemma2.gguf"))


def test_gemma2_dense_equals_jax_and_paged_refuses(gguf_gemma2):
    """Windowed layers (window 8) under the dense mode, past the window."""
    eng = load_engine(gguf_gemma2, device="cpu", max_seq_len=MAX_LEN)
    jobs = lambda SP: [(p, SP(temperature=0.0), 10) for p in PROMPTS[:3]]
    got = _port_dense(eng, 2, jobs(TSP))
    assert got == _jax_dense(gguf_gemma2, "bf16", 2, jobs(JSP))
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TBatcher(eng, rows=2)             # paged=None keeps the paged pool
