"""Cross-request embedding micro-batcher of the port.

Counterpart of llamafile_tpu/server/embed.py for causal-LM embeddings (the
bert encoder's branch is not ported). Concurrent /v1/embeddings and
/embedding requests collect into ONE padded forward a tick, bucketed by
batch (BATCH_BUCKETS) and by length (the Engine's prefill buckets), and
each request gets its slice of the result: the batch width, not threads,
earns the throughput.

The forward runs on the EmbedBatcher's own thread, beside the continuous
batcher's device thread; both launch on the card's default stream. The
launch counters of ops/*.py (`fn.launches += 1`) are not atomic across the
two threads, so a count that must be exact is taken while only one of them
runs.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
MAX_BATCH = BATCH_BUCKETS[-1]


def batch_bucket(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return MAX_BATCH


class _Pending:
    __slots__ = ("texts", "event", "result", "error")

    def __init__(self, texts):
        self.texts = texts
        self.event = threading.Event()
        self.result: Optional[list] = None
        self.error: Optional[BaseException] = None


class EmbedBatcher:
    """Collects concurrent embed() calls into one forward a tick.

    embed_many: List[str | ids] -> List[vector] (one padded batched forward);
    its `device` attribute, when present, returns the vectors on the device
    without waiting for them. tokenize: when given, embed() tokenizes in the
    caller's thread. window_ms: the wait for stragglers after the first
    request; while the device runs a batch, new arrivals pile up in the
    queue and the next tick drains them all, so batches grow to the
    concurrency level. A batch of n texts over a batch bucket is split at
    the largest bucket <= n, the rest carried into the next tick. With
    `device`, a batch is finalized (pulled to the host, its callers woken)
    after the next batch is dispatched, so that pull overlaps the device's
    work."""

    def __init__(self, embed_many: Callable[[List[str]], list],
                 max_batch: int = MAX_BATCH, window_ms: float = 2.0,
                 tokenize: Optional[Callable[[str], list]] = None):
        self.embed_many = embed_many
        self.max_batch = max_batch
        self.window_ms = window_ms
        self.tokenize = tokenize
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "texts": 0}
        self._stop = False
        self._carry: List[_Pending] = []   # overflow past a bucket boundary
        self._prev = None                  # pipelined batch awaiting its pull
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def embed(self, texts: List[str]) -> list:
        """Blocking: one vector per text (called from the pool's threads)."""
        if not texts:
            return []
        items = [self.tokenize(t) for t in texts] if self.tokenize else list(texts)
        p = _Pending(items)
        self.q.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def shutdown(self):
        self._stop = True
        self.q.put(None)
        self._thread.join(timeout=5)

    def _collect(self):
        """The next batch: the carry, or the first request and what piled up
        behind it, split at the floor bucket. None at shutdown."""
        if self._carry:
            batch, self._carry = self._carry, []
            n = sum(len(p.texts) for p in batch)
        else:
            try:
                first = self.q.get_nowait()
            except queue.Empty:
                if self._prev is not None:     # going idle: flush the pipeline
                    self._finalize(*self._prev)
                first = self.q.get()
            if first is None:
                return None
            batch, n = [first], len(first.texts)
        deadline = time.time() + self.window_ms / 1000.0
        while n < self.max_batch:
            try:
                p = self.q.get_nowait()
            except queue.Empty:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    p = self.q.get(timeout=left)
                except queue.Empty:
                    break
            if p is None:
                self._stop = True
                break
            batch.append(p)
            n += len(p.texts)
        # a 34-text batch would pad to 64 rows: run an exact 32 and carry the
        # rest into the next tick, which also drains new arrivals
        floor_b = max((b for b in BATCH_BUCKETS if b <= n), default=n)
        if n > floor_b:
            cnt = 0
            for i, p in enumerate(batch):
                if cnt + len(p.texts) > floor_b and cnt > 0:
                    self._carry = batch[i:]
                    return batch[:i]
                cnt += len(p.texts)
        return batch

    def _loop(self):
        while not self._stop:
            batch = self._collect()
            if batch is None:
                break
            texts = [t for p in batch for t in p.texts]
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["texts"] += len(texts)
            dev_fn = getattr(self.embed_many, "device", None)
            try:
                if dev_fn is not None:
                    vecs = dev_fn(texts)
                    if self._prev is not None:
                        self._finalize(*self._prev)
                    self._prev = (batch, vecs)
                    continue
                vecs = self.embed_many(texts)
                i = 0
                for p in batch:
                    p.result = list(vecs[i:i + len(p.texts)])
                    i += len(p.texts)
            except BaseException as e:          # deliver, do not kill the loop
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    if not p.event.is_set() and (p.result is not None
                                                 or p.error is not None):
                        p.event.set()
        if self._prev is not None:
            self._finalize(*self._prev)
        for p in self._carry:              # rolled past shutdown: fail loudly
            p.error = RuntimeError("EmbedBatcher shut down")
            p.event.set()
        self._carry = []

    def _finalize(self, batch, vecs):
        try:
            a = _host64(vecs)
            i = 0
            for p in batch:
                p.result = a[i:i + len(p.texts)].tolist()
                i += len(p.texts)
        except BaseException as e:
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.event.set()
            self._prev = None


def _host64(vecs: torch.Tensor) -> np.ndarray:
    return vecs.cpu().numpy().astype(np.float64)


@torch.no_grad()
def pooled(params, cfg, tokens: torch.Tensor, lens: torch.Tensor, cache) -> torch.Tensor:
    """One fresh prefill over tokens [B, T] with the hidden states returned,
    then each row's mean over its first lens[r] positions, unit-normalized,
    on the device: f32 [B, d] (the reference's _pooled_jit). The cache is
    written in place; a fresh prefill reads only the rows it writes, so a
    cache of the same shape is reused from batch to batch."""
    from ..models.llama import forward
    b, t = tokens.shape
    hidden, _ = forward(params, cfg, tokens, torch.zeros(b, dtype=torch.int32,
                                                         device=tokens.device),
                        cache, fresh_prefill=True, return_hidden=True)
    mask = (torch.arange(t, device=tokens.device)[None, :] < lens[:, None]).float()
    v = (hidden * mask[:, :, None]).sum(1) / mask.sum(1)[:, None]
    return v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)


def llama_embed_many(engine) -> Callable[[List[str]], list]:
    """Batched causal-LM embeddings: one padded forward for the whole batch,
    a masked mean over each row's real tokens, unit-normalized (the
    reference server's embedding.cpp semantics). Texts are strings or token
    id lists, cut to max_seq_len - 1 tokens; the batch pads to its batch
    bucket and its longest text's prefill bucket."""
    from ..models.llama import init_cache
    from ..runtime.engine import bucket_len

    caches = {}                  # (rows, bucket) -> the cache reused

    def _device(texts: List[str]) -> torch.Tensor:
        """One padded batched forward -> [n, d] on the device (returns as
        soon as the work is queued on a CUDA device)."""
        idl = [t if isinstance(t, list) else engine.tokenizer.encode(t) for t in texts]
        idl = [i[: engine.max_seq_len - 1] for i in idl]
        t = bucket_len(max(1, max(len(i) for i in idl)))
        bb = batch_bucket(len(texts))
        toks = torch.zeros((bb, t), dtype=torch.int32)
        lens = torch.ones((bb,), dtype=torch.int32)   # pad rows: no 0-division
        for r, ids in enumerate(idl):
            toks[r, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
            lens[r] = max(1, len(ids))
        if (bb, t) not in caches:
            caches[(bb, t)] = init_cache(engine.cfg, bb, t, device=engine.device)
        v = pooled(engine.params, engine.cfg, toks.to(engine.device),
                   lens.to(engine.device), caches[(bb, t)])
        return v[:len(texts)]

    def embed_many(texts: List[str]) -> list:
        return _host64(_device(texts)).tolist()

    embed_many.device = _device
    return embed_many
