"""Continuous batcher of the port: one fused decode step across all active
requests, over a paged KV pool.

Counterpart of llamafile_tpu/server/batcher.py in its paged mode, for llama
engines:

- a paged KV pool (runtime/paged.py, bf16 or int8 pages) shared by R =
  --slots rows through host-side block tables; page 0 is the trash page;
- admission prefills a request into a dense single-row cache in
  PREFILL_CHUNK slices that interleave with decode chunks, reusing the
  row's previous history as a prefix cache, another row's full-page prefix
  (shared, refcounted pages) and a mid-delete context shift (relocated,
  re-rotated K), then copies the row into its pages;
- every active row advances together in a decode chunk of n steps of
  forward_paged_decode -> sample_batched -> penalty_window_push, with
  per-row positions, sampling knobs and random streams; the chunk's tokens
  stay on the device and are read back once a chunk;
- inactive rows park on the trash page, so the fused step never touches a
  live page.

Each request draws from its own torch.Generator, seeded from its seed: a
seeded request gives the same tokens served alone or beside others.

The JAX package's dense (non-paged) mode, recurrent rows and the row state
save/restore/erase (runtime/state.py) are not ported and raise
NotImplementedError. A device fault after which the card still works
(torch.cuda.OutOfMemoryError) is recovered as in the reference: the device
state is rebuilt and the interrupted requests resume. Any other exception
on the device thread ends it, and every waiting request, and any request
submitted afterwards, gets an ("error", message) event at once.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..runtime.sampling import (PenaltyWindow, SamplingParams,
                                penalty_window_init, penalty_window_push,
                                row_params_from_sp, sample, sample_batched)
from .slots import common_prefix_len

DECODE_CHUNK = 8
PREFILL_CHUNK = 512        # admission slice (reference n_batch analog)
PAGE_SIZE = 64             # KV page granularity
PENALTY_RING = 256         # shared ring width (per-row last_n clamps to it)
RELOC_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _reloc_bucket(n: int) -> int:
    for b in RELOC_BUCKETS:
        if n <= b:
            return b
    return RELOC_BUCKETS[-1]


@torch.no_grad()
def _fused_decode_paged(engine, tok, pos, pages, tables, pw, gens, rp,
                        n_steps: int) -> torch.Tensor:
    """n_steps decode steps over all rows; returns tokens int32 [n_steps, R]
    on the device. pages and pw are updated in place."""
    from ..models.llama import forward_paged_decode
    toks = torch.empty((n_steps, tok.shape[0]), dtype=torch.int32,
                       device=tok.device)
    for i in range(n_steps):
        logits, _ = forward_paged_decode(engine.params, engine.cfg, tok, pos,
                                         pages, tables)
        nxt = sample_batched(logits, gens, rp, pw.counts)
        penalty_window_push(pw, nxt)
        toks[i] = nxt
        tok, pos = nxt, pos + 1
    return toks


@dataclass
class Request:
    ids: List[int]
    sp: SamplingParams
    max_tokens: int
    out: "queue.Queue" = field(default_factory=queue.Queue)
    stop: bool = False                # cooperative cancel
    low_priority: bool = False        # X-Priority: batch (preempted first)
    started: float = 0.0              # admission time (preempt-oldest order)
    preempted: bool = False           # finished by preemption, not EOG/len


@dataclass
class Row:
    history: List[int] = field(default_factory=list)
    pos: int = 0
    req: Optional[Request] = None
    active: bool = False              # False while admission prefill runs
    emitted: int = 0
    last_used: float = 0.0            # LRU tie-break for row selection


@dataclass
class Admission:
    """In-flight chunked prefill (state between loop iterations)."""
    req: Request
    ridx: int
    ids: List[int]
    keep: int
    fed: int = 0
    row_cache: object = None


class Batcher:
    """Background device thread running admission + fused decode."""

    def __init__(self, engine, rows: int = 4, paged: Optional[bool] = None,
                 prefill_chunk: int = PREFILL_CHUNK,
                 preempt_after: float = -1.0):
        if paged is False or not getattr(engine, "supports_paged", False):
            raise NotImplementedError("the batcher's dense (non-paged) mode "
                                      "is not ported yet")
        if getattr(engine, "recurrent", False) or getattr(engine.cfg, "alibi", False):
            raise NotImplementedError("recurrent and ALiBi engines are not "
                                      "ported to the batcher yet")
        self.engine = engine
        self.cfg = engine.cfg
        self.device = engine.device
        self.prefill_chunk = prefill_chunk
        self.rows = [Row() for _ in range(rows)]
        self.n_rows = rows
        self.max_len = engine.max_seq_len
        self._init_device_state()
        self.queue: "queue.Queue[Request]" = queue.Queue()
        # X-Priority: batch requests admit only when the normal queue is empty
        self.batch_queue: "queue.Queue[Request]" = queue.Queue()
        self.wake = threading.Event()
        self._stop = False
        self._dead: Optional[BaseException] = None
        self._admissions = 0
        self.stats = {"prefilled_tokens": 0, "reused_tokens": 0,
                      "shifted_tokens": 0, "shared_prefix_tokens": 0,
                      "last_chunk": 0, "full_chunks": 0, "preempted": 0,
                      # tallies of what ran on the device, by kind
                      "decode_steps": 0, "slices_by_bucket": {},
                      "fresh_slices_by_bucket": {}}
        self.admission: Optional[Admission] = None
        self._pending: Optional[Request] = None
        # preempt-oldest-when-busy (reference worker.cpp:59-65): a normal
        # request waiting longer than preempt_after seconds cancels the
        # oldest active stream, X-Priority: batch streams first. < 0 queues.
        self.preempt_after = preempt_after
        self._pending_since = 0.0
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="batcher")
        self.thread.start()

    def _init_device_state(self):
        """(Re)build every device-resident tensor: the KV pool, penalty
        windows, logit-bias table and the rows' generators. Called at
        construction and by _recover after a device fault."""
        from ..runtime.paged import PageAllocator, init_paged
        rows, dev, v = self.n_rows, self.device, self.cfg.n_vocab
        maxp = -(-self.max_len // PAGE_SIZE)
        n_pages = 1 + rows * maxp
        self.pages = init_paged(self.cfg.n_layers, self.cfg.n_kv_heads, n_pages,
                                PAGE_SIZE, self.cfg.head_dim,
                                dtype=self.engine.kv_dtype, device=dev)
        self.alloc = PageAllocator(n_pages, PAGE_SIZE, rows, self.max_len)
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        self.pw = PenaltyWindow(z((rows, v), torch.float32),
                                z((rows, PENALTY_RING), torch.int32),
                                z((rows,), torch.int32), z((rows,), torch.int32))
        self.bias = z((rows, v), torch.float32)
        self.row_gens: List[Optional[torch.Generator]] = [None] * rows

    # -- public API ---------------------------------------------------------

    def submit(self, ids: List[int], sp: SamplingParams, max_tokens: int,
               low_priority: bool = False) -> Request:
        if sp.mirostat:
            raise NotImplementedError("mirostat is not ported to the batcher")
        req = Request(ids=list(ids), sp=sp, max_tokens=max_tokens,
                      low_priority=low_priority)
        (self.batch_queue if low_priority else self.queue).put(req)
        self.wake.set()
        if self._dead is not None:      # the device thread is gone
            self._fail_waiting()
        return req

    def save_row(self, ridx: int, path: str) -> dict:
        raise NotImplementedError("row state save (runtime/state.py) is not "
                                  "ported yet")

    def restore_row(self, path: str) -> dict:
        raise NotImplementedError("row state restore (runtime/state.py) is "
                                  "not ported yet")

    def erase_row(self, ridx: int) -> dict:
        raise NotImplementedError("row state erase is not ported yet")

    def alive(self) -> bool:
        return self.thread.is_alive() and self._dead is None

    def shutdown(self):
        self._stop = True
        self.wake.set()
        self.thread.join(timeout=10)

    # -- admission (chunked prefill state machine) --------------------------

    def _req_gen(self, req: Request) -> torch.Generator:
        """Per-request random stream: deterministic for an explicit seed,
        unique per admission otherwise (seed < 0 = random, the reference's
        LLAMA_DEFAULT_SEED semantics)."""
        gen = torch.Generator(device=self.device)
        if req.sp.seed < 0:
            gen.manual_seed((time.time_ns() ^ (self._admissions << 32))
                            & 0x7FFFFFFFFFFFFFFF)
        else:
            gen.manual_seed(req.sp.seed)
        return gen

    def _table(self, pages: List[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.int32, device=self.device)

    def _start_admission(self, req: Request) -> bool:
        from ..runtime.paged import gather_pages_to_row
        free = [r for r in self.rows if r.req is None]
        if not free:
            return False
        # row selection (reference server slot policy): longest matching
        # prefix wins; with no match prefer an EMPTY row over evicting another
        # request's retained prefix cache, then the least-recently-used row
        row = max(free, key=lambda r: (common_prefix_len(r.history, req.ids),
                                       not r.history, -r.last_used))
        row.last_used = time.time()
        ids = req.ids
        if len(ids) >= self.max_len - 2:
            ids = ids[-max(1, self.max_len - req.max_tokens - 2):]
        keep = common_prefix_len(row.history, ids)
        ridx = self.rows.index(row)
        keep = self._maybe_share_prefix(ridx, row, ids, keep)
        keep = self._paged_prepare(ridx, row, ids, keep)
        if keep == len(ids):
            keep = len(ids) - 1
        row_cache = self.engine.new_row_cache(dtype=torch.bfloat16)
        if keep:
            self.alloc.truncate(ridx, keep)
            k, v = gather_pages_to_row(self.pages,
                                       self._table(self.alloc.tables[ridx]),
                                       PAGE_SIZE, self.max_len)
            row_cache.k.copy_(k)
            row_cache.v.copy_(v)
        row.req = req
        row.active = False
        req.started = time.time()
        self._admissions += 1
        self.stats["reused_tokens"] += keep
        self.admission = Admission(req, ridx, ids, keep, 0, row_cache)
        return True

    def _maybe_share_prefix(self, ridx: int, row: Row, ids: List[int],
                            keep: int) -> int:
        """Cross-row shared-prefix admission (reference: the system prompt's
        KV is computed once and referenced by every slot): when another
        row's history shares a longer FULL-PAGE prefix with the new prompt,
        alias the donor's prefix pages into this row's table (refcounted).
        Also rounds keep down to a page boundary when the boundary page is
        shared, so later writes never land inside an aliased page."""
        ps = PAGE_SIZE
        best, bkeep = None, keep
        for r2 in self.rows:
            if r2 is row or not r2.history:
                continue
            # the donor's trailing token has no KV written yet: clamp to len-1
            cmatch = min(common_prefix_len(r2.history, ids),
                         len(r2.history) - 1)
            cfull = (cmatch // ps) * ps
            if cfull > bkeep:
                best, bkeep = r2, cfull
        if best is not None:
            ridx2 = self.rows.index(best)
            self.alloc.release(ridx)
            self.alloc.share_prefix(ridx2, ridx, bkeep // ps)
            row.history = list(ids[:bkeep])
            self.stats["shared_prefix_tokens"] += bkeep
            keep = bkeep
        kp = keep // ps
        tbl = self.alloc.tables[ridx]
        if keep % ps and kp < len(tbl) and self.alloc.is_shared(tbl[kp]):
            keep = kp * ps
        if keep == 0 and self.alloc.tables[ridx]:
            # nothing reusable: drop the whole table now, so no stale aliased
            # page survives into this row's write-back
            self.alloc.release(ridx)
            row.history = []
        return keep

    def _paged_prepare(self, ridx: int, row: Row, ids: List[int],
                       keep: int) -> int:
        """Context-shift reuse beyond the common prefix: when the new prompt
        deletes a middle span of the row's history but keeps its suffix
        (reference slot.cpp:291-424), relocate the cached suffix down by the
        delta (rope-shifted K) instead of recomputing it. Returns the new
        keep length."""
        from ..runtime.paged import find_mid_delete, relocate_span
        hit = find_mid_delete(row.history, ids, keep)
        if hit is None:
            return keep
        # the relocation writes from position `keep`: refuse when that lands
        # in aliased (shared-prefix) pages
        if keep // PAGE_SIZE < self.alloc.shared_page_count(ridx):
            return keep
        j, reuse = hit
        self.stats["shifted_tokens"] += reuse
        relocate_span(self.pages, self.cfg,
                      self._table(self.alloc.tables[ridx] + [0] * 4), j, keep,
                      _reloc_bucket(reuse))
        row.history = list(ids[:keep + reuse])
        self.alloc.lengths[ridx] = keep + reuse
        return keep + reuse

    def _advance_admission(self):
        """Feed ONE prefill slice; on completion activate the row."""
        from ..runtime.engine import attn_bucket, bucket_len
        from ..runtime.paged import copy_row_to_pages
        a = self.admission
        row = self.rows[a.ridx]
        if a.req.stop:                 # cancelled mid-admission
            a.req.out.put(("done", "preempted" if a.req.preempted else "stop"))
            row.req = None
            self.admission = None
            return
        pos0 = a.keep + a.fed
        new = a.ids[pos0:pos0 + self.prefill_chunk]
        b = bucket_len(len(new))
        toks = torch.zeros((1, b), dtype=torch.int32)
        toks[0, :len(new)] = torch.tensor(new, dtype=torch.int32)
        fresh = pos0 == 0
        alen = None if fresh else attn_bucket(pos0 + b + 1, self.max_len)
        dev = self.device
        logits, a.row_cache = self.engine.row_prefill(
            toks.to(dev), torch.tensor([pos0], dtype=torch.int32, device=dev),
            a.row_cache, fresh=fresh, attn_len=alen,
            last_idx=torch.tensor([max(0, len(new) - 1)], dtype=torch.int32,
                                  device=dev))
        a.fed += len(new)
        st = self.stats
        st["prefilled_tokens"] += len(new)
        by = st["fresh_slices_by_bucket" if fresh else "slices_by_bucket"]
        by[b] = by.get(b, 0) + 1
        if a.keep + a.fed < len(a.ids):
            # prefill progress for long prompts (reference x_prefill_progress
            # SSE events, v1_chat_completions.cpp:630-644)
            a.req.out.put(("progress", (a.keep + a.fed, len(a.ids))))
            return
        # finalize: penalty window from the context tail, the request's
        # generator, its first token
        self.admission = None
        sp = a.req.sp
        v = self.cfg.n_vocab
        row_pw = penalty_window_init(a.ids, v, sp.penalty_last_n,
                                     ring_size=PENALTY_RING, device=dev)
        gen = self._req_gen(a.req)
        tok0 = int(sample(logits[0, 0][None, :], gen, sp, row_pw.counts)[0])
        row_pw = penalty_window_init(a.ids + [tok0], v, sp.penalty_last_n,
                                     ring_size=PENALTY_RING, device=dev)
        self.alloc.ensure(a.ridx, len(a.ids))
        self.alloc.lengths[a.ridx] = len(a.ids)
        # aliased (shared-prefix) pages are read-only: their dense-row values
        # came from those very pages, so their writes go to the trash page
        tbl = [0 if self.alloc.is_shared(p) else p
               for p in self.alloc.tables[a.ridx]]
        copy_row_to_pages(self.pages, a.row_cache.k, a.row_cache.v,
                          self._table(tbl), PAGE_SIZE)
        bias_row = np.zeros((v,), np.float32)
        for t, x in sp.logit_bias:
            if 0 <= t < v:
                bias_row[t] += x
        r = a.ridx
        for name in ("counts", "ring", "rlen", "last_n"):
            getattr(self.pw, name)[r] = getattr(row_pw, name)[0]
        self.bias[r] = torch.from_numpy(bias_row).to(dev)
        self.row_gens[r] = gen
        row.history = list(a.ids)
        row.pos = len(a.ids)
        row.emitted = 0
        row.active = True
        self._deliver(row, tok0)

    def _preempt_oldest(self):
        """Drop the oldest active stream to make room (reference
        worker.cpp:59-65): X-Priority batch streams first, then the
        earliest admitted."""
        victims = [r for r in self.rows
                   if r.req is not None and not r.req.stop]
        if not victims:
            return
        v = min(victims, key=lambda r: (not r.req.low_priority, r.req.started))
        v.req.preempted = True
        v.req.stop = True
        self.stats["preempted"] += 1

    def _deliver(self, row: Row, tid: int):
        req = row.req
        tok = self.engine.tokenizer
        if tok.is_eog(tid) or row.pos + 1 >= self.max_len \
                or row.emitted + 1 > req.max_tokens or req.stop:
            reason = ("preempted" if req.preempted
                      else "stop" if tok.is_eog(tid) else "length")
            if not tok.is_eog(tid) and row.emitted < req.max_tokens and not req.stop:
                # emit the last token before closing on length
                row.history.append(tid)
                row.emitted += 1
                req.out.put(("token", tid))
            req.out.put(("done", reason))
            row.req = None
            row.active = False
            return
        row.history.append(tid)
        row.pos += 1
        row.emitted += 1
        req.out.put(("token", tid))

    # -- device loop --------------------------------------------------------

    def _loop(self):
        try:
            while not self._stop:
                try:
                    self._tick()
                except torch.cuda.OutOfMemoryError as e:
                    self._recover(e)       # the card still works: resume
        except BaseException as e:         # noqa: BLE001 — the thread ends
            self._dead = e
            print(f"batcher: device thread stopped: {e!r}", file=sys.stderr,
                  flush=True)
            self._fail_waiting()

    def _fail_waiting(self):
        """Send ("error", message) to every request that is waiting: in
        admission, in a row, pending or queued."""
        msg = f"the batcher's device thread stopped: {self._dead!r}"
        reqs = [r.req for r in self.rows if r.req is not None]
        if self.admission is not None:
            reqs.append(self.admission.req)
        if self._pending is not None:
            reqs.append(self._pending)
        for q in (self.queue, self.batch_queue):
            while True:
                try:
                    reqs.append(q.get_nowait())
                except queue.Empty:
                    break
        for req in {id(r): r for r in reqs}.values():
            req.out.put(("error", msg))

    def _recover(self, err: BaseException):
        """A device fault the card survives (out of memory) poisons the
        device-resident state but not the host bookkeeping: rebuild the
        device tensors and re-queue every interrupted request from its
        host-side history into the same client stream; already-emitted
        tokens are not resent."""
        print(f"batcher: device fault mid-step, recovering ({str(err)[:200]})",
              file=sys.stderr, flush=True)
        requeue: List[Request] = []
        if self.admission is not None:
            requeue.append(self.admission.req)
            self.admission = None
        for r in self.rows:
            if r.req is not None:
                req = r.req
                req.ids = list(r.history)
                req.max_tokens = max(1, req.max_tokens - r.emitted)
                requeue.append(req)
            r.req = None
            r.active = False
            r.history = []
            r.pos = 0
            r.emitted = 0
        if self._pending is not None:
            requeue.append(self._pending)
            self._pending = None
        self.pages = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._init_device_state()
        self.stats["recoveries"] = self.stats.get("recoveries", 0) + 1
        for req in requeue:
            if not req.stop:
                self.queue.put(req)
        self.wake.set()

    def _tick(self):
        # start a new admission when none is in flight (normal queue first,
        # then the deprioritized batch queue)
        if self.admission is None:
            if self._pending is None:
                if not self.queue.empty():
                    self._pending = self.queue.get()
                elif not self.batch_queue.empty():
                    self._pending = self.batch_queue.get()
                if self._pending is not None:
                    self._pending_since = time.time()
            if self._pending is not None and self._pending.stop:
                self._pending.out.put(("done", "stop"))
                self._pending = None
            if self._pending is not None:
                if self._start_admission(self._pending):
                    self._pending = None
                elif (self.preempt_after >= 0
                      and not self._pending.low_priority
                      and time.time() - self._pending_since
                      >= self.preempt_after):
                    self._preempt_oldest()
        # one prefill slice per iteration: decode interleaves below
        if self.admission is not None:
            self._advance_admission()
        active = [i for i, r in enumerate(self.rows)
                  if r.req is not None and r.active]
        if not active:
            if self.admission is None:
                self.wake.wait(timeout=0.05)
                self.wake.clear()
            return
        # fused decode chunk over ALL rows (inactive rows park on the trash
        # page 0). A lone stream with nothing queued gets 2-token chunks.
        lone = (len(active) == 1 and self.admission is None
                and self._pending is None and self.queue.empty()
                and self.batch_queue.empty())
        chunk = 2 if lone else DECODE_CHUNK
        self.stats["last_chunk"] = chunk
        if chunk == DECODE_CHUNK:
            self.stats["full_chunks"] += 1
        tok = np.zeros((self.n_rows,), np.int32)
        pos = np.zeros((self.n_rows,), np.int32)
        # parked rows sample greedily over trash logits (output discarded)
        sps = [SamplingParams(temperature=0.0)] * self.n_rows
        gens: List[Optional[torch.Generator]] = [None] * self.n_rows
        for i in active:
            r = self.rows[i]
            tok[i] = r.history[-1]
            pos[i] = r.pos - 1          # position of the last token
            sps[i] = r.req.sp
            gens[i] = self.row_gens[i]
        dev = self.device
        rp = row_params_from_sp(sps, self.cfg.n_vocab, device=dev)
        rp.bias = self.bias             # per-request logit_bias, set at admission
        for i in active:                # pages for the whole chunk
            self.alloc.ensure(i, self.rows[i].pos + chunk + 1)
        # parked rows keep their host tables for prefix reuse, but their
        # device table is all trash page: their writes must not land in a
        # live page that a later admission would inherit
        tables = self.alloc.device_tables(self.n_rows, only_rows=active,
                                          device=dev)
        toks = _fused_decode_paged(self.engine, torch.from_numpy(tok).to(dev),
                                   torch.from_numpy(pos).to(dev), self.pages,
                                   tables, self.pw, gens, rp, chunk)
        self.stats["decode_steps"] += chunk
        host_toks = toks.cpu().numpy()   # [chunk, R], one read-back a chunk
        for step in range(chunk):
            for i in active:
                row = self.rows[i]
                if row.req is None:
                    continue
                self._deliver(row, int(host_toks[step, i]))
        for i in active:
            self.alloc.lengths[i] = max(self.alloc.lengths[i], self.rows[i].pos)

    def describe(self):
        rows = [{"row": i, "busy": r.req is not None,
                 "history_tokens": len(r.history), "pos": r.pos,
                 "pages": len(self.alloc.tables[i])}
                for i, r in enumerate(self.rows)]
        return rows

    def describe_stats(self):
        out = dict(self.stats)
        out["free_pages"] = len(self.alloc.free)
        out["page_size"] = PAGE_SIZE
        return out
