"""Continuous batcher of the port: one fused decode step across all active
requests, over a paged KV pool or a dense row-batched cache.

Counterpart of llamafile_tpu/server/batcher.py, for llama engines. In its
paged mode (the default, `paged=None` or True):

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

In the dense row mode (`paged=False`, and for an engine that cannot page)
the rows live in the engine's row-batched cache [L, R, S, ...] (bf16 or
int8 by kv_dtype, `Engine.init_row_cache`): admission prefills into a
single-row cache of the same dtype, seeded with the row's reusable prefix,
and copies it into the row; the fused chunk is `Engine.fused_decode` over
the attn_bucket window of the furthest active row, and inactive rows park
on the trash slot S - 1, which the window never streams. The dense mode
serves a sliding-window model (gemma2, gemma3); the paged pool refuses one.

Each request draws from its own torch.Generator, seeded from its seed: a
seeded request gives the same tokens served alone or beside others.

A row's state is saved, restored and erased on the device thread, between
ticks, through the control queue (`save_row`, `restore_row`, `erase_row`;
runtime/state.py files of bf16 KV, an int8 pool's pages dequantized; a
save's file is written on the caller's thread): a restored row is a warm
prefix that the next request sharing its prompt reuses at admission; a
dense row saves its own dtype, and an int8 row restores only into an int8
dense cache. Recurrent rows and mirostat are not ported and raise
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


def _copy_row(dst, di: int, src, si: int) -> None:
    """Row di of the KVCache dst = row si of src, every leaf (int8 scales
    too)."""
    for d, s in zip((dst.k, dst.v, dst.k_scale, dst.v_scale),
                    (src.k, src.v, src.k_scale, src.v_scale)):
        if d is not None:
            d[:, di].copy_(s[:, si])


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
        if getattr(engine, "recurrent", False) or getattr(engine.cfg, "alibi", False):
            raise NotImplementedError("recurrent and ALiBi engines are not "
                                      "ported to the batcher yet")
        can_page = getattr(engine, "supports_paged", True)
        self.paged_mode = can_page if paged is None else bool(paged and can_page)
        if self.paged_mode and getattr(engine.cfg, "swa_window", 0):
            # the reference's paged decode asserts on a sliding window
            raise NotImplementedError("sliding-window models (gemma2, gemma3) are "
                                      "not served paged: the paged decode has no "
                                      "window (paged=False serves them)")
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
        # control commands (row state save/restore/erase) run ON the device
        # thread between ticks: they read and write the pool it owns
        self.control: "queue.Queue" = queue.Queue()
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
        """(Re)build every device-resident tensor: the KV pool or the row
        cache, penalty windows, logit-bias table and the rows' generators.
        Called at construction and by _recover after a device fault."""
        rows, dev, v = self.n_rows, self.device, self.cfg.n_vocab
        if self.paged_mode:
            from ..runtime.paged import PageAllocator, init_paged
            maxp = -(-self.max_len // PAGE_SIZE)
            n_pages = 1 + rows * maxp
            self.pages = init_paged(self.cfg.n_layers, self.cfg.n_kv_heads,
                                    n_pages, PAGE_SIZE, self.cfg.head_dim,
                                    dtype=self.engine.kv_dtype, device=dev)
            self.alloc = PageAllocator(n_pages, PAGE_SIZE, rows, self.max_len)
            self.cache = None
        else:
            self.cache = self.engine.init_row_cache(rows)
            self.pages = self.alloc = None
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
        """Write an idle row's KV and history to path (the reference's
        llama_state_seq_save_file). RuntimeError for a busy or empty row.
        The device thread only gathers the row to the host; the file is
        written on the caller's thread, so decoding rows do not wait on it."""
        from ..runtime.state import save_state
        cache, hist = self._run_control(lambda: self._gather_row_sync(ridx))
        save_state(path, cache, hist)
        return {"row": ridx, "tokens": len(hist), "filename": path}

    def restore_row(self, path: str) -> dict:
        """Load a saved row into a free row (an empty one first, then the
        least recently used) as a warm prefix cache."""
        return self._run_control(lambda: self._restore_row_sync(path))

    def erase_row(self, ridx: int) -> dict:
        """Drop an idle row's retained prefix cache and its pages."""
        return self._run_control(lambda: self._erase_row_sync(ridx))

    def _run_control(self, fn):
        done: "queue.Queue" = queue.Queue()
        self.control.put((fn, done))
        self.wake.set()
        while True:
            try:
                ok, val = done.get(timeout=1.0)
                break
            except queue.Empty:
                if not self.alive():
                    raise RuntimeError("the batcher's device thread stopped: "
                                       f"{self._dead!r}") from None
        if not ok:
            raise val
        return val

    def _run_controls(self):
        while not self.control.empty():
            fn, done = self.control.get()
            try:
                done.put((True, fn()))
            except Exception as e:     # noqa: BLE001 — the caller's error
                done.put((False, e))

    def _gather_row_sync(self, ridx: int):
        """(the row's KV on the host, trimmed to its history; history): bf16
        from the pool, the row cache's own dtype in the dense mode."""
        from ..runtime.kvcache import KVCache
        row = self.rows[ridx]
        if row.req is not None:
            raise RuntimeError(f"row {ridx} is busy")
        if not row.history:
            raise RuntimeError(f"row {ridx} has no cached state")
        n = len(row.history)
        if not self.paged_mode:
            c = self.cache
            host = lambda a: None if a is None else a[:, ridx:ridx + 1, :n].cpu()
            return (KVCache(host(c.k), host(c.v), host(c.k_scale), host(c.v_scale)),
                    list(row.history))
        from ..runtime.paged import gather_pages_to_row
        k, v = gather_pages_to_row(self.pages, self._table(self.alloc.tables[ridx]),
                                   PAGE_SIZE, self.max_len)
        host = lambda a: a[:, :, :n].to(torch.bfloat16).cpu()
        return KVCache(host(k), host(v)), list(row.history)

    def _restore_row_sync(self, path: str) -> dict:
        from ..runtime.state import load_state
        span = (-(-self.max_len // PAGE_SIZE) * PAGE_SIZE if self.paged_mode
                else self.max_len)
        cache, hist = load_state(path, max_len=span, device=self.device)
        if not hist or len(hist) > self.max_len:
            raise RuntimeError("saved state empty or longer than the context")
        free = [i for i, r in enumerate(self.rows) if r.req is None]
        if not free:
            raise RuntimeError("all rows busy")
        if self.paged_mode and cache.quantized:
            raise RuntimeError("int8 row state cannot restore into a paged "
                               "pool (save from paged mode)")
        if not self.paged_mode and cache.quantized != self.cache.quantized:
            raise RuntimeError("saved state quantization does not match "
                               "this server's --kv-dtype")
        if self.paged_mode:
            want = (self.cfg.n_layers, 1, span, self.cfg.n_kv_heads * self.cfg.head_dim)
        else:
            want = (self.cache.k.shape[0], 1, *self.cache.k.shape[2:])
        if tuple(cache.k.shape) != want or tuple(cache.v.shape) != want:
            raise RuntimeError(f"saved state of shape {tuple(cache.k.shape)} does "
                               f"not fit this model's rows {want}")
        ridx = min(free, key=lambda i: (bool(self.rows[i].history),
                                        self.rows[i].last_used))
        row = self.rows[ridx]
        if self.paged_mode:
            from ..runtime.paged import copy_row_to_pages
            self.alloc.release(ridx)
            self.alloc.ensure(ridx, len(hist))
            self.alloc.lengths[ridx] = len(hist)
            copy_row_to_pages(self.pages, cache.k, cache.v,
                              self._table(self.alloc.tables[ridx]), PAGE_SIZE)
        else:
            _copy_row(self.cache, ridx, cache, 0)
        row.history = list(hist)
        row.pos = len(hist)
        row.active = False
        row.emitted = 0
        row.last_used = time.time()
        return {"row": ridx, "tokens": len(hist), "filename": path}

    def _erase_row_sync(self, ridx: int) -> dict:
        row = self.rows[ridx]
        if row.req is not None:
            raise RuntimeError(f"row {ridx} is busy")
        n = len(row.history)
        row.history = []
        row.pos = 0
        if self.paged_mode:
            self.alloc.release(ridx)
        return {"row": ridx, "erased_tokens": n}

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
        if self.paged_mode:
            keep = self._maybe_share_prefix(ridx, row, ids, keep)
            keep = self._paged_prepare(ridx, row, ids, keep)
        if keep == len(ids):
            keep = len(ids) - 1
        # the pool's pages come back as bf16; a dense row keeps its dtype
        row_cache = self.engine.new_row_cache(
            dtype=torch.bfloat16 if self.paged_mode else self.engine.kv_dtype)
        if keep and self.paged_mode:
            from ..runtime.paged import gather_pages_to_row
            self.alloc.truncate(ridx, keep)
            k, v = gather_pages_to_row(self.pages,
                                       self._table(self.alloc.tables[ridx]),
                                       PAGE_SIZE, self.max_len)
            row_cache.k.copy_(k)
            row_cache.v.copy_(v)
        elif keep:
            _copy_row(row_cache, 0, self.cache, ridx)
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
        from ..runtime.engine import attn_bucket, slice_len
        a = self.admission
        row = self.rows[a.ridx]
        if a.req.stop:                 # cancelled mid-admission
            a.req.out.put(("done", "preempted" if a.req.preempted else "stop"))
            row.req = None
            self.admission = None
            return
        pos0 = a.keep + a.fed
        new = a.ids[pos0:pos0 + self.prefill_chunk]
        b = slice_len(len(new), pos0)
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
        if self.paged_mode:
            from ..runtime.paged import copy_row_to_pages
            self.alloc.ensure(a.ridx, len(a.ids))
            self.alloc.lengths[a.ridx] = len(a.ids)
            # aliased (shared-prefix) pages are read-only: their dense-row
            # values came from those very pages, so their writes go to the
            # trash page
            tbl = [0 if self.alloc.is_shared(p) else p
                   for p in self.alloc.tables[a.ridx]]
            copy_row_to_pages(self.pages, a.row_cache.k, a.row_cache.v,
                              self._table(tbl), PAGE_SIZE)
        else:
            _copy_row(self.cache, a.ridx, a.row_cache, 0)
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
                self._run_controls()
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
        while not self.control.empty():     # strand no waiting caller
            _fn, done = self.control.get()
            done.put((False, RuntimeError(msg)))

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
        self.pages = self.cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._init_device_state()
        self.stats["recoveries"] = self.stats.get("recoveries", 0) + 1
        for req in requeue:
            if not req.stop:
                self.queue.put(req)
        self.wake.set()

    def _tick(self):
        from ..runtime.engine import attn_bucket
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
        # fused decode chunk over ALL rows (inactive rows park: on the trash
        # page 0 paged, on the trash slot S - 1 dense). A lone stream with
        # nothing queued gets 2-token chunks.
        lone = (len(active) == 1 and self.admission is None
                and self._pending is None and self.queue.empty()
                and self.batch_queue.empty())
        chunk = 2 if lone else DECODE_CHUNK
        self.stats["last_chunk"] = chunk
        if chunk == DECODE_CHUNK:
            self.stats["full_chunks"] += 1
        tok = np.zeros((self.n_rows,), np.int32)
        park = 0 if self.paged_mode else self.max_len - 1
        pos = np.full((self.n_rows,), park, np.int32)
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
        tok_d, pos_d = torch.from_numpy(tok).to(dev), torch.from_numpy(pos).to(dev)
        if self.paged_mode:
            for i in active:            # pages for the whole chunk
                self.alloc.ensure(i, self.rows[i].pos + chunk + 1)
            # parked rows keep their host tables for prefix reuse, but their
            # device table is all trash page: their writes must not land in
            # a live page that a later admission would inherit
            tables = self.alloc.device_tables(self.n_rows, only_rows=active,
                                              device=dev)
            toks = _fused_decode_paged(self.engine, tok_d, pos_d, self.pages,
                                       tables, self.pw, gens, rp, chunk)
        else:
            # the window of the furthest active row; parked rows at S - 1
            # lie past it unless it spans the whole cache
            alen = attn_bucket(int(pos[active].max()) + chunk + 1, self.max_len)
            toks = self.engine.fused_decode(tok_d, pos_d, self.cache, self.pw,
                                            gens, rp, chunk, attn_len=alen)
        self.stats["decode_steps"] += chunk
        host_toks = toks.cpu().numpy()   # [chunk, R], one read-back a chunk
        for step in range(chunk):
            for i in active:
                row = self.rows[i]
                if row.req is None:
                    continue
                self._deliver(row, int(host_toks[step, i]))
        if self.paged_mode:
            for i in active:
                self.alloc.lengths[i] = max(self.alloc.lengths[i],
                                            self.rows[i].pos)

    def describe(self):
        rows = [{"row": i, "busy": r.req is not None,
                 "history_tokens": len(r.history), "pos": r.pos}
                for i, r in enumerate(self.rows)]
        if self.paged_mode:
            for i, row in enumerate(rows):
                row["pages"] = len(self.alloc.tables[i])
        return rows

    def describe_stats(self):
        out = dict(self.stats)
        if self.paged_mode:
            out["free_pages"] = len(self.alloc.free)
            out["page_size"] = PAGE_SIZE
        return out
