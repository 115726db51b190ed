"""Paged KV cache of the port: block tables, paged decode attention, context
shift.

Counterpart of llamafile_tpu/runtime/paged.py:

- data pages live on the device: `k_pages`/`v_pages` [L, Hkv, P, ps, D]
  bf16, f16 or f32, or int8 with [L, Hkv, P, ps, 1] f32 scales; every row of the batch
  reaches its pages through an int32 block table;
- page bookkeeping lives on the host: `PageAllocator`, a refcounted free
  list whose page 0 is the trash page (parked rows write there).

The JAX package donated the pool to each jitted function and got a new one
back. Here the pool is updated IN PLACE by `copy_row_to_pages`,
`write_token_kv` and `relocate_span`, which return nothing.

`paged_attend` is the decode attention of one layer: on CUDA tensors it
launches the paged_attention kernel (ops/attention.py, csrc/
paged_attention.cu); on CPU tensors it runs its plain version,
`paged_attention_plain` (the gather + mask + f32 softmax of the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import paged_attention, paged_attention_plain  # noqa: F401


@dataclass
class PagedKV:
    k_pages: torch.Tensor                    # [L, Hkv, P, ps, D] bf16, f16, f32 or int8
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # [L, Hkv, P, ps, 1] f32 when int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[2]


def init_paged(n_layers: int, n_kv: int, n_pages: int, page_size: int,
               head_dim: int, dtype=torch.bfloat16, v_head_dim: int = 0,
               device="cuda") -> PagedKV:
    """A zeroed pool; dtype bf16, f16 or f32 (a torch dtype or "bf16",
    "f16", "f32"), or int8 ("int8", "i8", torch.int8) for int8 pages with
    f32 scales."""
    kshape = (n_layers, n_kv, n_pages, page_size, head_dim)
    vshape = (n_layers, n_kv, n_pages, page_size, v_head_dim or head_dim)
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    if dtype in (torch.int8, "i8", "int8"):
        sshape = kshape[:-1] + (1,)
        return PagedKV(z(kshape, torch.int8), z(vshape, torch.int8),
                       z(sshape, torch.float32), z(sshape, torch.float32))
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}.get(
        dtype, dtype)
    if dtype in (torch.bfloat16, torch.float16, torch.float32):
        return PagedKV(z(kshape, dtype), z(vshape, dtype))
    raise ValueError(f"paged KV dtype {dtype!r}: bf16, f16, f32 or int8")


_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _q8(x: torch.Tensor):
    """float [..., D] -> (int8 codes, f32 absmax/127 scale [..., 1]): the
    paged kernel's quantized-tensor convention. Codes round half to even,
    as jnp.round. The reference's `/ 127.0` runs under jit, where XLA
    multiplies by the f32 reciprocal of 127 instead; so does this, so that
    codes and scales are the reference's bit for bit."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) * _INV127
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, amax * _INV127


class PageAllocator:
    """Host-side page bookkeeping. Page 0 is reserved as the trash page
    (parked rows write there; no live table references it).

    Pages are REFCOUNTED so a common prompt prefix can be shared across
    rows: share_prefix() aliases the donor's full prefix pages into another
    row's table; writes never land in shared pages (the batcher sends them
    to the trash page on write-back, and rows only append past their
    length), and a page returns to the free list when its last reference
    drops."""

    def __init__(self, n_pages: int, page_size: int, n_rows: int,
                 max_len: int):
        self.page_size = page_size
        self.max_pages_per_row = -(-max_len // page_size)
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.tables: List[List[int]] = [[] for _ in range(n_rows)]
        self.lengths: List[int] = [0] * n_rows
        self.refs = {}                     # page -> refcount (absent = free)

    def _unref(self, p: int) -> None:
        self.refs[p] = self.refs.get(p, 1) - 1
        if self.refs[p] <= 0:
            del self.refs[p]
            self.free.append(p)

    def is_shared(self, p: int) -> bool:
        return self.refs.get(p, 1) > 1

    def ensure(self, row: int, n_tokens: int) -> None:
        """Grow row's table to cover n_tokens positions."""
        need = -(-n_tokens // self.page_size)
        t = self.tables[row]
        while len(t) < need:
            if not self.free:
                raise RuntimeError("out of KV pages")
            p = self.free.pop()
            self.refs[p] = 1
            t.append(p)

    def release(self, row: int) -> None:
        for p in self.tables[row]:
            self._unref(p)
        self.tables[row] = []
        self.lengths[row] = 0

    def truncate(self, row: int, n_tokens: int) -> None:
        """Drop pages beyond n_tokens (keep the partial boundary page)."""
        keep = -(-n_tokens // self.page_size) if n_tokens else 0
        t = self.tables[row]
        for p in t[keep:]:
            self._unref(p)
        self.tables[row] = t[:keep]
        self.lengths[row] = n_tokens

    def share_prefix(self, src: int, dst: int, n_pages: int) -> None:
        """Alias src's first n_pages (a FULL-page prompt prefix) into dst's
        empty table. Both rows treat those pages as read-only."""
        assert not self.tables[dst], "share_prefix needs an empty dst table"
        head = self.tables[src][:n_pages]
        for p in head:
            self.refs[p] = self.refs.get(p, 1) + 1
        self.tables[dst] = list(head)
        self.lengths[dst] = n_pages * self.page_size

    def shared_page_count(self, row: int) -> int:
        """Leading run of shared pages in row's table (the aliased prefix)."""
        n = 0
        for p in self.tables[row]:
            if not self.is_shared(p):
                break
            n += 1
        return n

    def device_tables(self, n_rows: int, only_rows=None,
                      device="cuda") -> torch.Tensor:
        """[R, MAXP] int32, unused entries on the trash page 0. Rows not in
        only_rows (when given) map entirely to the trash page: the batcher
        parks them so, and their host tables stay intact."""
        arr = np.zeros((n_rows, self.max_pages_per_row), np.int32)
        keep = None if only_rows is None else set(only_rows)
        for r, t in enumerate(self.tables):
            if keep is None or r in keep:
                arr[r, :len(t)] = t
        return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# Device ops (in place on the pool)
# ---------------------------------------------------------------------------

@torch.no_grad()
def copy_row_to_pages(paged: PagedKV, dense_k: torch.Tensor,
                      dense_v: torch.Tensor, pages: torch.Tensor,
                      ps: int) -> None:
    """Scatter a dense single-row cache ([L, 1, S, H*D], the kvcache.py
    layout) into `pages` (int [np], covering positions [0, np*ps)), in
    place. Quantizes per (layer, head, position) for an int8 pool."""
    n = pages.shape[0]
    L = dense_k.shape[0]
    H, D = paged.k_pages.shape[1], paged.k_pages.shape[-1]
    Dv = paged.v_pages.shape[-1]
    kk = dense_k[:, 0, :n * ps].reshape(L, n, ps, H, D).permute(0, 3, 1, 2, 4)
    vv = dense_v[:, 0, :n * ps].reshape(L, n, ps, H, Dv).permute(0, 3, 1, 2, 4)
    idx = pages.long().to(paged.k_pages.device)
    if paged.quantized:
        qk, sk = _q8(kk.float())
        qv, sv = _q8(vv.float())
        paged.k_pages[:, :, idx] = qk
        paged.v_pages[:, :, idx] = qv
        paged.k_scale[:, :, idx] = sk
        paged.v_scale[:, :, idx] = sv
    else:
        paged.k_pages[:, :, idx] = kk.to(paged.k_pages.dtype)
        paged.v_pages[:, :, idx] = vv.to(paged.v_pages.dtype)


@torch.no_grad()
def gather_pages_to_row(paged: PagedKV, pages: torch.Tensor, ps: int,
                        max_len: int):
    """Inverse of copy_row_to_pages: a dense single-row cache (k, v), each
    [L, 1, max_len, H*D] with zeros past the pages: the pool's dtype from
    a bf16, f16 or f32 pool, f32 (codes times scales) from an int8 pool."""
    idx = pages.long().to(paged.k_pages.device)
    kk = paged.k_pages[:, :, idx]                      # [L, H, np, ps, D]
    vv = paged.v_pages[:, :, idx]
    if paged.quantized:
        kk = kk.float() * paged.k_scale[:, :, idx]
        vv = vv.float() * paged.v_scale[:, :, idx]
    L, H, n, _, D = kk.shape
    Dv = vv.shape[-1]
    k = kk.permute(0, 2, 3, 1, 4).reshape(L, n * ps, H * D)
    v = vv.permute(0, 2, 3, 1, 4).reshape(L, n * ps, H * Dv)
    pad = max_len - n * ps
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))[:, None]
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))[:, None]
    return k, v


def find_mid_delete(history: List[int], ids: List[int], prefix: int,
                    min_reuse: int = 8) -> Optional[Tuple[int, int]]:
    """Detect the reference's mid-delete pattern (slot.cpp:291-424): the new
    prompt keeps `prefix`, removes history[prefix:j], then continues with a
    span of the old history starting at j (a trailing divergence is
    dropped, as the reference's tail truncation does). Returns
    (j, reuse_len) with the most reuse, or None."""
    h = np.asarray(history[prefix:])
    i = np.asarray(ids[prefix:])
    if not len(h) or not len(i):
        return None
    best = None
    for d in range(1, len(h)):                         # deletion span length
        m = min(len(h) - d, len(i))
        if best is not None and best[1] >= m:
            break                                      # can't beat it anymore
        eq = h[d:d + m] == i[:m]
        reuse = int(np.argmin(eq)) if not eq.all() else m
        if reuse >= min_reuse and (best is None or reuse > best[1]):
            best = (prefix + d, reuse)
    return best


def paged_attend(q, k_pages_l, v_pages_l, lengths, tables, *,
                 k_scale_l=None, v_scale_l=None):
    """Decode attention for one layer. q [R, Hq, D] PRE-SCALED by 1/sqrt(D)
    (the kernel applies no scale); pages [Hkv, P, ps, D] bf16, or int8 with
    [Hkv, P, ps, 1] scales; lengths [R]; tables [R, MAXP]. Returns
    [R, Hq, D] f32 through the paged_attention kernel (its plain version on
    the CPU)."""
    return paged_attention(q.float(), k_pages_l, v_pages_l, lengths, tables,
                           k_scale_l, v_scale_l)


@torch.no_grad()
def write_token_kv(k_pages_l, v_pages_l, k_new, v_new, pages, offs,
                   k_scale_l=None, v_scale_l=None) -> None:
    """Write one new token a row IN PLACE: k_new/v_new [R, Hkv, D] at
    (pages[r], offs[r]) of each head. Quantizes per (row, head) when scale
    pages are given. Rows parked on the trash page write there."""
    kT = k_new.permute(1, 0, 2)                           # [Hkv, R, D]
    vT = v_new.permute(1, 0, 2)
    p, o = pages.long(), offs.long()
    if k_scale_l is not None:
        qk, sk = _q8(kT.float())
        qv, sv = _q8(vT.float())
        k_pages_l[:, p, o] = qk
        v_pages_l[:, p, o] = qv
        k_scale_l[:, p, o] = sk
        v_scale_l[:, p, o] = sv
    else:
        k_pages_l[:, p, o] = kT.to(k_pages_l.dtype)
        v_pages_l[:, p, o] = vT.to(v_pages_l.dtype)


@torch.no_grad()
def relocate_span(paged: PagedKV, cfg, tables_row: torch.Tensor,
                  src_start: int, dst_start: int, n_move: int) -> None:
    """Move n_move cached tokens of ONE row from positions [src, src+n) to
    [dst, dst+n) (dst < src) IN PLACE, re-rotating K by the position delta:
    the paged form of slot.cpp:291-424's memmove + rope shift.

    tables_row: int32 [MAXP'] (the row's table; positions resolve through
    it across page boundaries). Table reads past its end take its last
    entry, as the reference's gather clamps. Every read happens before the
    first write."""
    from ..models.llama import apply_rope, rope_angles
    ps = paged.page_size
    dev = paged.k_pages.device
    tab = tables_row.long().to(dev)
    last = tab.shape[0] - 1
    src = src_start + torch.arange(n_move, device=dev)
    dst = dst_start + torch.arange(n_move, device=dev)
    sp_, so = tab[(src // ps).clamp(max=last)], src % ps
    dp_, do = tab[(dst // ps).clamp(max=last)], dst % ps
    delta = torch.full((n_move,), dst_start - src_start, dtype=torch.int32,
                       device=dev)
    ang, _ = rope_angles(delta, cfg.head_dim, cfg.rope_theta, cfg.rope_scale,
                         cfg)
    cos, sin = torch.cos(ang), torch.sin(ang)            # [n, D/2]
    k = paged.k_pages[:, :, sp_, so]                     # [L, H, n, D]
    v = paged.v_pages[:, :, sp_, so]
    if paged.quantized:
        k = k.float() * paged.k_scale[:, :, sp_, so]
        vs = paged.v_scale[:, :, sp_, so]
    k32 = k.float().permute(0, 2, 1, 3)                  # [L, n, H, D]
    kshift = apply_rope(k32, cos[None, :, None, :], sin[None, :, None, :],
                        cfg.rope_neox).permute(0, 2, 1, 3)
    if paged.quantized:
        qk, sk = _q8(kshift)
        paged.k_pages[:, :, dp_, do] = qk
        paged.v_pages[:, :, dp_, do] = v
        paged.k_scale[:, :, dp_, do] = sk
        paged.v_scale[:, :, dp_, do] = vs
    else:
        paged.k_pages[:, :, dp_, do] = kshift.to(paged.k_pages.dtype)
        paged.v_pages[:, :, dp_, do] = v
