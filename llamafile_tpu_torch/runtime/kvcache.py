"""KV cache of the port: dense bf16, f16 or f32, or int8 with per-row scales.

Counterpart of llamafile_tpu/runtime/kvcache.py. Layouts, as there:
  bf16, f16, f32: k, v [L, B, S, Hkv*D], flat: the decode kernels stream
        (positions x Hkv*D) rows; head structure is imposed by callers with
        a reshape. New rows are cast to the cache's dtype as they land.
  int8: k, v [L, B, S, Hkv, D] codes and k_scale, v_scale [L, B, S, Hkv] f32
        absmax/127 scales, one per (position, head).
The cache is updated in place: the JAX package donated these buffers to each
step instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


@dataclass
class KVCache:
    k: torch.Tensor                   # [L, B, S, Hkv*D] float | [L, B, S, Hkv, D] int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None    # [L, B, S, Hkv] f32 when int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv(n_layers: int, batch: int, max_len: int, n_kv: int, head_dim: int,
            dtype=torch.bfloat16, device="cuda") -> KVCache:
    if dtype in (torch.int8, "i8", "int8"):
        shape = (n_layers, batch, max_len, n_kv, head_dim)
        z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
        return KVCache(z(shape, torch.int8), z(shape, torch.int8),
                       z(shape[:-1], torch.float32), z(shape[:-1], torch.float32))
    if isinstance(dtype, str):
        dtype = {"bf16": torch.bfloat16, "f16": torch.float16,
                 "f32": torch.float32}[dtype]
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype}: bf16, f16, f32 or int8")
    shape = (n_layers, batch, max_len, n_kv * head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _quant_rows(x: torch.Tensor):
    """x [..., D] float -> (int8 codes [..., D], f32 absmax/127 scale [...]).

    The reference's `amax / 127.0` runs under jit, where XLA multiplies by
    the f32 reciprocal of 127; so does this, and the codes (x times the f32
    reciprocal of the scale, rounded half to even) and scales are the
    reference's bit for bit."""
    x = x.float()
    scale = x.abs().amax(dim=-1) * _INV127
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _scatter(buf: torch.Tensor, li: int, pos: torch.Tensor, t_pos: torch.Tensor,
             new: torch.Tensor) -> None:
    """buf[li, b, pos[b] + t] = new[b, t] in place; positions past the cache
    are dropped (prefill bucket padding). A single new row (decode, where
    callers keep pos < S, as the reference's) is written without the mask,
    whose indexing would wait on the device."""
    b, t = new.shape[:2]
    bidx = torch.arange(b, device=buf.device)[:, None].expand(b, t)
    if t == 1:
        buf[li, bidx[:, 0], pos.long()] = new[:, 0].to(buf.dtype)
        return
    idx = pos.long()[:, None] + t_pos[None, :]
    keep = idx < buf.shape[2]
    buf[li, bidx[keep], idx[keep]] = new[keep].to(buf.dtype)


def update_layer(cache: KVCache, li: int, pos: torch.Tensor,
                 t_pos: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> None:
    """Write new K/V rows k_new, v_new [B, T, Hkv, D] of layer li at
    positions pos + t, in place; quantized per (position, head) for int8."""
    b, t = k_new.shape[:2]
    if cache.quantized:
        for buf, sbuf, new in ((cache.k, cache.k_scale, k_new),
                               (cache.v, cache.v_scale, v_new)):
            q, s = _quant_rows(new)
            _scatter(buf, li, pos, t_pos, q)
            _scatter(sbuf, li, pos, t_pos, s)
        return
    _scatter(cache.k, li, pos, t_pos, k_new.reshape(b, t, -1))
    _scatter(cache.v, li, pos, t_pos, v_new.reshape(b, t, -1))


def read_layer(cache: KVCache, li: int, n_kv: int):
    """K/V of layer li as [B, S, Hkv, D]: views of a bf16 cache, f32 codes
    times their scales for int8 (the reference's f32 product)."""
    if cache.quantized:
        return (cache.k[li].float() * cache.k_scale[li][..., None],
                cache.v[li].float() * cache.v_scale[li][..., None])
    b, s, hd = cache.k.shape[1:]
    return (cache.k[li].reshape(b, s, n_kv, hd // n_kv),
            cache.v[li].reshape(b, s, n_kv, hd // n_kv))
