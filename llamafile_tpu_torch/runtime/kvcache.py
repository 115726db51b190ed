"""KV cache of the port: dense bf16, stored flat as [L, B, S, Hkv*D].

Counterpart of llamafile_tpu/runtime/kvcache.py. The flat layout is the one
the decode kernel streams (positions x Hkv*D rows); head structure is imposed
by callers with a reshape. The cache is updated in place: the JAX package
donated these buffers to each step instead.

The int8 KV cache of the reference is not ported yet and raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: torch.Tensor                   # [L, B, S, Hkv*D]
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv(n_layers: int, batch: int, max_len: int, n_kv: int, head_dim: int,
            dtype=torch.bfloat16, device="cuda") -> KVCache:
    if dtype in (torch.int8, "i8", "int8"):
        raise NotImplementedError(
            "the int8 KV cache (and the decode kernels that read it, "
            "_flash_decode_qt_kernel) are not ported yet")
    if isinstance(dtype, str):
        dtype = {"bf16": torch.bfloat16, "f16": torch.float16,
                 "f32": torch.float32}[dtype]
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"KV cache dtype {dtype}: the decode "
                                  "kernel reads bf16 caches only")
    shape = (n_layers, batch, max_len, n_kv * head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
