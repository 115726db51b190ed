"""KV/session state save and restore of the port (llama_state_* analog).

Counterpart of llamafile_tpu/runtime/state.py, in the same `.npz` layout,
so a file written by either package loads in the other:
  leaf0..leaf3  k, v, k_scale, v_scale in that order, the scales only for
                an int8 cache (the JAX pytree's flatten drops the None ones);
                bf16 stored as uint16 with its tag in `dtypes`;
  history       int64 token ids;
  quantized     bool [1];
  dtypes        each leaf's dtype name ("bfloat16", "int8", "float32").
Every leaf keeps the position axis at 2 ([L, B, S, H*D] bf16, [L, B, S, H,
D] int8 codes, [L, B, S, H] f32 scales). save_state trims it to the
history's length, load_state re-pads it to max_len. The members are
stored uncompressed (np.savez): np.load reads them as it reads the JAX
package's compressed ones, and deflating bf16 K/V saves about half its
bytes at several seconds a 40 MB row.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .kvcache import KVCache


def _to_numpy(t: torch.Tensor):
    """bf16 has no numpy dtype: stored as uint16 with a dtype tag."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def save_state(path: str, cache: KVCache, history: List[int]) -> None:
    """Write (cache, history) to path, trimmed to len(history) positions,
    so the file scales with the prompt, not the context."""
    leaves = [a for a in (cache.k, cache.v, cache.k_scale, cache.v_scale)
              if a is not None]
    if history and len(history) < cache.max_len:
        leaves = [a[:, :, :len(history)] for a in leaves]
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"leaf{i}"], name = _to_numpy(leaf)
        dtypes.append(name)
    arrays["history"] = np.asarray(history, np.int64)
    arrays["quantized"] = np.asarray([cache.quantized])
    arrays["dtypes"] = np.asarray(dtypes)
    np.savez(path, **arrays)


def load_state(path: str, max_len: int = 0,
               device="cpu") -> Tuple[KVCache, List[int]]:
    """(cache on `device`, history) from path; max_len > 0 re-pads a trimmed
    file's position axis to the engine's context window."""
    z = np.load(path)
    history = z["history"].tolist()
    quantized = bool(z["quantized"][0])
    dtypes = [str(d) for d in z["dtypes"]]
    leaves = []
    for i in range(4 if quantized else 2):
        a = z[f"leaf{i}"]
        if dtypes[i] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
        if max_len and t.shape[2] < max_len:
            pad = list(t.shape)
            pad[2] = max_len - t.shape[2]
            t = torch.cat([t, torch.zeros(pad, dtype=t.dtype)], dim=2)
        leaves.append(t.to(device))
    if quantized:
        return KVCache(*leaves), history
    return KVCache(leaves[0], leaves[1]), history
