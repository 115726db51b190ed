"""Carry the JAX package's llama weights across to the port, as numpy.

`params_from_numpy` takes the JAX `LlamaConfig` fields and the parameter
leaves as plain dicts of numpy arrays, so the port never sees a JAX object
(the caller flattens on its side):

  cfg_fields: {field name: value} of the JAX LlamaConfig
  tree: {"tok_embd": [V, d], "out_norm": [d], "output": QT,
         "layers": [ {"attn_norm", "ffn_norm", "wo", "wq", "wk", "wv",
                      "wqkv", "w_gate", "w_up", "w_gate_up", "w_down",
                      "gate_inp", "experts"}, ... ]
                   (a list of per-layer dicts, or one dict of stacked leaves)}
  QT: {"kind", "shape", "g", "qs", "scales", "bias", "il"}
  experts: {role or "role.e": QT} (expert stacks by role, or per expert)

bf16 leaves (embedding, dense weights, scales, bias) arrive as float32
arrays holding bf16 values (exact) and are stored as bf16 again.

`paged_from_numpy` carries a paged KV pool across the same way.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .models.llama import CONFIG_FIELDS, LlamaConfig, LlamaLayer, LlamaParams
from .ops.repack import QTensor

# JAX LlamaConfig features this slice does not run, with their off values
_UNPORTED = {
    "attn_qkv_bias": False, "embd_scale": 1.0, "norm_plus_one": False,
    "ffn_gelu": False, "norm_type": "rms", "clamp_qkv": 0.0,
    "parallel_residual": False, "rope_dim": 0, "attn_softcap": 0.0,
    "final_softcap": 0.0, "swa_window": 0, "qk_norm": False,
    "post_norms": False, "residual_scale": 1.0, "logit_scale": 1.0,
    "expert_weights_scale": 1.0, "n_shared_experts": 0, "q_lora_rank": 0,
    "kv_lora_rank": 0, "v_head_dim": 0, "no_rope": False, "alibi": False,
    "qk_norm_flat": False,
}


def config_from_fields(cfg_fields: dict) -> LlamaConfig:
    for name, off in _UNPORTED.items():
        if name in cfg_fields and cfg_fields[name] != off:
            raise NotImplementedError(f"LlamaConfig.{name}={cfg_fields[name]!r} "
                                      "is not ported yet")
    return LlamaConfig(**{k: v for k, v in cfg_fields.items()
                          if k in CONFIG_FIELDS})


def _t(a: Optional[np.ndarray], device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    t = torch.from_numpy(np.array(a)).to(device)        # a writable copy
    return t if dtype is None else t.to(dtype)


def _qt(d: Optional[dict], device) -> Optional[QTensor]:
    if d is None:
        return None
    codes = {"q4b": torch.uint8, "q8b": torch.int8, "dense": torch.bfloat16}
    if d["kind"] not in codes:
        raise NotImplementedError(f"QTensor kind {d['kind']!r} is not ported yet")
    bf = torch.bfloat16
    qs = _t(d["qs"], device, codes[d["kind"]])
    return QTensor(d["kind"], tuple(d["shape"]), int(d["g"]), qs,
                   _t(d.get("scales"), device, bf), _t(d.get("bias"), device, bf),
                   bool(d.get("il", False)))


def _layer(d: dict, device) -> LlamaLayer:
    kw = {}
    for name in LlamaLayer.__dataclass_fields__:
        v = d.get(name)
        if name == "experts":
            if v is not None and any(k.startswith("shexp.") for k in v):
                raise NotImplementedError("shared experts are not ported yet")
            kw[name] = None if v is None else {k: _qt(q, device) for k, q in v.items()}
        else:
            kw[name] = (_qt(v, device) if isinstance(v, dict)
                        else _t(v, device, torch.float32))
    return LlamaLayer(**kw)


def params_from_numpy(cfg_fields: dict, tree: dict, device="cuda"):
    """(cfg, params) of the port from numpy leaves of the JAX package."""
    dev = resolve_device(device)
    cfg = config_from_fields(cfg_fields)
    layers = tree["layers"]
    layers = ([_layer(l, dev) for l in layers] if isinstance(layers, list)
              else _layer(layers, dev))
    params = LlamaParams(tok_embd=_t(tree["tok_embd"], dev, torch.bfloat16),
                         layers=layers,
                         out_norm=_t(tree["out_norm"], dev, torch.float32),
                         output=_qt(tree["output"], dev))
    return cfg, params


def paged_from_numpy(k_pages, v_pages, k_scale=None, v_scale=None,
                     device="cuda"):
    """A port PagedKV from the JAX package's pool as numpy: pages
    [L, Hkv, P, ps, D] (bf16 as float32 values, or int8 codes) and, for an
    int8 pool, f32 scales [L, Hkv, P, ps, 1]."""
    from .runtime.paged import PagedKV
    dev = resolve_device(device)
    dt = torch.int8 if np.asarray(k_pages).dtype == np.int8 else torch.bfloat16
    return PagedKV(_t(k_pages, dev, dt), _t(v_pages, dev, dt),
                   _t(k_scale, dev, torch.float32), _t(v_scale, dev, torch.float32))
