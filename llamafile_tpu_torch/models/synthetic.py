"""Synthetic llama models with random quantized weights, built on the device.

Counterpart of llamafile_tpu/models/synthetic.py: the named shapes follow the
public model cards, the weights are random from a seeded torch.Generator on
the target device (no multi-GB host-to-device copy), and the layout is the
production one (ops/repack.py), so kernels see a real checkpoint's data
layout and byte counts.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.repack import QTensor
from .llama import LlamaConfig, LlamaLayer, LlamaParams

# named configs (shapes follow the public model cards; weights random)
PRESETS = {
    "tiny": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                 n_vocab=1024, max_context=2048),
    "tinyllama-1.1b": dict(n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
                           d_ff=5632, n_vocab=32000, max_context=2048),
    "llama3-8b": dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
                      d_ff=14336, n_vocab=128256, rope_theta=500000.0,
                      max_context=8192),
    # flagship per-layer shapes at two layers: every per-layer shape of the
    # 32-layer model, at a fraction of the build and run time
    "llama3-8b-2l": dict(n_layers=2, d_model=4096, n_heads=32, n_kv_heads=8,
                         d_ff=14336, n_vocab=128256, rope_theta=500000.0,
                         max_context=8192),
}


def _rand_qtensor(gen: torch.Generator, n: int, k: int, quant: str,
                  device) -> QTensor:
    """Random QTensor in the production layout (storage N padded to 2048)."""
    if quant in ("F16", "BF16", "F32"):
        qs = torch.randn((k, n), generator=gen, device=device) * 0.02
        return QTensor("dense", (n, k), 0, qs.to(torch.bfloat16))
    ns = -(-n // 2048) * 2048
    if quant in ("Q8_0", "Q6_K"):
        # int8 codes with per-32 (Q8_0) or per-16 (Q6_K) scales, no bias
        g = 16 if quant == "Q6_K" else 32
        qs = torch.randint(-127, 128, (k, ns), generator=gen, device=device,
                           dtype=torch.int8)
        scales = torch.empty((k // g, ns), device=device).uniform_(
            1e-3, 2e-2, generator=gen)
        return QTensor("q8b", (n, k), g, qs, scales.to(torch.bfloat16))
    if quant != "Q4_K":
        raise NotImplementedError(f"synthetic {quant} weights: the port "
                                  "builds Q4_K, Q8_0, Q6_K (and dense)")
    qs = torch.randint(0, 256, (k // 2, ns), generator=gen, device=device,
                       dtype=torch.uint8)
    scales = torch.empty((k // 32, ns), device=device).uniform_(
        1e-3, 2e-2, generator=gen)
    bias = torch.empty((k // 32, ns), device=device).uniform_(
        -0.1, 0.0, generator=gen)
    return QTensor("q4b", (n, k), 32, qs, scales.to(torch.bfloat16),
                   bias.to(torch.bfloat16))


def make_synthetic_llama(preset: str = "tiny", quant: str = "Q4_K",
                         seed: int = 0, fuse: bool = False, device="cuda"):
    """Returns (cfg, params) with random weights on `device`."""
    dev = resolve_device(device)
    kw = dict(PRESETS[preset])
    rope_theta = kw.pop("rope_theta", 10000.0)
    cfg = LlamaConfig(head_dim=kw["d_model"] // kw["n_heads"],
                      rope_theta=rope_theta, **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rq = lambda n, k: _rand_qtensor(gen, n, k, quant, dev)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(LlamaLayer(
            attn_norm=torch.ones(d, device=dev), ffn_norm=torch.ones(d, device=dev),
            wq=rq(h * hd, d), wk=rq(kvh * hd, d), wv=rq(kvh * hd, d),
            wo=rq(d, h * hd),
            w_gate=rq(cfg.d_ff, d), w_up=rq(cfg.d_ff, d), w_down=rq(d, cfg.d_ff)))
    embd = (torch.randn((cfg.n_vocab, d), generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)
    params = LlamaParams(tok_embd=embd, layers=layers,
                         out_norm=torch.ones(d, device=dev),
                         output=rq(cfg.n_vocab, d))
    if fuse:
        from .loader import fuse_projections
        params = fuse_projections(params, cfg)
    return cfg, params


def _leaves(params: LlamaParams):
    layers = params.layers if isinstance(params.layers, list) else [params.layers]
    out = [params.tok_embd, params.out_norm]
    for qt in [params.output] + [getattr(l, f) for l in layers
                                 for f in LlamaLayer.__dataclass_fields__]:
        if isinstance(qt, QTensor):
            out += [t for t in (qt.qs, qt.scales, qt.bias) if t is not None]
        elif isinstance(qt, torch.Tensor):
            out.append(qt)
    return out


def param_bytes(params: LlamaParams) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def decode_read_bytes(params: LlamaParams, cfg: LlamaConfig) -> int:
    """Weight bytes one decode step reads from device memory: every byte but
    the embedding table (one row gather). The decode roofline's numerator."""
    return param_bytes(params) - params.tok_embd.numel() * params.tok_embd.element_size()
