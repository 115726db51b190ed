"""Synthetic llama models with random quantized weights, built on the device.

Counterpart of llamafile_tpu/models/synthetic.py: the named shapes follow the
public model cards, the weights are random from a seeded torch.Generator on
the target device (no multi-GB host-to-device copy), and the layout is the
production one (ops/repack.py), so kernels see a real checkpoint's data
layout and byte counts.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..ops.repack import QTensor, stack_experts
from .llama import LlamaConfig, LlamaLayer, LlamaParams

# named configs (shapes follow the public model cards; weights random)
PRESETS = {
    "tiny": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                 n_vocab=1024, max_context=2048),
    "tinyllama-1.1b": dict(n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
                           d_ff=5632, n_vocab=32000, max_context=2048),
    # TinyLlama's widths (head_dim 64) at two layers: card-vs-CPU checks
    "tinyllama-1.1b-2l": dict(n_layers=2, d_model=2048, n_heads=32, n_kv_heads=4,
                              d_ff=5632, n_vocab=32000, max_context=2048),
    "llama3-8b": dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
                      d_ff=14336, n_vocab=128256, rope_theta=500000.0,
                      max_context=8192),
    # flagship per-layer shapes at two layers: every per-layer shape of the
    # 32-layer model, at a fraction of the build and run time
    "llama3-8b-2l": dict(n_layers=2, d_model=4096, n_heads=32, n_kv_heads=8,
                         d_ff=14336, n_vocab=128256, rope_theta=500000.0,
                         max_context=8192),
    # Llama-3.2-3B's published widths (its model card: 28 layers, d 3072, 24
    # query heads over 8 KV heads, a head group of 3, head_dim 128, d_ff
    # 8192, vocab 128256, rope theta 500000, 128K context); its head is
    # tied to the embedding there and a separate random matrix here
    "llama3.2-3b": dict(n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
                        d_ff=8192, n_vocab=128256, rope_theta=500000.0,
                        max_context=131072),
    # the same widths at two layers: card-vs-CPU checks
    "llama3.2-3b-2l": dict(n_layers=2, d_model=3072, n_heads=24, n_kv_heads=8,
                           d_ff=8192, n_vocab=128256, rope_theta=500000.0,
                           max_context=131072),
    # Mixtral-8x7B's published widths (top-2-of-8 routed experts) at the
    # reference preset's 8 layers; share_layers: every layer holds the same
    # weight buffers (a decode step reads as many bytes as with distinct
    # weights, and the build is 8x smaller)
    "mixtral-8x7b-8l": dict(n_layers=8, d_model=4096, n_heads=32, n_kv_heads=8,
                            d_ff=14336, n_vocab=32000, rope_theta=1e6,
                            max_context=4096, n_experts=8, n_experts_used=2,
                            moe_norm_topk=True, share_layers=True),
    # Mixtral widths at two layers, distinct weights (card-vs-CPU checks)
    "mixtral-8x7b-2l": dict(n_layers=2, d_model=4096, n_heads=32, n_kv_heads=8,
                            d_ff=14336, n_vocab=32000, rope_theta=1e6,
                            max_context=4096, n_experts=8, n_experts_used=2,
                            moe_norm_topk=True),
    "tiny-moe": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                     n_vocab=1024, max_context=2048, n_experts=4,
                     n_experts_used=2, moe_norm_topk=True),
}


def _rand_qtensor(gen: Optional[torch.Generator], n: int, k: int, quant: str,
                  device) -> QTensor:
    """Random QTensor in the production layout (storage N padded to 2048);
    on the meta device (gen None) the layout without data."""
    if quant in ("F16", "BF16", "F32"):
        qs = torch.randn((k, n), generator=gen, device=device) * 0.02
        return QTensor("dense", (n, k), 0, qs.to(torch.bfloat16))
    ns = -(-n // 2048) * 2048
    if quant in ("Q8_0", "Q6_K", "Q5_K"):
        # int8 codes with per-32 (Q8_0, Q5_K) or per-16 (Q6_K) scales; Q5_K's
        # codes are 0..31 with a per-32 bias (-dmin * min)
        g = 16 if quant == "Q6_K" else 32
        lo, hi = (0, 32) if quant == "Q5_K" else (-127, 128)
        qs = torch.randint(lo, hi, (k, ns), generator=gen, device=device,
                           dtype=torch.int8)
        scales = torch.empty((k // g, ns), device=device).uniform_(
            1e-3, 2e-2, generator=gen)
        bias = None
        if quant == "Q5_K":
            bias = torch.empty((k // g, ns), device=device).uniform_(
                -0.1, 0.0, generator=gen).to(torch.bfloat16)
        return QTensor("q8b", (n, k), g, qs, scales.to(torch.bfloat16), bias)
    if quant != "Q4_K":
        raise NotImplementedError(f"synthetic {quant} weights: the port "
                                  "builds Q4_K, Q5_K, Q8_0, Q6_K (and dense)")
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
    """Returns (cfg, params) with random weights on `device`. A MoE preset
    gives each layer a dense router and expert stacks (stack_experts; gate|up
    joined when fuse), as the loader does. device "meta" gives the shapes,
    dtypes and byte counts of the layout with no data (param_bytes and
    decode_read_bytes of a preset, without building it)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    kw = dict(PRESETS[preset])
    rope_theta = kw.pop("rope_theta", 10000.0)
    share_layers = kw.pop("share_layers", False)
    cfg = LlamaConfig(head_dim=kw["d_model"] // kw["n_heads"],
                      rope_theta=rope_theta, **kw)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rq = lambda n, k: _rand_qtensor(gen, n, k, quant, dev)
    layers = []
    for _ in range(1 if share_layers else cfg.n_layers):
        attn = dict(wq=rq(h * hd, d), wk=rq(kvh * hd, d), wv=rq(kvh * hd, d),
                    wo=rq(d, h * hd))
        if cfg.n_experts:
            ex = {}
            for e in range(cfg.n_experts):
                ex[f"gate.{e}"], ex[f"up.{e}"] = rq(cfg.d_ff, d), rq(cfg.d_ff, d)
                ex[f"down.{e}"] = rq(d, cfg.d_ff)
            ffn = dict(experts=stack_experts(ex, cfg.n_experts, fuse_gate_up=fuse),
                       gate_inp=_rand_qtensor(gen, cfg.n_experts, d, "F16", dev))
        else:
            ffn = dict(w_gate=rq(cfg.d_ff, d), w_up=rq(cfg.d_ff, d),
                       w_down=rq(d, cfg.d_ff))
        layers.append(LlamaLayer(attn_norm=torch.ones(d, device=dev),
                                 ffn_norm=torch.ones(d, device=dev), **attn, **ffn))
    if share_layers:
        layers = layers * cfg.n_layers       # the same buffers in every layer
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
    """Every weight tensor, a layer's shared buffers once for each layer."""
    layers = params.layers if isinstance(params.layers, list) else [params.layers]
    out = [params.tok_embd, params.out_norm]
    vals = [getattr(l, f) for l in layers for f in LlamaLayer.__dataclass_fields__]
    vals += [qt for l in layers if l.experts for qt in l.experts.values()]
    for qt in [params.output] + vals:
        if isinstance(qt, QTensor):
            out += [t for t in (qt.qs, qt.scales, qt.bias) if t is not None]
        elif isinstance(qt, torch.Tensor):
            out.append(qt)
    return out


def param_bytes(params: LlamaParams) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def decode_read_bytes(params: LlamaParams, cfg: LlamaConfig) -> int:
    """Weight bytes one decode step reads from device memory: every byte but
    the embedding table (one row gather), and of a routed MoE layer's expert
    stacks only the top-k share, n_experts_used / n_experts (the reference's
    count). The decode roofline's numerator."""
    total = param_bytes(params) - params.tok_embd.numel() * params.tok_embd.element_size()
    if cfg.n_experts and cfg.n_experts_used:
        frac = 1.0 - cfg.n_experts_used / cfg.n_experts
        layers = params.layers if isinstance(params.layers, list) else [params.layers]
        for layer in layers:
            ex = layer.experts
            if ex and any(r in ex for r in ("gate", "gateup", "gateup_il")):
                gu = next(r for r in ("gateup_il", "gateup", "gate") if r in ex)
                roles = (gu, "down") if gu != "gate" else ("gate", "up", "down")
                total -= int(sum(ex[r].nbytes for r in roles) * frac)
    return total
