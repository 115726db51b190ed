"""GGUF -> device parameters for the port (llama / mistral, dense FFN or
Mixtral-style routed experts).

Counterpart of llamafile_tpu/models/loader.py: tensor bytes flow mmap ->
repack (numpy) -> device; `fuse_projections` then builds the fused qkv and
the GU_STRIPE-interleaved gate|up that the decode kernels take. A MoE
layer's experts (3-D `ffn_{gate,up,down}_exps` tensors, as current
llama.cpp writes Mixtral, or per-expert `ffn_{gate,up,down}.{e}` tensors)
are repacked one expert at a time and stacked by `stack_experts`.
"""
from __future__ import annotations

import dataclasses as dc

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import GGUFReader
from ..gguf.quants import TYPE_BY_ID
from ..ops.repack import (QTensor, concat_qtensors, interleave_gateup, repack,
                          stack_experts)
from ..runtime.tokenizer import Tokenizer
from .llama import LlamaConfig, LlamaLayer, LlamaParams


def _load_qtensor(reader: GGUFReader, name: str, device) -> QTensor:
    t = reader.tensors[name]
    n, k = int(np.prod(t.shape[:-1])), t.shape[-1]
    return repack(reader.tensor_bytes(name), t.type_name, (n, k), device=device)


def _load_vec(reader: GGUFReader, name: str, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(reader.tensor_f32(name))).to(device)


def _load_experts(reader: GGUFReader, p: str, cfg: LlamaConfig, fuse: bool,
                  device) -> dict:
    """Layer p's experts, stacked by role (stack_experts; gate|up joined
    when fuse), or the per-expert dict when they do not stack."""
    experts = {}
    if p + "ffn_gate_exps.weight" in reader:
        for role in ("gate", "up", "down"):
            name = f"{p}ffn_{role}_exps.weight"
            t = reader.tensors[name]
            n_exp, rows, cols = t.shape
            spec = TYPE_BY_ID[t.type_id]
            per = rows * cols // spec.block_elems * spec.block_bytes
            raw = reader.tensor_bytes(name)
            for e in range(n_exp):
                experts[f"{role}.{e}"] = repack(raw[e * per:(e + 1) * per], t.type_name,
                                                (rows, cols), device=device)
    else:
        for e in range(cfg.n_experts):
            for role in ("gate", "up", "down"):
                experts[f"{role}.{e}"] = _load_qtensor(
                    reader, f"{p}ffn_{role}.{e}.weight", device)
    try:
        return stack_experts(experts, cfg.n_experts, fuse_gate_up=fuse)
    except (KeyError, ValueError):
        return experts                  # heterogeneous experts: per-expert dict


def fuse_projections(params: LlamaParams, cfg: LlamaConfig) -> LlamaParams:
    """Fuse q|k|v into one QTensor and gate|up into one: GU_STRIPE-
    interleaved when both are q4b with d_ff a multiple of 1024 (the fused
    FFN kernel's layout), plainly concatenated otherwise."""
    layers = []
    for layer in params.layers:
        kw = {}
        if layer.wqkv is None and layer.wk is not None:
            try:
                kw["wqkv"] = concat_qtensors([layer.wq, layer.wk, layer.wv])
                kw["wq"] = kw["wk"] = kw["wv"] = None
            except ValueError:
                pass                        # mixed formats stay unfused
        g_qt, u_qt = layer.w_gate, layer.w_up
        if g_qt is not None and u_qt is not None:
            try:
                if (g_qt.kind == "q4b" and u_qt.kind == "q4b"
                        and g_qt.g == u_qt.g and g_qt.shape == u_qt.shape
                        and g_qt.shape[0] % 1024 == 0
                        and (g_qt.bias is None) == (u_qt.bias is None)):
                    kw["w_gate_up"] = interleave_gateup(g_qt, u_qt)
                else:
                    kw["w_gate_up"] = concat_qtensors([g_qt, u_qt])
                kw["w_gate"] = kw["w_up"] = None
            except ValueError:
                pass
        layers.append(dc.replace(layer, **kw) if kw else layer)
    return dc.replace(params, layers=layers)


def load_llama(path: str, device="cuda", fuse: bool = True):
    """Load a llama/mistral GGUF into (config, params, tokenizer, reader) on
    `device`. Tensor formats other than F32/F16/BF16/Q8_0/Q4_K/Q5_K/Q6_K
    raise NotImplementedError naming the format. Files whose layers mix
    formats (Q4_K_M, Q4_K_S, Q5_K_M) give per-layer weights that the
    forward runs unrolled. A MoE file (expert_count > 0) loads its router
    and experts; shared experts (ffn_*_shexp) raise."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = LlamaConfig.from_gguf(reader)
    tok = Tokenizer(reader.metadata)
    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        moe = cfg.n_experts > 0 and p + "ffn_gate_inp.weight" in reader
        if not moe and p + "ffn_gate.weight" not in reader:
            raise NotImplementedError(f"{p}: only the gated (SwiGLU) dense "
                                      "FFN and routed experts of llama/mistral "
                                      "are ported")
        for unported in ("attn_q.bias", "attn_qkv.weight", "attn_norm.bias",
                         "ffn_gate_shexp.weight", "ffn_gate_inp_shexp.weight"):
            if p + unported in reader:
                raise NotImplementedError(f"{p}{unported} is not ported yet")
        ffn = (dict(gate_inp=_load_qtensor(reader, p + "ffn_gate_inp.weight", dev),
                    experts=_load_experts(reader, p, cfg, fuse, dev)) if moe else dict(
            w_gate=_load_qtensor(reader, p + "ffn_gate.weight", dev),
            w_up=_load_qtensor(reader, p + "ffn_up.weight", dev),
            w_down=_load_qtensor(reader, p + "ffn_down.weight", dev)))
        layers.append(LlamaLayer(
            attn_norm=_load_vec(reader, p + "attn_norm.weight", dev),
            ffn_norm=_load_vec(reader, p + "ffn_norm.weight", dev),
            wq=_load_qtensor(reader, p + "attn_q.weight", dev),
            wk=_load_qtensor(reader, p + "attn_k.weight", dev),
            wv=_load_qtensor(reader, p + "attn_v.weight", dev),
            wo=_load_qtensor(reader, p + "attn_output.weight", dev),
            **ffn))
    embd = torch.from_numpy(reader.tensor_f32("token_embd.weight")).to(
        dev).to(torch.bfloat16)
    out_name = "output.weight" if "output.weight" in reader else "token_embd.weight"
    params = LlamaParams(
        tok_embd=embd, layers=layers,
        out_norm=_load_vec(reader, "output_norm.weight", dev),
        output=_load_qtensor(reader, out_name, dev))
    if fuse:
        params = fuse_projections(params, cfg)
    return cfg, params, tok, reader
