"""GGUF -> device parameters for the port (llama / mistral, dense FFN or
Mixtral-style routed experts; gemma, gemma2 and gemma3, with their heads
tied to the embedding, gemma2/3's sandwich norms and gemma3's per-head q/k
norms; qwen2 with its q/k/v biases, qwen3 with its per-head q/k norms; the
LayerNorm families gptneox, falcon, starcoder2, phi2 and command-r with
their norm and projection biases, a pre-fused attn_qkv kept fused, the
gateless FFN, and no ffn_norm under a shared-norm parallel residual).

Counterpart of llamafile_tpu/models/loader.py: tensor bytes flow mmap ->
repack (numpy) -> device; `fuse_projections` then builds the fused qkv and
the GU_STRIPE-interleaved gate|up that the decode kernels take. A MoE
layer's experts (3-D `ffn_{gate,up,down}_exps` tensors, as current
llama.cpp writes Mixtral, or per-expert `ffn_{gate,up,down}.{e}` tensors)
are repacked one expert at a time and stacked by `stack_experts`.
"""
from __future__ import annotations

import dataclasses as dc
import os

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import GGUFReader
from ..gguf.quants import TYPE_BY_ID
from ..ops.repack import (QTensor, concat_qtensors, interleave_gateup, repack,
                          slice_qtensor_cols, stack_experts)
from ..runtime.tokenizer import Tokenizer
from .llama import LlamaConfig, LlamaLayer, LlamaParams


def _load_qtensor(reader: GGUFReader, name: str, device) -> QTensor:
    t = reader.tensors[name]
    n, k = int(np.prod(t.shape[:-1])), t.shape[-1]
    return repack(reader.tensor_bytes(name), t.type_name, (n, k), device=device)


def _load_vec(reader: GGUFReader, name: str, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(reader.tensor_f32(name))).to(device)


def _load_norm(reader: GGUFReader, name: str, d: int, device) -> torch.Tensor:
    """A norm weight, or ones where the file has none (the reference's)."""
    if name in reader:
        return _load_vec(reader, name, device)
    return torch.ones(d, dtype=torch.float32, device=device)


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
    FFN kernel's layout) and LLAMAFILE_TPU_ILGU is not "0" (read at every
    call, as the reference reads it), plainly concatenated otherwise: a
    stacked M = 1 FFN then runs the gate|up and down products, not the
    fused kernel. q/k/v biases stay separate f32 vectors (the forward adds
    them after the fused product), as in the reference; a gateless FFN has
    nothing to fuse."""
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
                        and (g_qt.bias is None) == (u_qt.bias is None)
                        and os.environ.get("LLAMAFILE_TPU_ILGU", "1") != "0"):
                    kw["w_gate_up"] = interleave_gateup(g_qt, u_qt)
                else:
                    kw["w_gate_up"] = concat_qtensors([g_qt, u_qt])
                kw["w_gate"] = kw["w_up"] = None
            except ValueError:
                pass
        layers.append(dc.replace(layer, **kw) if kw else layer)
    return dc.replace(params, layers=layers)


def load_llama(path: str, device="cuda", fuse: bool = True):
    """Load a llama/mistral/gemma/gemma2/gemma3/qwen2/qwen3/gptneox/falcon/
    starcoder2/phi2/command-r GGUF into (config, params, tokenizer, reader)
    on `device`. Every GGML tensor type loads but Q8_1, which raises
    NotImplementedError naming it (gguf/quants.py). Files whose layers mix
    formats (Q4_K_M, Q4_K_S, Q5_K_M) give per-layer weights that the
    forward runs unrolled. A MoE file (expert_count > 0) loads its router
    and experts; shared experts (ffn_*_shexp) raise. A pre-fused attn_qkv
    (gptneox, falcon) stays fused as wqkv (split by columns when not fuse),
    its bias split into bq, bk, bv."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = LlamaConfig.from_gguf(reader)
    tok = Tokenizer(reader.metadata)
    d = cfg.d_model
    nq, nkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        moe = cfg.n_experts > 0 and p + "ffn_gate_inp.weight" in reader
        for unported in ("ffn_gate_shexp.weight", "ffn_gate_inp_shexp.weight"):
            if p + unported in reader:
                raise NotImplementedError(f"{p}{unported} is not ported yet")
        opt = lambda nm: _load_vec(reader, p + nm, dev) if p + nm in reader else None
        qt = lambda nm: _load_qtensor(reader, p + nm, dev)
        if moe:
            ffn = dict(gate_inp=qt("ffn_gate_inp.weight"),
                       experts=_load_experts(reader, p, cfg, fuse, dev))
        elif p + "ffn_gate.weight" in reader:
            ffn = dict(w_gate=qt("ffn_gate.weight"), w_up=qt("ffn_up.weight"),
                       w_down=qt("ffn_down.weight"))
        elif reader.tensors[p + "ffn_up.weight"].shape[0] == 2 * cfg.d_ff:
            raise NotImplementedError(f"{p}ffn_up.weight: a fused gate|up (phi3) is not "
                                      "ported yet")
        else:                               # the gateless FFN of the LayerNorm families
            ffn = dict(w_up=qt("ffn_up.weight"), w_down=qt("ffn_down.weight"))
        if p + "attn_qkv.weight" in reader:
            # gptneox's and falcon's q|k|v in one tensor: kept fused (split
            # by columns for an unfused load), a bias split into bq, bk, bv
            wqkv = qt("attn_qkv.weight")
            attn = (dict(wqkv=wqkv) if fuse else dict(
                wq=slice_qtensor_cols(wqkv, 0, nq), wk=slice_qtensor_cols(wqkv, nq, nq + nkv),
                wv=slice_qtensor_cols(wqkv, nq + nkv, nq + 2 * nkv)))
            bqkv = opt("attn_qkv.bias")
            if bqkv is not None:
                attn.update(bq=bqkv[:nq], bk=bqkv[nq:nq + nkv], bv=bqkv[nq + nkv:nq + 2 * nkv])
        else:
            attn = dict(wq=qt("attn_q.weight"), wk=qt("attn_k.weight"), wv=qt("attn_v.weight"),
                        bq=opt("attn_q.bias"), bk=opt("attn_k.bias"), bv=opt("attn_v.bias"))
        # a parallel layer with no ffn_norm (falcon-7B-style, phi2,
        # command-r) feeds its FFN the attention norm's output: None, not ones
        has_ffn_norm = p + "ffn_norm.weight" in reader or not cfg.parallel_residual
        layers.append(LlamaLayer(
            attn_norm=_load_norm(reader, p + "attn_norm.weight", d, dev),
            ffn_norm=_load_norm(reader, p + "ffn_norm.weight", d, dev) if has_ffn_norm else None,
            wo=qt("attn_output.weight"),
            # gemma2/3's sandwich norms, gemma3/qwen3's per-head q/k norms;
            # the LayerNorm families' norm and output biases
            attn_post_norm=opt("post_attention_norm.weight"),
            ffn_post_norm=opt("post_ffw_norm.weight"),
            q_norm=opt("attn_q_norm.weight"),
            k_norm=opt("attn_k_norm.weight"),
            attn_norm_b=opt("attn_norm.bias"), ffn_norm_b=opt("ffn_norm.bias"),
            bo=opt("attn_output.bias"), b_up=opt("ffn_up.bias"), b_down=opt("ffn_down.bias"),
            **attn, **ffn))
    embd = torch.from_numpy(reader.tensor_f32("token_embd.weight")).to(
        dev).to(torch.bfloat16)
    out_name = "output.weight" if "output.weight" in reader else "token_embd.weight"
    opt = lambda nm: _load_vec(reader, nm, dev) if nm in reader else None
    params = LlamaParams(
        tok_embd=embd, layers=layers,
        out_norm=_load_norm(reader, "output_norm.weight", d, dev),
        output=_load_qtensor(reader, out_name, dev),
        out_norm_b=opt("output_norm.bias"), out_b=opt("output.bias"))
    if fuse:
        params = fuse_projections(params, cfg)
    return cfg, params, tok, reader
