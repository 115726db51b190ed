"""Llama-family forward of the port (llama / mistral, dense or Mixtral-style
routed MoE), stacked or unrolled.

Counterpart of llamafile_tpu/models/llama.py for the llama branches of
`_layer_fwd`, `forward` and `moe_ffn`. The JAX layer scan becomes a Python
loop over the layer id `li`. Homogeneous layers are stacked: the weights
stay whole and every kernel indexes layer li by pointer offset (no
per-layer slice copy); MoE expert stacks merge to [L*E, ...] so the routed
and grouped kernels index expert li*E + e in place. Layers that differ in
format (a Q4_K_M file) stay a list and run unrolled, as in the reference.
The KV cache is updated in place.

Per layer: RMSNorm folded into the qkv product(s) -> rope -> attention
(fused decode kernel with the KV-row write at T = 1 on a bf16 cache; the
flash_decode kernel over an int8 cache on stacked layers, the einsum on
unrolled ones; over the fresh tokens at prefill, the flash_prefill kernel
from 128 tokens and the einsum below) -> o -> RMSNorm folded into the FFN
(one fused kernel call at M = 1 for an interleaved q4b gate|up of stacked
layers, gate|up + down products otherwise), or, in a MoE layer, an inline
RMSNorm and moe_ffn.

moe_ffn routes as the reference does, by the S = M * n_experts_used routed
slots (moe_route names the branch):
  "fused"   S <= E, interleaved q4b gate|up and q4b down: qmm_moe_m1 once
            for all slots (Q4_K decode, serving at <= 4 rows of top-2-of-8)
  "routed"  S <= E otherwise: the routed GEMVs qmm_txn_m1_r / qmm_q8_m1_r
            for gate|up and down (Q4_K_M layers with Q6_K down, at decode)
  "grouped" S > E, q4b gate|up and down, d and d_ff % 256 == 0: slots
            sorted by expert into tiles of tm rows, qmm_txn_g (tm 8, 32) or
            qmm_planes_g (tm 128) per tile
  "dense"   otherwise: every expert on every row (qmatmul), mixed by the
            routing weights (Q4_K_M layers with Q6_K down, at prefill; per-
            expert dicts of experts that do not stack)
The grouped tile size follows the reference's rule under its CPU
interpreter on every device, `8 if S <= 64 else 32 if S <= 512 else 128`:
its TPU-only rule (always 128) exists for a Mosaic lane constraint that
Hopper does not have, and one rule keeps the CPU tests and the card on the
same kernels. Nothing on the MoE path reads a device value on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..ops.attention import flash_decode, flash_decode_write_stacked, flash_prefill
from ..ops.qmatmul import apply_rmsnorm as rmsnorm  # noqa: F401 (the reference's name)
from ..ops.qmatmul import (moe_fusable, qmatmul, qmatmul_grouped, qmatmul_moe,
                           qmatmul_routed, split_gu)
from ..ops.repack import QTensor, expert_slice
from ..runtime.kvcache import KVCache, init_kv, read_layer, update_layer


@dataclass(frozen=True)
class LlamaConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    n_vocab: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_scale: float = 1.0          # freq_scale = 1 / scaling.factor
    rope_yarn_ext: float = 0.0       # YaRN active when > 0
    rope_yarn_attn: float = 1.0
    rope_yarn_beta_fast: float = 32.0
    rope_yarn_beta_slow: float = 1.0
    rope_yarn_orig_ctx: int = 0
    rms_eps: float = 1e-5
    max_context: int = 8192
    rope_neox: bool = False          # False: interleaved pairs (llama NORM mode)
    attn_scale: float = 0.0          # 0 = 1/sqrt(head_dim)
    n_experts: int = 0               # routed MoE (Mixtral): experts a layer
    n_experts_used: int = 0          # top-k of them a token
    moe_norm_topk: bool = True       # renormalize the top-k weights to sum 1

    @classmethod
    def from_gguf(cls, reader) -> "LlamaConfig":
        arch = reader.architecture
        if arch not in ("llama", "mistral"):
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (llama, mistral)")
        f = reader.field
        d_model = int(f("{arch}.embedding_length"))
        n_heads = int(f("{arch}.attention.head_count"))
        n_vocab = f("{arch}.vocab_size")
        if n_vocab is None:
            n_vocab = len(reader.metadata.get("tokenizer.ggml.tokens", []))
        max_ctx = int(f("{arch}.context_length", 8192))
        is_yarn = str(f("{arch}.rope.scaling.type", "") or "").lower() == "yarn"
        if float(f("{arch}.expert_weights_scale", 1.0) or 1.0) != 1.0:
            raise NotImplementedError("expert_weights_scale != 1 is not ported yet")
        return cls(
            n_layers=int(f("{arch}.block_count")),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=int(f("{arch}.attention.head_count_kv", n_heads)),
            d_ff=int(f("{arch}.feed_forward_length")),
            n_vocab=int(n_vocab),
            head_dim=int(f("{arch}.attention.key_length", d_model // n_heads)),
            rope_theta=float(f("{arch}.rope.freq_base", 10000.0)),
            rope_scale=1.0 / float(f("{arch}.rope.scaling.factor", 1.0)),
            rope_yarn_ext=1.0 if is_yarn else 0.0,
            rope_yarn_attn=float(f("{arch}.rope.scaling.attn_factor", 1.0)),
            rope_yarn_orig_ctx=int(
                f("{arch}.rope.scaling.original_context_length", max_ctx)),
            rms_eps=float(f("{arch}.attention.layer_norm_rms_epsilon",
                            f("{arch}.attention.layer_norm_epsilon", 1e-5))
                          or 1e-5),
            max_context=max_ctx,
            attn_scale=float(f("{arch}.attention.scale", 0.0) or 0.0),
            n_experts=int(f("{arch}.expert_count", 0) or 0),
            n_experts_used=int(f("{arch}.expert_used_count", 0) or 0),
            moe_norm_topk=True,              # llama/mistral (Mixtral) renormalize
        )


CONFIG_FIELDS = tuple(f.name for f in fields(LlamaConfig))


@dataclass
class LlamaLayer:
    """One layer's weights, or all layers' stacked on a leading L axis."""
    attn_norm: torch.Tensor          # f32 [(L,) d]
    ffn_norm: torch.Tensor
    wo: QTensor
    wq: Optional[QTensor] = None
    wk: Optional[QTensor] = None
    wv: Optional[QTensor] = None
    wqkv: Optional[QTensor] = None   # fused q|k|v (single-device fast path)
    w_gate: Optional[QTensor] = None
    w_up: Optional[QTensor] = None
    w_gate_up: Optional[QTensor] = None   # fused gate|up (il: interleaved)
    w_down: Optional[QTensor] = None
    gate_inp: Optional[QTensor] = None    # MoE router [n_experts, d]
    # MoE experts: stacks by role ("gateup_il" | "gateup" | "gate", "up";
    # "down") with a leading E axis (L*E when stacked), or per-expert
    # QTensors ("gate.{e}", "up.{e}", "down.{e}") that do not stack
    experts: Optional[dict] = None


@dataclass
class LlamaParams:
    tok_embd: torch.Tensor           # bf16 [n_vocab, d]
    layers: object                   # List[LlamaLayer] or a stacked LlamaLayer
    out_norm: torch.Tensor           # f32 [d]
    output: QTensor                  # lm head [n_vocab, d]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _yarn_corr_dim(head_dim: int, orig_ctx: int, n_rot: float,
                   base: float) -> float:
    return (head_dim * np.log(orig_ctx / (n_rot * 2 * np.pi))
            / (2 * np.log(base)))


def rope_angles(pos: torch.Tensor, head_dim: int, theta: float, scale: float,
                cfg: Optional[LlamaConfig] = None):
    """Rotation angles [..., head_dim//2] (linear in pos); returns
    (ang, mscale). YaRN when cfg.rope_yarn_ext > 0 and scale != 1."""
    half = head_dim // 2
    i = torch.arange(0, half, dtype=torch.float32, device=pos.device)
    freqs = theta ** (-i / half)
    extrap = pos[..., None].float() * freqs
    if cfg is None or cfg.rope_yarn_ext == 0.0 or scale == 1.0:
        return extrap * scale, 1.0
    interp = extrap * scale
    low = np.floor(_yarn_corr_dim(head_dim, cfg.rope_yarn_orig_ctx,
                                  cfg.rope_yarn_beta_fast, theta))
    high = np.ceil(_yarn_corr_dim(head_dim, cfg.rope_yarn_orig_ctx,
                                  cfg.rope_yarn_beta_slow, theta))
    low, high = max(0.0, low), min(head_dim - 1.0, high)
    ramp = 1.0 - torch.clamp((i - low) / max(1e-3, high - low), 0.0, 1.0)
    mix = ramp * cfg.rope_yarn_ext
    ang = interp * (1.0 - mix) + extrap * mix
    mscale = cfg.rope_yarn_attn * (1.0 + 0.1 * np.log(1.0 / scale))
    return ang, float(mscale)


def rope_cos_sin(pos: torch.Tensor, head_dim: int, theta: float, scale: float,
                 cfg: Optional[LlamaConfig] = None):
    """pos int [...] -> cos/sin f32 [..., head_dim//2]."""
    ang, mscale = rope_angles(pos, head_dim, theta, scale, cfg)
    return torch.cos(ang) * mscale, torch.sin(ang) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               neox: bool) -> torch.Tensor:
    """x [..., H, head_dim]; cos/sin broadcastable [..., 1, head_dim//2]."""
    if neox:
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    # interleaved (NORM) pairs: out = x*cos2 + rot(x)*sin2 with
    # rot[2i] = -x[2i+1], rot[2i+1] = x[2i]
    d = x.shape[-1]
    cos2 = torch.repeat_interleave(cos, 2, dim=-1)
    sin2 = torch.repeat_interleave(sin, 2, dim=-1)
    even = torch.arange(d, device=x.device) % 2 == 0
    rot = torch.where(even, -torch.roll(x, -1, dims=-1), torch.roll(x, 1, dims=-1))
    return x * cos2 + rot * sin2


def attention(q, k_cache, v_cache, pos, t_pos, scale, window=None,
              softcap: float = 0.0):
    """GQA attention against the cache (einsum path).

    q [B, T, Hq, D]; k_cache/v_cache [B, S, Hkv, D]; pos [B] first new index;
    t_pos [T]. Key j is visible iff j <= pos + t (and j > pos + t - window)."""
    b, t, hq, d = q.shape
    s = k_cache.shape[1]
    hkv = k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, t, hkv, group, d).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.float()) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    j = torch.arange(s, device=q.device)[None, None, :]
    limit = (pos.long()[:, None] + t_pos[None, :])[:, :, None]       # [B, T, 1]
    mask = j <= limit
    if window is not None:
        mask = mask & (j > limit - window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v_cache.float())
    return out.reshape(b, t, hq, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# Layer stacking and the forward
# ---------------------------------------------------------------------------

def _stack_leaf(vals):
    if any(v is None for v in vals):
        if any(v is not None for v in vals):
            raise ValueError("layers differ in which weights they hold")
        return None
    if isinstance(vals[0], QTensor):
        q0 = vals[0]
        if any((v.kind, v.shape, v.g, v.il, v.bias is None)
               != (q0.kind, q0.shape, q0.g, q0.il, q0.bias is None) for v in vals):
            raise ValueError("layers differ in weight format")
        st = lambda a: None if a[0] is None else torch.stack(a)
        return QTensor(q0.kind, q0.shape, q0.g, st([v.qs for v in vals]),
                       st([v.scales for v in vals]), st([v.bias for v in vals]),
                       q0.il)
    return torch.stack(vals)


def _stack_experts(ls) -> Optional[dict]:
    """The layers' expert stacks merged to [L*E, ...] (expert li*E + e of
    layer li), or None unless every layer holds q4b stacks [E, ...] of the
    same roles and a router (the reference's rule: Q6_K experts and
    per-expert dicts stay unrolled)."""
    ex0 = ls[0].experts
    if not all(l.experts is not None and l.gate_inp is not None
               and set(l.experts) == set(ex0)
               and all(isinstance(v, QTensor) and v.kind == "q4b" and v.qs.ndim == 3
                       for v in l.experts.values()) for l in ls):
        return None
    merged = {}
    for role in ex0:
        st = _stack_leaf([l.experts[role] for l in ls])
        flat = lambda a: None if a is None else a.reshape(-1, *a.shape[2:])
        merged[role] = QTensor(st.kind, st.shape, st.g, flat(st.qs), flat(st.scales),
                               flat(st.bias), st.il)
    return merged


def stack_layers(params: LlamaParams) -> LlamaParams:
    """Stack the per-layer weights into one LlamaLayer with a leading L axis
    (the Engine's layout where it can). As the reference, returns params
    unchanged when they are stacked already, hold fewer than two layers, or
    when the layers differ in weight format or in which weights they hold
    (a Q4_K_M file mixes Q4_K and Q6_K): those run unrolled. MoE layers
    stack when every layer's experts are q4b stacks of the same roles; the
    [L, E, ...] leaves merge to [L*E, ...]."""
    ls = params.layers
    if not isinstance(ls, list) or len(ls) < 2:
        return params
    experts = None
    if any(l.experts is not None for l in ls):
        experts = _stack_experts(ls)
        if experts is None:
            return params
    try:
        stacked = LlamaLayer(experts=experts, **{
            f.name: _stack_leaf([getattr(l, f.name) for l in ls])
            for f in fields(LlamaLayer) if f.name != "experts"})
    except (ValueError, RuntimeError):      # formats, or shapes torch.stack refuses
        return params
    return LlamaParams(params.tok_embd, stacked, params.out_norm, params.output)


def _qkv(h2d, layer: LlamaLayer, cfg: LlamaConfig, wl, prenorm=None):
    """q, k, v [M, H*D] of h2d: the fused q|k|v product, or three."""
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    if layer.wqkv is not None:
        qkv = qmatmul(h2d, layer.wqkv, wl, prenorm=prenorm)
        return qkv[:, :nq], qkv[:, nq:nq + nkv], qkv[:, nq + nkv:nq + 2 * nkv]
    return tuple(qmatmul(h2d, w, wl, prenorm=prenorm)
                 for w in (layer.wq, layer.wk, layer.wv))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the reference computes it: jax.nn.silu's logistic
    expands to 1 / (1 + exp(-x)), each op rounded in x's dtype. For the bf16
    products of an unrolled prefill at M >= 256 this matches XLA's bf16
    result bit for bit, where a single rounding of the f32 silu would not."""
    return x * torch.reciprocal(1 + torch.exp(-x))


_DEVICE_IDS = {}


def _layer_ids(n: int, device):
    """(int32 arange(n), f32 ones(1)) on `device`, made once: the dense fused
    FFN takes a view [li:li+1] as its one expert id, weight one, so no host
    value is copied to the device a layer."""
    key = (str(device), n)
    if key not in _DEVICE_IDS:
        _DEVICE_IDS[key] = (torch.arange(n, dtype=torch.int32, device=device),
                            torch.ones(1, dtype=torch.float32, device=device))
    return _DEVICE_IDS[key]


def _ffn(h2d, layer: LlamaLayer, cfg: LlamaConfig, wl, prenorm=None):
    """FFN of h2d [M, d]. A MoE layer normalizes inline and runs moe_ffn
    (router and experts share the normed input). A dense SwiGLU runs one
    fused kernel call at M = 1 for an interleaved q4b gate|up of stacked
    layers (wl the layer id), otherwise gate|up (or gate and up), silu(g) *
    u, down (the reference's _ffn_core: the unrolled path never fuses). The
    products' dtype carries through, so bf16 q4b outputs at M >= 256 meet
    silu and the product in bf16."""
    if cfg.n_experts > 0 and layer.experts is not None:
        if prenorm is not None:
            h2d = rmsnorm(h2d, *prenorm)
        return moe_ffn(h2d, layer, cfg, li=wl)
    if layer.w_gate_up is not None:
        if (h2d.shape[0] == 1 and wl is not None and layer.w_gate_up.il
                and moe_fusable(layer.w_gate_up, layer.w_down, cfg.d_model, cfg.d_ff)):
            # the whole FFN in one fused kernel call, the layer id as expert
            ids, one = _layer_ids(layer.w_gate_up.qs.shape[0], h2d.device)
            return qmatmul_moe(h2d, layer.w_gate_up, layer.w_down, ids[wl:wl + 1], one,
                               prenorm=prenorm)
        g, u = split_gu(qmatmul(h2d, layer.w_gate_up, wl, prenorm=prenorm),
                        cfg.d_ff, layer.w_gate_up.il)
    else:
        g = qmatmul(h2d, layer.w_gate, wl, prenorm=prenorm)
        u = qmatmul(h2d, layer.w_up, wl, prenorm=prenorm)
    return qmatmul(silu(g) * u, layer.w_down, wl)


# ---------------------------------------------------------------------------
# Routed MoE FFN
# ---------------------------------------------------------------------------

def _gateup(ex: dict) -> Optional[QTensor]:
    return ex.get("gateup_il") or ex.get("gateup") or ex.get("gate")


def moe_route(layer: LlamaLayer, cfg: LlamaConfig, m: int) -> str:
    """Which formulation moe_ffn takes for m rows: "fused", "routed",
    "grouped" or "dense" (the reference's moe_ffn, by S = m * top-k)."""
    ex = layer.experts
    il = "gateup_il" in ex
    stacked = "gate" in ex or "gateup" in ex or il
    gu_qt = _gateup(ex)
    if stacked and m * cfg.n_experts_used <= cfg.n_experts:
        return ("fused" if il and moe_fusable(gu_qt, ex["down"], cfg.d_model, cfg.d_ff)
                else "routed")
    if (stacked and gu_qt.kind == "q4b" and ex["down"].kind == "q4b"
            and cfg.d_model % 256 == 0 and cfg.d_ff % 256 == 0):
        return "grouped"
    return "dense"


def top_k(weights: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties lower
    index first as jax.lax.top_k (a stable descending sort; torch.topk
    promises no order for ties)."""
    vals, idx = torch.sort(weights, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grouped_tm(s: int) -> int:
    """Row tile of the grouped kernels for s routed slots (see the module
    docstring): qmm_txn_g at 8 and 32 rows, qmm_planes_g at 128."""
    return 8 if s <= 64 else (32 if s <= 512 else 128)


def group_layout(gid: torch.Tensor, n_groups: int, tm: int):
    """The grouped kernels' row layout for rows of local expert gid [R]:
    (order, the rows sorted by expert, stable; pos, each sorted row's place
    in the padded buffer, every group starting on a tile of tm rows; te,
    each tile's expert; n_tiles, the static worst case ceil(R / tm) +
    min(n_groups + 1, R)). Group sizes are counted with scatter_add_ into a
    fixed-length buffer (bincount would read its maximum back), so nothing
    goes to the host."""
    r = gid.shape[0]
    dev = gid.device
    gid = gid.long()
    gs, order = torch.sort(gid, stable=True)
    counts = torch.zeros(n_groups + 1, dtype=torch.long, device=dev).scatter_add_(
        0, gid, torch.ones_like(gid))
    padc = (counts + tm - 1) // tm * tm
    pend = torch.cumsum(padc, 0)
    start = torch.cumsum(counts, 0) - counts
    pos = ((pend - padc).index_select(0, gs) + torch.arange(r, device=dev)
           - start.index_select(0, gs))
    n_tiles = -(-r // tm) + min(n_groups + 1, r)
    # tiles past the last group clamp to expert n_groups - 1: their rows
    # are zeros, so they stream real bytes and give zeros
    te = torch.clamp(torch.searchsorted(pend, torch.arange(n_tiles, device=dev) * tm,
                                        right=True), 0, n_groups - 1)
    return order, pos, te, n_tiles


def grouped_expert_ffn(rows: torch.Tensor, gid: torch.Tensor, w_row: torch.Tensor,
                       ex: dict, n_groups: int, tm: int, base: int = 0) -> torch.Tensor:
    """Grouped expert FFN (the reference's grouped_expert_ffn): rows [R, d],
    gid int [R] the local expert of each row, w_row f32 [R] its routing
    weight (applied between up and down). Rows are packed by group_layout
    into tile-aligned groups of a zero-padded buffer; tile i runs on expert
    base + te[i] (base = li * E under stacked layers). Returns f32 [R, d] in
    input order."""
    r, d = rows.shape
    dev = rows.device
    order, pos, te, n_tiles = group_layout(gid, n_groups, tm)
    xp = torch.zeros((n_tiles * tm, d), dtype=rows.dtype, device=dev).index_copy_(
        0, pos, rows.index_select(0, order))
    wp = torch.zeros((n_tiles * tm, 1), dtype=torch.float32, device=dev).index_copy_(
        0, pos, w_row.float().index_select(0, order)[:, None])
    te = base + te
    gu_qt = ex.get("gateup_il") or ex.get("gateup")
    if gu_qt is not None:
        g, u = split_gu(qmatmul_grouped(xp, gu_qt, te, tm=tm), gu_qt.shape[0] // 2,
                        "gateup_il" in ex)
    else:
        g = qmatmul_grouped(xp, ex["gate"], te, tm=tm)
        u = qmatmul_grouped(xp, ex["up"], te, tm=tm)
    y = (silu(g.float()) * u.float()) * wp
    dn = qmatmul_grouped(y, ex["down"], te, tm=tm)
    return torch.zeros((r, d), dtype=torch.float32, device=dev).index_copy_(
        0, order, dn.index_select(0, pos).float())


def _moe_grouped(x2d, ex, topw, topi, cfg: LlamaConfig, base: int = 0):
    """Flatten the (token, expert) slots, run the grouped FFN, sum each
    token's slots."""
    m, d = x2d.shape
    ku = cfg.n_experts_used
    s = m * ku
    tok = torch.arange(s, device=x2d.device) // ku
    y = grouped_expert_ffn(x2d.index_select(0, tok), topi.reshape(s), topw.reshape(s), ex,
                           cfg.n_experts, grouped_tm(s), base)
    return y.reshape(m, ku, d).sum(dim=1)


def moe_ffn(x2d: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig, li=None):
    """Mixtral-style routed MoE FFN of the normed x2d [M, d] (the
    reference's moe_ffn): router product, f32 softmax, top-k (renormalized
    when cfg.moe_norm_topk), then the formulation moe_route names. li (a
    Python int) is the layer id under stacking: the expert stacks hold every
    layer's experts [L*E, ...] and the kernels take ids li*E + e. f32 [M, d]."""
    m, d = x2d.shape
    k_used = cfg.n_experts_used
    base = 0 if li is None else li * cfg.n_experts
    router = qmatmul(x2d, layer.gate_inp, li)                   # [M, E]
    topw, topi = top_k(torch.softmax(router.float(), dim=-1), k_used)
    if cfg.moe_norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    ex = layer.experts
    il = "gateup_il" in ex
    gu_qt = _gateup(ex)
    s_n = m * k_used
    route = moe_route(layer, cfg, m)
    if route in ("fused", "routed"):
        ei = base + topi.reshape(s_n).to(torch.int32)
        if route == "fused":
            dn = qmatmul_moe(x2d, gu_qt, ex["down"], ei, topw.reshape(s_n))
        else:
            if "gateup" in ex or il:
                g, u = split_gu(qmatmul_routed(x2d, gu_qt, ei), cfg.d_ff, il)
            else:
                g, u = qmatmul_routed(x2d, ex["gate"], ei), qmatmul_routed(x2d, ex["up"], ei)
            y = (silu(g) * u) * topw.reshape(s_n, 1)            # weight before down
            dn = qmatmul_routed(y, ex["down"], ei, row_map=torch.arange(
                s_n, dtype=torch.int32, device=x2d.device))
        return dn.reshape(m, k_used, d).sum(dim=1)
    if route == "grouped":
        return _moe_grouped(x2d, ex, topw, topi, cfg, base)
    stacked = "gate" in ex or "gateup" in ex or il
    out = torch.zeros((m, d), dtype=torch.float32, device=x2d.device)
    for e in range(cfg.n_experts):
        eo = base + e
        if stacked and ("gateup" in ex or il):
            g, u = split_gu(qmatmul(x2d, expert_slice(gu_qt, eo)), cfg.d_ff, il)
        else:
            qg = expert_slice(ex["gate"], eo) if stacked else ex[f"gate.{e}"]
            qu = expert_slice(ex["up"], eo) if stacked else ex[f"up.{e}"]
            g, u = qmatmul(x2d, qg), qmatmul(x2d, qu)
        qd = expert_slice(ex["down"], eo) if stacked else ex[f"down.{e}"]
        y = qmatmul(silu(g) * u, qd)
        w_e = torch.where(topi == e, topw, torch.zeros_like(topw)).sum(dim=-1)
        out = out + y * w_e[:, None]
    return out


def _layer_fwd(x, layer: LlamaLayer, cfg: LlamaConfig, cos, sin, pos, t_pos,
               scale, cache: KVCache, attn_len, fresh: bool, li: int,
               stacked: bool):
    """One llama layer, updating layer li of the cache in place. stacked:
    `layer` holds all layers' weights and li indexes them (the reference's
    scanned _layer_fwd); else `layer` is layer li's own (its unrolled loop).

    Both fold the RMSNorms into the products' activation prep and write the
    new K/V rows first, except where the fused decode kernel writes them
    (T = 1 on a bf16 cache). An int8 cache decodes through the flash_decode
    kernel on stacked layers and the f32 einsum on unrolled ones, as the
    reference routes it."""
    b, t, d = x.shape
    s = cache.max_len
    wl = li if stacked else None
    pick = (lambda a: a[li]) if stacked else (lambda a: a)
    q, k, v = _qkv(x.reshape(b * t, d), layer, cfg, wl,
                   (pick(layer.attn_norm), cfg.rms_eps))
    q = apply_rope(q.reshape(b, t, cfg.n_heads, cfg.head_dim), cos, sin, cfg.rope_neox)
    k = apply_rope(k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim), cos, sin,
                   cfg.rope_neox)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    alen = attn_len if (attn_len is not None and attn_len < s) else s
    if t == 1 and not fresh and not cache.quantized:
        # the fused kernel reads layer li of the flat cache in place and
        # writes the new row at pos itself
        attn = flash_decode_write_stacked(
            q[:, 0], cache.k, cache.v, k[:, 0], v[:, 0], li, pos, scale,
            hkv=cfg.n_kv_heads, s_limit=alen if alen < s else None)[:, None]
    else:
        update_layer(cache, li, pos, t_pos, k, v)
        if fresh:
            attn = flash_prefill(q, k, v, scale)
        elif t == 1 and stacked:
            # int8 codes and scales of layer li, read in place
            sl = lambda a: a[li, :, :alen]
            attn = flash_decode(q[:, 0], sl(cache.k), sl(cache.v), pos, scale,
                                k_scale=sl(cache.k_scale),
                                v_scale=sl(cache.v_scale))[:, None]
        else:
            kci, vci = read_layer(cache, li, cfg.n_kv_heads)
            attn = attention(q, kci[:, :alen], vci[:, :alen], pos, t_pos, scale)
    o = qmatmul(attn.reshape(b * t, cfg.n_heads * cfg.head_dim), layer.wo, wl)
    x = x + o.reshape(b, t, d)
    f = _ffn(x.reshape(b * t, d), layer, cfg, wl, (pick(layer.ffn_norm), cfg.rms_eps))
    return x + f.reshape(b, t, d)


@torch.no_grad()
def forward(params: LlamaParams, cfg: LlamaConfig, tokens: torch.Tensor,
            pos: torch.Tensor, cache: KVCache, fresh_prefill: bool = False,
            attn_len: Optional[int] = None,
            last_idx: Optional[torch.Tensor] = None):
    """One forward pass over new tokens, on stacked layers (a LlamaLayer
    with a leading L axis) or unrolled ones (a list, one LlamaLayer each).

    tokens int [B, T]; pos int32 [B] index of tokens[:, 0]; cache (bf16 or
    int8) is updated in place. attn_len (decode) bounds the streamed cache
    positions; last_idx [B] keeps only that position's logits (prefill).
    Returns (logits f32 [B, T or 1, n_vocab], cache)."""
    b, t = tokens.shape
    dev = tokens.device
    t_pos = torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(pos.long()[:, None] + t_pos[None, :], cfg.head_dim,
                            cfg.rope_theta, cfg.rope_scale, cfg)  # [B, T, D/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.head_dim)
    x = params.tok_embd[tokens.long()].float()
    stacked = isinstance(params.layers, LlamaLayer)
    for li in range(cfg.n_layers):
        layer = params.layers if stacked else params.layers[li]
        x = _layer_fwd(x, layer, cfg, cos, sin, pos, t_pos, scale, cache,
                       attn_len, fresh_prefill, li, stacked)
    t_out = t
    if last_idx is not None:
        # only the next-token logits: slice before the lm head
        x = x[torch.arange(b, device=dev), last_idx.long()][:, None]
        t_out = 1
    logits = qmatmul(x.reshape(b * t_out, cfg.d_model), params.output,
                     prenorm=(params.out_norm, cfg.rms_eps))
    return logits.reshape(b, t_out, -1), cache


@torch.no_grad()
def forward_paged_decode(params: LlamaParams, cfg: LlamaConfig,
                         tok: torch.Tensor, pos: torch.Tensor, paged,
                         tables: torch.Tensor):
    """One decode step (T = 1 a row) over a paged KV cache, stacked or
    unrolled layers.

    Counterpart of the llama/mistral branches of the JAX package's
    forward_paged_decode. tok/pos int32 [R]; paged a runtime.paged.PagedKV,
    updated IN PLACE (each row's new K/V at page tables[r, pos // ps],
    offset pos % ps); tables int32 [R, MAXP]. Each row attends to its
    pos + 1 positions through the paged_attention kernel, which reads layer
    li of the pool by pointer (`pool[li]` is a view). As in the reference,
    the attention norm runs before the products; the FFN norm does too on
    stacked layers and folds into the FFN's products on unrolled ones.
    Returns (logits f32 [R, V], paged)."""
    from ..runtime.paged import paged_attend, write_token_kv
    for name in ("swa_window", "alibi", "kv_lora_rank"):
        if getattr(cfg, name, 0):
            raise NotImplementedError(f"paged decode with {name} is not ported")
    stacked = isinstance(params.layers, LlamaLayer)
    r = tok.shape[0]
    ps = paged.page_size
    dev = tok.device
    p64 = pos.long()
    x = params.tok_embd[tok.long()].float()                       # [R, d]
    cos, sin = rope_cos_sin(p64[:, None], cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scale, cfg)                  # [R, 1, D/2]
    pages = torch.gather(tables.long(), 1, (p64 // ps)[:, None])[:, 0]
    offs = p64 % ps
    lengths = (pos + 1).to(torch.int32).to(dev)
    tables = tables.to(torch.int32).contiguous()
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.head_dim)
    quant = paged.quantized
    for li in range(cfg.n_layers):
        layer = params.layers if stacked else params.layers[li]
        wl = li if stacked else None
        pick = (lambda a: a[li]) if stacked else (lambda a: a)
        h = rmsnorm(x, pick(layer.attn_norm), cfg.rms_eps)
        q, k, v = _qkv(h, layer, cfg, wl)
        q = apply_rope(q.reshape(r, cfg.n_heads, cfg.head_dim), cos, sin,
                       cfg.rope_neox)
        k = apply_rope(k.reshape(r, cfg.n_kv_heads, cfg.head_dim), cos, sin,
                       cfg.rope_neox)
        v = v.reshape(r, cfg.n_kv_heads, cfg.head_dim)
        ksl = paged.k_scale[li] if quant else None
        vsl = paged.v_scale[li] if quant else None
        write_token_kv(paged.k_pages[li], paged.v_pages[li], k, v, pages, offs,
                       ksl, vsl)
        attn = paged_attend((q * scale).float(), paged.k_pages[li],
                            paged.v_pages[li], lengths, tables,
                            k_scale_l=ksl, v_scale_l=vsl)
        x = x + qmatmul(attn.reshape(r, cfg.n_heads * cfg.head_dim), layer.wo, wl)
        if stacked:
            f = _ffn(rmsnorm(x, pick(layer.ffn_norm), cfg.rms_eps), layer, cfg, wl)
        else:
            f = _ffn(x, layer, cfg, None, (layer.ffn_norm, cfg.rms_eps))
        x = x + f
    logits = qmatmul(rmsnorm(x, params.out_norm, cfg.rms_eps), params.output)
    return logits, paged


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    return init_kv(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                   dtype, device=device)
