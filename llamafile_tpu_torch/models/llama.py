"""Llama-family forward of the port (llama / mistral), over stacked layers.

Counterpart of llamafile_tpu/models/llama.py for the dense llama branch of
`_layer_fwd` and the stacked branch of `forward`. The JAX layer scan becomes
a Python loop over the layer id `li`: the stacked weights stay whole and
every kernel indexes layer li by pointer offset (no per-layer slice copy),
and the KV cache is updated in place.

Per layer: RMSNorm folded into the fused qkv product -> rope -> attention
(fused decode kernel with the KV-row write at T = 1; over the fresh tokens
at prefill, the flash_prefill kernel from 128 tokens and the einsum below)
-> o -> RMSNorm folded into the FFN (one fused kernel call at M = 1 for an
interleaved q4b gate|up, gate|up + down products otherwise).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..ops.attention import flash_decode_write_stacked, flash_prefill
from ..ops.qmatmul import apply_rmsnorm as rmsnorm  # noqa: F401 (the reference's name)
from ..ops.qmatmul import moe_fusable, qmatmul, qmatmul_moe, split_gu
from ..ops.repack import QTensor
from ..runtime.kvcache import KVCache, init_kv


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
        if int(f("{arch}.expert_count", 0) or 0):
            raise NotImplementedError("MoE llama models are not ported yet")
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
    if vals[0] is None:
        if any(v is not None for v in vals):
            raise NotImplementedError("layers differ in which weights they hold")
        return None
    if isinstance(vals[0], QTensor):
        q0 = vals[0]
        if any((v.kind, v.shape, v.g, v.il, v.bias is None)
               != (q0.kind, q0.shape, q0.g, q0.il, q0.bias is None) for v in vals):
            raise NotImplementedError(
                "layers with differing weight formats cannot be stacked; the "
                "unrolled forward is not ported yet")
        st = lambda a: None if a[0] is None else torch.stack(a)
        return QTensor(q0.kind, q0.shape, q0.g, st([v.qs for v in vals]),
                       st([v.scales for v in vals]), st([v.bias for v in vals]),
                       q0.il)
    return torch.stack(vals)


def stack_layers(params: LlamaParams) -> LlamaParams:
    """Stack the per-layer weights into one LlamaLayer with a leading L axis
    (the Engine's default layout). Idempotent."""
    ls = params.layers
    if isinstance(ls, LlamaLayer):
        return params
    stacked = LlamaLayer(**{f.name: _stack_leaf([getattr(l, f.name) for l in ls])
                            for f in fields(LlamaLayer)})
    return LlamaParams(params.tok_embd, stacked, params.out_norm, params.output)


def _put(buf: torch.Tensor, li: int, pos: torch.Tensor, t_pos: torch.Tensor,
         new: torch.Tensor) -> None:
    """Write rows new [B, T, H, D] at positions pos + t of layer li, in
    place; positions past the cache are dropped (prefill bucket padding)."""
    b, t = new.shape[:2]
    idx = pos.long()[:, None] + t_pos[None, :]
    bidx = torch.arange(b, device=buf.device)[:, None].expand(b, t)
    keep = idx < buf.shape[2]
    buf[li, bidx[keep], idx[keep]] = new.reshape(b, t, -1)[keep].to(buf.dtype)


def _layer_fwd(x, layer: LlamaLayer, cfg: LlamaConfig, cos, sin, pos, t_pos,
               scale, cache: KVCache, attn_len, fresh: bool, li: int):
    """One llama layer on stacked weights (layer li). Updates cache in place."""
    b, t, d = x.shape
    s = cache.max_len
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    pn = (layer.attn_norm[li], cfg.rms_eps)
    h2d = x.reshape(b * t, d)
    if layer.wqkv is not None:
        qkv = qmatmul(h2d, layer.wqkv, li, prenorm=pn)
        q, k, v = qkv[:, :nq], qkv[:, nq:nq + nkv], qkv[:, nq + nkv:nq + 2 * nkv]
    else:
        q = qmatmul(h2d, layer.wq, li, prenorm=pn)
        k = qmatmul(h2d, layer.wk, li, prenorm=pn)
        v = qmatmul(h2d, layer.wv, li, prenorm=pn)
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin, cfg.rope_neox)
    k = apply_rope(k, cos, sin, cfg.rope_neox)

    fused_write = t == 1 and not fresh
    if not fused_write:
        _put(cache.k, li, pos, t_pos, k)
        _put(cache.v, li, pos, t_pos, v)
    if fresh:
        attn = flash_prefill(q, k, v, scale)
    elif fused_write:
        # the fused kernel reads layer li of the flat cache in place and
        # writes the new row at pos itself
        attn = flash_decode_write_stacked(
            q[:, 0], cache.k, cache.v, k[:, 0], v[:, 0], li, pos, scale,
            hkv=cfg.n_kv_heads,
            s_limit=attn_len if (attn_len is not None and attn_len < s) else None)
        attn = attn[:, None]
    else:
        alen = attn_len if (attn_len is not None and attn_len < s) else s
        kci = cache.k[li, :, :alen].reshape(b, alen, cfg.n_kv_heads, cfg.head_dim)
        vci = cache.v[li, :, :alen].reshape(b, alen, cfg.n_kv_heads, cfg.head_dim)
        attn = attention(q, kci, vci, pos, t_pos, scale)
    o = qmatmul(attn.reshape(b * t, nq), layer.wo, li)
    x = x + o.reshape(b, t, d)

    pn_f = (layer.ffn_norm[li], cfg.rms_eps)
    h2d = x.reshape(b * t, d)
    if layer.w_gate_up is not None:
        if (b * t == 1 and layer.w_gate_up.il
                and moe_fusable(layer.w_gate_up, layer.w_down, d, cfg.d_ff)):
            # the whole FFN in one fused kernel call, the layer id as expert
            f = qmatmul_moe(h2d, layer.w_gate_up, layer.w_down, [li], [1.0],
                            prenorm=pn_f)
        else:
            gu = qmatmul(h2d, layer.w_gate_up, li, prenorm=pn_f)
            g, u = split_gu(gu, cfg.d_ff, layer.w_gate_up.il)
            f = qmatmul(torch.nn.functional.silu(g) * u, layer.w_down, li)
    else:
        g = qmatmul(h2d, layer.w_gate, li, prenorm=pn_f)
        u = qmatmul(h2d, layer.w_up, li, prenorm=pn_f)
        f = qmatmul(torch.nn.functional.silu(g) * u, layer.w_down, li)
    return x + f.reshape(b, t, d)


@torch.no_grad()
def forward(params: LlamaParams, cfg: LlamaConfig, tokens: torch.Tensor,
            pos: torch.Tensor, cache: KVCache, fresh_prefill: bool = False,
            attn_len: Optional[int] = None,
            last_idx: Optional[torch.Tensor] = None):
    """One forward pass over new tokens on stacked layers.

    tokens int [B, T]; pos int32 [B] index of tokens[:, 0]; cache is updated
    in place. attn_len (decode) bounds the streamed cache positions;
    last_idx [B] keeps only that position's logits (prefill).
    Returns (logits f32 [B, T or 1, n_vocab], cache)."""
    if not isinstance(params.layers, LlamaLayer):
        raise NotImplementedError("the port's forward runs stacked layers: "
                                  "call stack_layers first")
    b, t = tokens.shape
    dev = tokens.device
    t_pos = torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(pos.long()[:, None] + t_pos[None, :], cfg.head_dim,
                            cfg.rope_theta, cfg.rope_scale, cfg)  # [B, T, D/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.head_dim)
    x = params.tok_embd[tokens.long()].float()
    for li in range(cfg.n_layers):
        x = _layer_fwd(x, params.layers, cfg, cos, sin, pos, t_pos, scale,
                       cache, attn_len, fresh_prefill, li)
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
    """One decode step (T = 1 a row) over a paged KV cache, stacked layers.

    Counterpart of the stacked llama/mistral branch of the JAX package's
    forward_paged_decode. tok/pos int32 [R]; paged a runtime.paged.PagedKV,
    updated IN PLACE (each row's new K/V at page tables[r, pos // ps],
    offset pos % ps); tables int32 [R, MAXP]. Each row attends to its
    pos + 1 positions through the paged_attention kernel, which reads layer
    li of the pool by pointer (`pool[li]` is a view). As in the reference,
    the norms run before each product (not folded into it). Returns
    (logits f32 [R, V], paged)."""
    from ..runtime.paged import paged_attend, write_token_kv
    if not isinstance(params.layers, LlamaLayer):
        raise NotImplementedError("paged decode of unrolled layers is not "
                                  "ported yet: call stack_layers first")
    for name in ("swa_window", "alibi", "kv_lora_rank"):
        if getattr(cfg, name, 0):
            raise NotImplementedError(f"paged decode with {name} is not ported")
    sl = params.layers
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
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    quant = paged.quantized
    for li in range(cfg.n_layers):
        h = rmsnorm(x, sl.attn_norm[li], cfg.rms_eps)
        if sl.wqkv is not None:
            qkv = qmatmul(h, sl.wqkv, li)
            q, k, v = qkv[:, :nq], qkv[:, nq:nq + nkv], qkv[:, nq + nkv:nq + 2 * nkv]
        else:
            q, k, v = (qmatmul(h, sl.wq, li), qmatmul(h, sl.wk, li),
                       qmatmul(h, sl.wv, li))
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
        x = x + qmatmul(attn.reshape(r, nq), sl.wo, li)
        h = rmsnorm(x, sl.ffn_norm[li], cfg.rms_eps)
        if sl.w_gate_up is not None:
            if r == 1 and sl.w_gate_up.il and moe_fusable(
                    sl.w_gate_up, sl.w_down, cfg.d_model, cfg.d_ff):
                # single-row paged decode: the fused FFN, layer id as expert
                f = qmatmul_moe(h, sl.w_gate_up, sl.w_down, [li], [1.0])
            else:
                g, u = split_gu(qmatmul(h, sl.w_gate_up, li), cfg.d_ff,
                                sl.w_gate_up.il)
                f = qmatmul(torch.nn.functional.silu(g) * u, sl.w_down, li)
        else:
            g, u = qmatmul(h, sl.w_gate, li), qmatmul(h, sl.w_up, li)
            f = qmatmul(torch.nn.functional.silu(g) * u, sl.w_down, li)
        x = x + f
    logits = qmatmul(rmsnorm(x, params.out_norm, cfg.rms_eps), params.output)
    return logits, paged


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    return init_kv(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                   dtype, device=device)
