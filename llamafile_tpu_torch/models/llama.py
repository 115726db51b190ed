"""Llama-family forward of the port (llama / mistral, dense or Mixtral-style
routed MoE; gemma, gemma2, gemma3; qwen2, qwen3; the LayerNorm families
gptneox, falcon, starcoder2, phi2, command-r), stacked or unrolled.

Counterpart of llamafile_tpu/models/llama.py for the llama branches of
`_layer_fwd`, `forward` and `moe_ffn`. The JAX layer scan becomes a Python
loop over the layer id `li`. Homogeneous layers are stacked: the weights
stay whole and every kernel indexes layer li by pointer offset (no
per-layer slice copy); MoE expert stacks merge to [L*E, ...] so the routed
and grouped kernels index expert li*E + e in place. Layers that differ in
format (a Q4_K_M file) stay a list and run unrolled, as in the reference.
The KV cache is updated in place.

Per layer: RMSNorm folded into the qkv product(s) -> rope -> attention
(fused decode kernel with the KV-row write at T = 1 on a bf16, f16 or f32
cache; the flash_decode kernel over an int8 cache, except on stacked layers with a
sliding window, which take the einsum as the reference's do; over the
fresh tokens at prefill, the flash_prefill kernel from 128 tokens and the
einsum below) -> o -> RMSNorm folded into the FFN (one fused kernel call at
M = 1 for an interleaved q4b gate|up of stacked SwiGLU layers, gate|up +
down products otherwise), or, in a MoE layer, an inline RMSNorm and
moe_ffn.

Gemma (the reference's gemma branches): every gemma multiplies the
embedding by sqrt(d) and runs a GELU-tanh FFN (never the fused one); gemma
1 adds nothing more. Gemma 2 adds a sliding window on layers li %
swa_pattern < swa_pattern - 1 (None, not the reference's 1 << 30, on the
others: the layer loop is Python), the attention softcap in every attention
call (the decode kernels take it and the window as options; prefill runs
the einsum with them), RMSNorms of o and of the FFN output before their
residuals, and the final logit softcap. Gemma 3 keeps the window (five
layers of each six) and the post norms without softcaps, normalizes each
head of q and k before rope (qk_norm), and ropes its windowed layers with
a second table (swa_rope_theta, scale 1) picked per layer. With no softcap
its prefill takes the flash_prefill kernel on every layer up to the window
and on the global layers past it (the reference's scan, whose traced
window is never None, sends those to the einsum: the same function).

Qwen (the reference's qwen branches): rope NEOX; qwen2 adds its q/k/v
biases (attn_qkv_bias) to the products' outputs, qwen3 normalizes each head
of q and k before rope as gemma3 does. Both run under the paged decode.
forward(return_hidden=True) gives the final-normed hidden states before
the head, which the embeddings endpoint pools.

The LayerNorm families (the reference's norm_type "ln" branches): every
norm is an affine LayerNorm in f32 (norm_fn; a bias but in command-r),
never folded into the products' activation prep; rope NEOX (command-r's
interleaved pairs) on the first rope_dim dims of each head (_rope_qk;
gptneox and phi2 partial); q/k/v biases (gptneox's split from its fused
qkv, starcoder2's, phi2's), the output projection's bias (bo); a gateless
FFN (up, + b_up, erf GELU, down, + b_down) but in command-r, which keeps
SwiGLU; a parallel residual x + (o + f) for gptneox (by metadata), falcon,
phi2 and command-r, its FFN fed by the attention norm's output where the
layer has no ffn_norm (falcon-7B-style, phi2, command-r); the output
norm's bias, phi2's head bias and command-r's logit scale
(_finish_logits). Their layers never stack (stack_layers), as in the
reference.

int8_prefill_params attaches the int8 prefill companions (the Engine does
so under LLAMAFILE_TPU_I8P=1): every product of over 32 rows on a layer
weight then runs the qmm_i8p kernel, stacked or unrolled.

LLAMAFILE_TPU_PRENORM=0 (read at import into PRENORM, as the reference
reads its _PRENORM) runs each RMSNorm before its product instead of
folding it into the product's activation prep: the qkv and FFN norms of
forward and the unrolled FFN norm of forward_paged_decode, and the head's
norm of forward (forward_paged_decode runs its other norms apart always,
as the reference's does). Under LLAMAFILE_TPU_FLASH_DECODE=0
(ops.attention.FLASH_DECODE) a T = 1 step on a dense cache writes its rows
and takes the f32 einsum (decode_route), never flash_decode_write_stacked.
While utils.tracing's trap is on (--trap), forward and
forward_paged_decode hold each layer's output and the logits to be finite.

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
import os
from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..ops import attention as _attention
from ..ops.attention import flash_decode, flash_decode_write_stacked, flash_prefill
from ..ops.qmatmul import apply_rmsnorm as rmsnorm  # noqa: F401 (the reference's name)
from ..ops.qmatmul import (moe_fusable, qmatmul, qmatmul_grouped, qmatmul_moe,
                           qmatmul_routed, split_gu)
from ..ops.repack import I8PQTensor, QTensor, attach_int8_prefill, expert_slice
from ..runtime.kvcache import KVCache, init_kv, read_layer, update_layer
from ..utils import tracing

PRENORM = os.environ.get("LLAMAFILE_TPU_PRENORM", "1") != "0"
LN_ARCHS = ("gptneox", "falcon", "starcoder2", "phi2", "command-r")


def _prenormed(x2d: torch.Tensor, w: torch.Tensor, eps: float):
    """(input, prenorm) of the products after an RMSNorm of weight w: the
    norm folded into their activation prep under PRENORM, else applied
    first (the reference's norm_fn), as its _PRENORM chooses."""
    if PRENORM:
        return x2d, (w, eps)
    return rmsnorm(x2d, w, eps), None


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
    attn_qkv_bias: bool = False      # qwen2: q/k/v biases after the products
    attn_scale: float = 0.0          # 0 = 1/sqrt(head_dim)
    n_experts: int = 0               # routed MoE (Mixtral): experts a layer
    n_experts_used: int = 0          # top-k of them a token
    moe_norm_topk: bool = True       # renormalize the top-k weights to sum 1
    # gemma: embedding scale, GELU-tanh FFN; gemma2/3: sliding window on
    # layers li % swa_pattern < swa_pattern - 1, sandwich norms; gemma2:
    # softcaps; gemma3 (and qwen3): per-head q/k RMSNorm; gemma3: windowed
    # layers' rope base
    embd_scale: float = 1.0
    ffn_gelu: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    swa_window: int = 0
    swa_pattern: int = 1
    swa_rope_theta: float = 0.0      # rope base of windowed layers (0 = rope_theta)
    post_norms: bool = False
    qk_norm: bool = False
    # the LayerNorm families: "ln" an affine LayerNorm with a bias (gptneox,
    # falcon, starcoder2, phi2, command-r); attention and FFN from the same
    # input into one residual add; rope on the first rope_dim dims (0 = all);
    # logits divided by logit_scale (command-r: 1 / its logit_scale)
    norm_type: str = "rms"
    parallel_residual: bool = False
    rope_dim: int = 0
    logit_scale: float = 1.0

    @classmethod
    def from_gguf(cls, reader) -> "LlamaConfig":
        arch = reader.architecture
        if arch not in ("llama", "mistral", "gemma", "gemma2", "gemma3", "qwen2", "qwen3",
                        *LN_ARCHS):
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (llama, mistral, gemma, "
                "gemma2, gemma3, qwen2, qwen3, " + ", ".join(LN_ARCHS) + ")")
        f = reader.field
        d_model = int(f("{arch}.embedding_length"))
        n_heads = int(f("{arch}.attention.head_count"))
        n_layers = int(f("{arch}.block_count"))
        head_dim = int(f("{arch}.attention.key_length", d_model // n_heads))
        branch = {}
        if arch.startswith("gemma"):
            # the reference's gemma branches: rope NEOX, the embedding times
            # sqrt(d), GELU-tanh, and attn_scale from the branch alone
            # ({arch}.attention.scale is ignored; 0 = 1 / sqrt(head_dim)).
            # The GGUF's norm weights carry gemma's +1 already (the
            # converter bakes it in).
            branch = dict(rope_neox=True, embd_scale=float(d_model) ** 0.5, ffn_gelu=True,
                         attn_scale=0.0)
        q_scale_27b = 1.0 / float(d_model / n_heads) ** 0.5
        if arch == "gemma2":
            # a 4096 window on every other layer, softcaps 50 / 30, sandwich
            # norms; q scaled by (d / h)^-1/2 at 46 layers (27B)
            branch.update(
                swa_window=int(f("{arch}.attention.sliding_window", 4096)), swa_pattern=2,
                attn_softcap=float(f("{arch}.attn_logit_softcapping", 50.0)),
                final_softcap=float(f("{arch}.final_logit_softcapping", 30.0)),
                post_norms=True, attn_scale=q_scale_27b if n_layers == 46 else 0.0)
        elif arch == "gemma3":
            # a 1024 window on five layers of each six, roped at base 10000
            # (the global layers keep rope.freq_base and its linear factor),
            # sandwich norms, per-head q/k norms; q scaled by (d / h)^-1/2 at
            # 62 layers (27B), else 1 / sqrt(head_dim)
            branch.update(
                swa_window=int(f("{arch}.attention.sliding_window", 1024)), swa_pattern=6,
                swa_rope_theta=10000.0, post_norms=True, qk_norm=True,
                attn_scale=(q_scale_27b if n_layers == 62
                            else 1.0 / float(head_dim) ** 0.5))
        if arch.startswith("qwen"):
            # the reference's qwen branches: rope NEOX; qwen2's q/k/v biases,
            # qwen3's per-head q/k norms; attn_scale from metadata below
            branch = dict(rope_neox=True, attn_qkv_bias=arch == "qwen2", qk_norm=arch == "qwen3")
        if arch in LN_ARCHS:
            # the reference's LayerNorm branches: rope NEOX (command-r's
            # interleaved pairs, as llama.cpp's), q/k/v biases of gptneox and
            # starcoder2, partial rope from rope.dimension_count (not
            # command-r's), the parallel residual (gptneox by metadata,
            # default on; falcon, phi2, command-r always), GELU (starcoder2's
            # flag: its FFN is gateless, so the erf GELU runs as in the others)
            branch = dict(
                rope_neox=arch != "command-r", attn_qkv_bias=arch in ("gptneox", "starcoder2"),
                norm_type="ln", ffn_gelu=arch == "starcoder2",
                rope_dim=(int(f("{arch}.rope.dimension_count", 0) or 0)
                          if arch != "command-r" else 0),
                parallel_residual=(bool(f("{arch}.use_parallel_residual", True))
                                   if arch == "gptneox" else arch != "starcoder2"))
        n_vocab = f("{arch}.vocab_size")
        if n_vocab is None:
            n_vocab = len(reader.metadata.get("tokenizer.ggml.tokens", []))
        max_ctx = int(f("{arch}.context_length", 8192))
        is_yarn = str(f("{arch}.rope.scaling.type", "") or "").lower() == "yarn"
        if float(f("{arch}.expert_weights_scale", 1.0) or 1.0) != 1.0:
            raise NotImplementedError("expert_weights_scale != 1 is not ported yet")
        kw = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=int(f("{arch}.attention.head_count_kv", n_heads)),
            d_ff=int(f("{arch}.feed_forward_length")),
            n_vocab=int(n_vocab),
            head_dim=head_dim,
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
            # command-r multiplies its logits by logit_scale; the others divide
            logit_scale=(1.0 / float(f("{arch}.logit_scale", 1.0) or 1.0)
                         if arch == "command-r"
                         else float(f("{arch}.logit_scale", 0.0) or 1.0)),
        )
        return cls(**{**kw, **branch})


CONFIG_FIELDS = tuple(f.name for f in fields(LlamaConfig))


@dataclass
class LlamaLayer:
    """One layer's weights, or all layers' stacked on a leading L axis."""
    attn_norm: torch.Tensor          # f32 [(L,) d]
    # None under the parallel residual where the layer has no FFN norm
    # (falcon-7B-style, phi2, command-r): the FFN then reads the attention
    # norm's output, not the raw residual
    ffn_norm: Optional[torch.Tensor]
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
    attn_post_norm: Optional[torch.Tensor] = None   # gemma2/3 sandwich norms, f32 [(L,) d]
    ffn_post_norm: Optional[torch.Tensor] = None
    q_norm: Optional[torch.Tensor] = None           # gemma3/qwen3 per-head norms, f32 [(L,) head_dim]
    k_norm: Optional[torch.Tensor] = None
    bq: Optional[torch.Tensor] = None               # q/k/v biases, f32 [(L,) H*D]
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None
    # the LayerNorm families (unrolled only): the norms' biases, the output
    # projection's, the gateless FFN's up and down biases, f32
    attn_norm_b: Optional[torch.Tensor] = None
    ffn_norm_b: Optional[torch.Tensor] = None
    bo: Optional[torch.Tensor] = None
    b_up: Optional[torch.Tensor] = None
    b_down: Optional[torch.Tensor] = None


@dataclass
class LlamaParams:
    tok_embd: torch.Tensor           # bf16 [n_vocab, d]
    layers: object                   # List[LlamaLayer] or a stacked LlamaLayer
    out_norm: torch.Tensor           # f32 [d]
    output: QTensor                  # lm head [n_vocab, d]
    out_norm_b: Optional[torch.Tensor] = None   # the LayerNorm families' output norm bias
    out_b: Optional[torch.Tensor] = None        # phi2's head bias [n_vocab]


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


def norm_fn(x: torch.Tensor, w, cfg: LlamaConfig, b=None) -> torch.Tensor:
    """The model's norm (the reference's norm_fn): RMSNorm, or for
    norm_type "ln" an affine LayerNorm in f32 in the reference's order
    (the mean, the mean of the squared centred values, rsqrt(var + eps),
    times w, plus b). Not torch.nn.functional.layer_norm: a product's int8
    activation code one step off moves its row by about 1%."""
    if cfg.norm_type == "ln":
        x32 = x.float()
        c = x32 - x32.mean(dim=-1, keepdim=True)
        out = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + cfg.rms_eps) * w
        return out if b is None else out + b
    return rmsnorm(x, w, cfg.rms_eps)


def _rope_qk(q, k, cos, sin, cfg: LlamaConfig):
    """Rope q and k [..., H, head_dim] on their first rope_dim dims (all
    when rope_dim is 0), the rest passed through; cos/sin are rope_dim / 2
    wide."""
    rd = cfg.rope_dim or cfg.head_dim
    if rd == cfg.head_dim:
        return apply_rope(q, cos, sin, cfg.rope_neox), apply_rope(k, cos, sin, cfg.rope_neox)
    return (torch.cat([apply_rope(q[..., :rd], cos, sin, cfg.rope_neox), q[..., rd:]], dim=-1),
            torch.cat([apply_rope(k[..., :rd], cos, sin, cfg.rope_neox), k[..., rd:]], dim=-1))


def _finish_logits(logits: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """gemma2's final softcap, then the logits divided by logit_scale."""
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.logit_scale != 1.0:
        logits = logits / cfg.logit_scale
    return logits


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
        if any((type(v), v.kind, v.shape, v.g, v.il, v.bias is None)
               != (type(q0), q0.kind, q0.shape, q0.g, q0.il, q0.bias is None) for v in vals):
            raise ValueError("layers differ in weight format")
        st = lambda a: None if a[0] is None else torch.stack(a)
        base = (q0.kind, q0.shape, q0.g, st([v.qs for v in vals]),
                st([v.scales for v in vals]), st([v.bias for v in vals]), q0.il)
        if isinstance(q0, I8PQTensor):      # the int8 prefill companions too
            return I8PQTensor(*base, st([v.qs8 for v in vals]), st([v.s8 for v in vals]))
        return QTensor(*base)
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


I8P_FIELDS = ("wq", "wk", "wv", "wo", "wqkv", "w_gate_up", "w_gate", "w_up", "w_down")


def int8_prefill_params(params: LlamaParams) -> LlamaParams:
    """Attach int8-g256 prefill companions (ops.repack.attach_int8_prefill)
    to every per-layer matmul weight (the reference's int8_prefill_params,
    with its field list: not the lm head, not the experts). Prefill products
    of M > 32 rows then take the qmm_i8p kernel; decode and every other path
    are unchanged. Costs about one byte a weight of device memory (the base
    leaves are shared, not copied). Layers that are stacked already pass
    through."""
    if not isinstance(params.layers, list):
        return params
    layers = [replace(layer, **{f: attach_int8_prefill(getattr(layer, f)) for f in I8P_FIELDS})
              for layer in params.layers]
    return replace(params, layers=layers)


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
    if (ls[0].attn_norm_b is not None or ls[0].bo is not None or ls[0].b_up is not None
            or ls[0].ffn_norm is None):
        # the LayerNorm families and the shared norm of command-r run
        # unrolled, as the reference's scan has no branch for them
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
    return replace(params, layers=stacked)


def _qkv(h2d, layer: LlamaLayer, cfg: LlamaConfig, wl, prenorm=None):
    """q, k, v [M, H*D] of h2d: the fused q|k|v product, or three; then
    qwen2's q/k/v biases (layer wl's under stacking), as the reference adds
    them, before any q/k norm and rope. The q4b bias term of a QTensor
    (QTensor.bias) is another thing, inside qmatmul."""
    nq = cfg.n_heads * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    if layer.wqkv is not None:
        qkv = qmatmul(h2d, layer.wqkv, wl, prenorm=prenorm)
        q, k, v = qkv[:, :nq], qkv[:, nq:nq + nkv], qkv[:, nq + nkv:nq + 2 * nkv]
    else:
        q, k, v = (qmatmul(h2d, w, wl, prenorm=prenorm)
                   for w in (layer.wq, layer.wk, layer.wv))
    if layer.bq is not None:
        pick = (lambda a: a) if wl is None else (lambda a: a[wl])
        q, k, v = q + pick(layer.bq), k + pick(layer.bk), v + pick(layer.bv)
    return q, k, v


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the reference computes it: jax.nn.silu's logistic
    expands to 1 / (1 + exp(-x)), each op rounded in x's dtype. For the bf16
    products of an unrolled prefill at M >= 256 this matches XLA's bf16
    result bit for bit, where a single rounding of the f32 silu would not."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=True) as the reference computes it, op by
    op in x's dtype with its constants rounded to that dtype:
    x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x^3))))."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x, approximate=False) as the reference computes it, op by
    op in x's dtype with sqrt(1/2) rounded to that dtype:
    (0.5 * x) * erfc(-x * sqrt(1/2))."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    return (c(0.5) * x) * torch.special.erfc(-x * c(math.sqrt(0.5)))


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
    u, down (the reference's _ffn_core: the unrolled path never fuses); a
    gated GELU FFN (cfg.ffn_gelu) always the latter with gelu_tanh(g); a
    gateless FFN (the LayerNorm families) up, + b_up, gelu_erf, down. Then
    + b_down. The products' dtype carries through, so bf16 q4b outputs at
    M >= 256 meet the activation and the product in bf16 (an f32 b_up
    promotes the up product to f32 first, as JAX promotes)."""
    if cfg.n_experts > 0 and layer.experts is not None:
        if prenorm is not None:
            h2d = rmsnorm(h2d, *prenorm)
        return moe_ffn(h2d, layer, cfg, li=wl)
    if layer.w_gate is None and layer.w_gate_up is None:
        u = qmatmul(h2d, layer.w_up, wl, prenorm=prenorm)
        if layer.b_up is not None:
            u = u + layer.b_up
        f = qmatmul(gelu_erf(u), layer.w_down, wl)
        return f if layer.b_down is None else f + layer.b_down
    if layer.w_gate_up is not None:
        if (h2d.shape[0] == 1 and wl is not None and layer.w_gate_up.il and not cfg.ffn_gelu
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
    act = gelu_tanh(g) if cfg.ffn_gelu else silu(g)
    f = qmatmul(act * u, layer.w_down, wl)
    return f if layer.b_down is None else f + layer.b_down


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


def layer_window(cfg: LlamaConfig, li: int) -> Optional[int]:
    """The sliding window of layer li (gemma2 and gemma3: li % swa_pattern <
    swa_pattern - 1), or None for a layer that sees every key."""
    if cfg.swa_window > 0 and cfg.swa_pattern > 1 \
            and li % cfg.swa_pattern < cfg.swa_pattern - 1:
        return cfg.swa_window
    return None


def _finish_layer(x, h, o2d, layer: LlamaLayer, cfg: LlamaConfig, wl=None, pick=None):
    """Close a layer given the attention norm's output h and the o product
    o2d [M, d] (the reference's _finish_layer and _unrolled_ffn): + bo,
    gemma's post norm; then the parallel residual x + (o + f), f from the
    FFN norm of x or, with no ffn_norm, from h itself; or the sequential
    one, the RMSNorm of an rms layer folded into the FFN's products (unless
    PRENORM is off), any other norm applied first. wl / pick index stacked
    weights."""
    b, t, d = x.shape
    pick = pick or (lambda a: a)
    if layer.bo is not None:
        o2d = o2d + layer.bo
    if cfg.post_norms:
        o2d = rmsnorm(o2d, pick(layer.attn_post_norm), cfg.rms_eps)
    if cfg.parallel_residual:
        hm = h if layer.ffn_norm is None else norm_fn(x, layer.ffn_norm, cfg, layer.ffn_norm_b)
        f = _ffn(hm.reshape(b * t, d), layer, cfg, wl)
        return x + (o2d + f).reshape(b, t, d)
    x = x + o2d.reshape(b, t, d)
    if cfg.norm_type == "rms" and layer.ffn_norm_b is None:
        h2d, pn = _prenormed(x.reshape(b * t, d), pick(layer.ffn_norm), cfg.rms_eps)
    else:
        h2d, pn = norm_fn(x, layer.ffn_norm, cfg, layer.ffn_norm_b).reshape(b * t, d), None
    f = _ffn(h2d, layer, cfg, wl, pn)
    if cfg.post_norms:
        f = rmsnorm(f, pick(layer.ffn_post_norm), cfg.rms_eps)
    return x + f.reshape(b, t, d)


def _layer_fwd(x, layer: LlamaLayer, cfg: LlamaConfig, rope, pos, t_pos,
               scale, cache: KVCache, attn_len, fresh: bool, li: int,
               stacked: bool):
    """One llama layer, updating layer li of the cache in place. stacked:
    `layer` holds all layers' weights and li indexes them (the reference's
    scanned _layer_fwd); else `layer` is layer li's own (its unrolled loop).

    Both fold the RMSNorms into the products' activation prep (unless
    PRENORM is off; never a LayerNorm, nor the attention norm of a parallel
    residual, whose output the FFN may read) and write the new K/V rows
    first, except where the
    fused decode kernel writes them (T = 1 on a bf16, f16 or f32 cache,
    unless ops.attention.FLASH_DECODE is off). An int8 cache decodes through the flash_decode
    kernel, except on stacked layers of a windowed model: there the
    reference's scan sends every layer to the f32 einsum (its traced window
    is never None). Every attention call takes the layer's window and the
    softcap. rope is (cos, sin) of the global layers and that of the
    windowed ones (swa_rope, or None: the same table)."""
    b, t, d = x.shape
    s = cache.max_len
    wl = li if stacked else None
    pick = (lambda a: a[li]) if stacked else (lambda a: a)
    win, cap = layer_window(cfg, li), cfg.attn_softcap
    (cos, sin), swa_rope = rope
    if win is not None and swa_rope is not None:
        cos, sin = swa_rope
    if cfg.norm_type == "rms" and not cfg.parallel_residual:
        h = None
        h2d, pn = _prenormed(x.reshape(b * t, d), pick(layer.attn_norm), cfg.rms_eps)
    else:
        h, pn = norm_fn(x, pick(layer.attn_norm), cfg, layer.attn_norm_b), None
        h2d = h.reshape(b * t, d)
    q, k, v = _qkv(h2d, layer, cfg, wl, pn)
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:                     # gemma3, qwen3: each head's RMSNorm before rope
        q = rmsnorm(q, pick(layer.q_norm), cfg.rms_eps)
        k = rmsnorm(k, pick(layer.k_norm), cfg.rms_eps)
    q, k = _rope_qk(q, k, cos, sin, cfg)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    alen = attn_len if (attn_len is not None and attn_len < s) else s
    if t == 1 and not fresh and not cache.quantized and _attention.FLASH_DECODE:
        # the fused kernel reads layer li of the flat cache in place and
        # writes the new row at pos itself
        attn = flash_decode_write_stacked(
            q[:, 0], cache.k, cache.v, k[:, 0], v[:, 0], li, pos, scale,
            hkv=cfg.n_kv_heads, s_limit=alen if alen < s else None,
            win_l=win, softcap=cap)[:, None]
    else:
        update_layer(cache, li, pos, t_pos, k, v)
        if fresh:
            # softcap, or a window narrower than the prompt: the einsum
            # (flash_prefill routes there when given either)
            wide = cap or (win is not None and t > win)
            attn = (flash_prefill(q, k, v, scale, window=win, softcap=cap) if wide
                    else flash_prefill(q, k, v, scale))
        elif t == 1 and not (stacked and cfg.swa_window > 0 and cfg.swa_pattern > 1):
            # int8 codes and scales of layer li, read in place (or a float
            # cache's layer under FLASH_DECODE=0: the einsum route)
            sl = lambda a: None if a is None else a[li, :, :alen]
            kc, vc = sl(cache.k), sl(cache.v)
            if not cache.quantized:
                kc = kc.reshape(b, alen, cfg.n_kv_heads, cfg.head_dim)
                vc = vc.reshape(b, alen, cfg.n_kv_heads, cfg.head_dim)
            attn = flash_decode(q[:, 0], kc, vc, pos, scale, window=win or 0, softcap=cap,
                                k_scale=sl(cache.k_scale),
                                v_scale=sl(cache.v_scale))[:, None]
        else:
            kci, vci = read_layer(cache, li, cfg.n_kv_heads)
            attn = attention(q, kci[:, :alen], vci[:, :alen], pos, t_pos, scale,
                             window=win, softcap=cap)
    o = qmatmul(attn.reshape(b * t, cfg.n_heads * cfg.head_dim), layer.wo, wl)
    return _finish_layer(x, h, o, layer, cfg, wl, pick)


@torch.no_grad()
def forward(params: LlamaParams, cfg: LlamaConfig, tokens: torch.Tensor,
            pos: torch.Tensor, cache: KVCache, fresh_prefill: bool = False,
            attn_len: Optional[int] = None,
            last_idx: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """One forward pass over new tokens, on stacked layers (a LlamaLayer
    with a leading L axis) or unrolled ones (a list, one LlamaLayer each).

    tokens int [B, T]; pos int32 [B] index of tokens[:, 0]; cache (bf16 or
    int8) is updated in place. attn_len (decode) bounds the streamed cache
    positions; last_idx [B] keeps only that position's logits (prefill).
    Returns (logits f32 [B, T or 1, n_vocab], cache); with return_hidden,
    (the final-normed hidden states f32 [B, T, d], cache) and no head."""
    b, t = tokens.shape
    dev = tokens.device
    t_pos = torch.arange(t, device=dev)
    cos, sin = rope_cos_sin(pos.long()[:, None] + t_pos[None, :], cfg.rope_dim or cfg.head_dim,
                            cfg.rope_theta, cfg.rope_scale, cfg)  # [B, T, rd/2]
    rope = ((cos[:, :, None, :], sin[:, :, None, :]), None)
    if cfg.swa_rope_theta and cfg.swa_rope_theta != cfg.rope_theta:
        # gemma3: the windowed layers' table, base swa_rope_theta, scale 1
        cs, ss = rope_cos_sin(pos.long()[:, None] + t_pos[None, :], cfg.head_dim,
                              cfg.swa_rope_theta, 1.0, None)
        rope = (rope[0], (cs[:, :, None, :], ss[:, :, None, :]))
    scale = cfg.attn_scale or 1.0 / math.sqrt(cfg.head_dim)
    x = params.tok_embd[tokens.long()].float()
    if cfg.embd_scale != 1.0:
        x = x * cfg.embd_scale
    stacked = isinstance(params.layers, LlamaLayer)
    for li in range(cfg.n_layers):
        layer = params.layers if stacked else params.layers[li]
        x = _layer_fwd(x, layer, cfg, rope, pos, t_pos, scale, cache,
                       attn_len, fresh_prefill, li, stacked)
        if tracing.TRAP:
            tracing.check_finite(x, "forward", li, pos)
    if return_hidden:
        return norm_fn(x, params.out_norm, cfg, params.out_norm_b), cache
    t_out = t
    if last_idx is not None:
        # only the next-token logits: slice before the lm head
        x = x[torch.arange(b, device=dev), last_idx.long()][:, None]
        t_out = 1
    if cfg.norm_type == "rms" and params.out_norm_b is None:
        h2d, pn = _prenormed(x.reshape(b * t_out, cfg.d_model), params.out_norm, cfg.rms_eps)
    else:
        h2d = norm_fn(x, params.out_norm, cfg, params.out_norm_b).reshape(b * t_out, cfg.d_model)
        pn = None
    logits = qmatmul(h2d, params.output, prenorm=pn)
    if params.out_b is not None:        # phi2's head bias
        logits = logits + params.out_b
    logits = _finish_logits(logits, cfg).reshape(b, t_out, -1)
    if tracing.TRAP:
        tracing.check_finite(logits, "forward", "logits",
                             pos if last_idx is None else pos + last_idx.to(pos.device))
    return logits, cache


@torch.no_grad()
def forward_paged_decode(params: LlamaParams, cfg: LlamaConfig,
                         tok: torch.Tensor, pos: torch.Tensor, paged,
                         tables: torch.Tensor):
    """One decode step (T = 1 a row) over a paged KV cache, stacked or
    unrolled layers.

    Counterpart of the llama/mistral and gemma branches of the JAX
    package's forward_paged_decode (gemma: the embedding times sqrt(d), the
    GELU FFN; qwen2's q/k/v biases; qwen3's per-head q/k norms before rope;
    the LayerNorm families' norms, biases, partial rope, parallel residual,
    head bias and logit scale; a window, softcaps or post norms raise). tok/pos
    int32 [R]; paged a runtime.paged.PagedKV, updated IN PLACE (each row's
    new K/V at page tables[r, pos // ps], offset pos % ps); tables int32
    [R, MAXP]. Each row attends to its
    pos + 1 positions through the paged_attention kernel, which reads layer
    li of the pool by pointer (`pool[li]` is a view). As in the reference,
    the attention norm runs before the products; the FFN norm does too on
    stacked layers, and unrolled ones close through _finish_layer (an
    RMSNorm there folds into the FFN's products).
    Returns (logits f32 [R, V], paged)."""
    from ..runtime.paged import paged_attend, write_token_kv
    for name in ("swa_window", "attn_softcap", "final_softcap", "post_norms",
                 "alibi", "kv_lora_rank"):
        if getattr(cfg, name, 0):
            raise NotImplementedError(f"paged decode with {name} is not ported")
    stacked = isinstance(params.layers, LlamaLayer)
    r = tok.shape[0]
    ps = paged.page_size
    dev = tok.device
    p64 = pos.long()
    x = params.tok_embd[tok.long()].float()                       # [R, d]
    if cfg.embd_scale != 1.0:
        x = x * cfg.embd_scale
    cos, sin = rope_cos_sin(p64[:, None], cfg.rope_dim or cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scale, cfg)                  # [R, 1, rd/2]
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
        h = norm_fn(x, pick(layer.attn_norm), cfg, layer.attn_norm_b)
        q, k, v = _qkv(h, layer, cfg, wl)
        q = q.reshape(r, cfg.n_heads, cfg.head_dim)
        k = k.reshape(r, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, pick(layer.q_norm), cfg.rms_eps)
            k = rmsnorm(k, pick(layer.k_norm), cfg.rms_eps)
        q, k = _rope_qk(q, k, cos, sin, cfg)
        v = v.reshape(r, cfg.n_kv_heads, cfg.head_dim)
        ksl = paged.k_scale[li] if quant else None
        vsl = paged.v_scale[li] if quant else None
        write_token_kv(paged.k_pages[li], paged.v_pages[li], k, v, pages, offs,
                       ksl, vsl)
        attn = paged_attend((q * scale).float(), paged.k_pages[li],
                            paged.v_pages[li], lengths, tables,
                            k_scale_l=ksl, v_scale_l=vsl)
        o = qmatmul(attn.reshape(r, cfg.n_heads * cfg.head_dim), layer.wo, wl)
        if stacked:
            x = x + o
            x = x + _ffn(rmsnorm(x, pick(layer.ffn_norm), cfg.rms_eps), layer, cfg, wl)
        else:
            x = _finish_layer(x[:, None], h[:, None], o, layer, cfg)[:, 0]
        if tracing.TRAP:
            tracing.check_finite(x, "forward_paged_decode", li, pos)
    logits = qmatmul(norm_fn(x, params.out_norm, cfg, params.out_norm_b), params.output)
    if params.out_b is not None:        # phi2's head bias
        logits = logits + params.out_b
    logits = _finish_logits(logits, cfg)
    if tracing.TRAP:
        tracing.check_finite(logits, "forward_paged_decode", "logits", pos)
    return logits, paged


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    return init_kv(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                   dtype, device=device)
