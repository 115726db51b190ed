"""Synthetic llama models with random quantized weights, built on the device.

Counterpart of llamafile_tpu/models/synthetic.py: the named shapes follow the
public model cards, the weights are random from a seeded torch.Generator on
the target device (no multi-GB host-to-device copy), and the layout is the
production one (ops/repack.py), so kernels see a real checkpoint's data
layout and byte counts.

`write_synthetic_gguf` writes a preset as a GGUF file instead, through the
port's own writer (gguf/writer.py), from random raw blocks of any format the
port loads: random codes, small finite f16 scales. A machine without the
JAX package can then make a real file and time `load_engine` on it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.repack import QTensor, stack_experts
from .llama import LlamaConfig, LlamaLayer, LlamaParams

GEMMA2_9B = dict(d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336,
                 n_vocab=256000, rms_eps=1e-6, max_context=8192, rope_neox=True,
                 embd_scale=3584 ** 0.5, ffn_gelu=True, attn_softcap=50.0,
                 final_softcap=30.0, swa_window=4096, swa_pattern=2, post_norms=True,
                 head_quant="Q6_K", centered=True)
# Gemma-7B (its model card and config.json: d 3072, 16 query heads over 16
# KV heads of head_dim 256, so H * D = 4096 is not d, d_ff 24576, vocab
# 256000, rms eps 1e-6, context 8192) with the gemma branches the loader
# sets: rope NEOX, the embedding times sqrt(d), GELU-tanh, no window,
# softcap or post norms
GEMMA_7B = dict(d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576,
                n_vocab=256000, rms_eps=1e-6, max_context=8192, rope_neox=True,
                embd_scale=3072 ** 0.5, ffn_gelu=True, head_quant="Q6_K", centered=True)
# Gemma-3-27B (the text_config of its config.json: d 5376, 32 query heads
# over 16 KV heads of head_dim 128, d_ff 21504, vocab 262144, rms eps 1e-6,
# query_pre_attn_scalar 168 = d / h, sliding_window 1024 with
# sliding_window_pattern 6, rope_theta 1e6 with a linear factor of 8 on the
# global layers and rope_local_base_freq 10000 on the windowed ones, 128K
# context) with the gemma3 branches: post norms, per-head q/k norms
GEMMA3_27B = dict(d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128, d_ff=21504,
                  n_vocab=262144, rms_eps=1e-6, max_context=131072, rope_neox=True,
                  rope_theta=1e6, rope_scale=1 / 8, embd_scale=5376 ** 0.5, ffn_gelu=True,
                  attn_scale=1 / 168 ** 0.5, swa_window=1024, swa_pattern=6,
                  swa_rope_theta=10000.0, post_norms=True, qk_norm=True,
                  head_quant="Q6_K", centered=True)

# Qwen2.5-7B (Qwen/Qwen2.5-7B-Instruct's config.json: 28 layers, d 3584, 28
# query heads over 4 KV heads of head_dim 128, a head group of 7, d_ff 18944,
# vocab 152064, rope_theta 1e6, rms eps 1e-6, 32K context) with the qwen2
# branch: rope NEOX and q/k/v biases. d_ff 18944 is not a multiple of 1024,
# so gate|up is concatenated and the FFN is never the fused kernel's
QWEN2_5_7B = dict(d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944,
                  n_vocab=152064, rms_eps=1e-6, max_context=32768, rope_neox=True,
                  rope_theta=1e6, attn_qkv_bias=True, head_quant="Q6_K", centered=True)
# Qwen3-32B (Qwen/Qwen3-32B's config.json: 64 layers, d 5120, 64 query heads
# over 8 KV heads of head_dim 128, so H * D = 8192 is not d, d_ff 25600,
# vocab 151936, not a multiple of 256, rope_theta 1e6, rms eps 1e-6, 40K
# context) with the qwen3 branch: rope NEOX and per-head q/k norms
QWEN3_32B = dict(d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600,
                 n_vocab=151936, rms_eps=1e-6, max_context=40960, rope_neox=True,
                 rope_theta=1e6, qk_norm=True, head_quant="Q6_K", centered=True)

# The LayerNorm families (the reference's norm_type "ln" branches). Each
# names, besides its LlamaConfig fields, its layout: `ln_layout` gateless
# (up and down, no gate), fused_qkv (one attn_qkv tensor, as gptneox and
# falcon ship it), shared_norm (no ffn_norm: the FFN reads the attention
# norm's output) and the biases drawn: "norm" (every LayerNorm's, the
# output norm's too), "qkv", "o", "ffn" (up and down), "head". Norm weights
# are ones, biases random (the norms' std 0.1, the products' std 1). The
# weights are drawn at a trained checkpoint's spread (trained: an RMS near
# 0.03, mean near zero; with the other presets' draw a layer's outputs
# reach the tens of thousands and its attention is near one-hot, so that
# a bf16 step of one score moves a layer's output by percents), with a
# separate random Q6_K head (falcon-7b: a Q8_0 one, as d 4544 holds no
# 256-block).
#
# StarCoder2-7B (bigcode/starcoder2-7b's config.json: 32 layers, d 4608, 36
# query heads over 4 KV heads of head_dim 128, a head group of 9, d_ff
# 18432, vocab 49152, rope_theta 1e6, norm eps 1e-5, 16K context): biases
# on every norm and projection, the gateless FFN, the sequential residual;
# its sliding window of 4096 is not written by the reference's converter
STARCODER2_7B = dict(d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128, d_ff=18432,
                     n_vocab=49152, rms_eps=1e-5, max_context=16384, rope_theta=1e6,
                     rope_neox=True, attn_qkv_bias=True, norm_type="ln", ffn_gelu=True,
                     head_quant="Q6_K", trained=True,
                     ln_layout=dict(gateless=True, biases=("norm", "qkv", "o", "ffn")))
# Command-R v01 (CohereForAI/c4ai-command-r-v01's config.json: 40 layers, d
# 8192, 64 query heads over 64 KV heads of head_dim 128, d_ff 22528 SwiGLU,
# vocab 256000, rope_theta 8e6, layer norm eps 1e-5, logit_scale 0.0625,
# context 8192): LayerNorm without bias, one shared norm under the
# parallel residual, interleaved rope pairs, logits times 0.0625
# (logit_scale 16 divides them)
COMMAND_R_V01 = dict(d_model=8192, n_heads=64, n_kv_heads=64, head_dim=128, d_ff=22528,
                     n_vocab=256000, rms_eps=1e-5, max_context=8192, rope_theta=8e6,
                     norm_type="ln", parallel_residual=True,
                     logit_scale=1 / 0.0625, head_quant="Q6_K", trained=True,
                     ln_layout=dict(shared_norm=True, biases=()))
# Pythia-6.9B (EleutherAI/pythia-6.9b's config.json: d 4096, 32 heads of
# 128, d_ff 16384, vocab 50432, rotary_pct 0.25: rope on 32 dims, parallel
# residual with its own FFN norm, eps 1e-5, context 2048): the fused qkv
# with its bias, biases everywhere but the head
PYTHIA_6_9B = dict(d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128, d_ff=16384,
                   n_vocab=50432, rms_eps=1e-5, max_context=2048, rope_neox=True,
                   attn_qkv_bias=True, norm_type="ln", parallel_residual=True, rope_dim=32,
                   head_quant="Q6_K", trained=True,
                   ln_layout=dict(gateless=True, fused_qkv=True,
                                  biases=("norm", "qkv", "o", "ffn")))
# Phi-2 (microsoft/phi-2's config.json: d 2560, 32 heads of 80,
# partial_rotary_factor 0.4: rope on 32 dims, d_ff 10240, vocab 51200, eps
# 1e-5, context 2048): one shared norm under the parallel residual, biases
# everywhere, the head's too. Head_dim 80 decodes on the einsum and gather
PHI_2 = dict(d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
             n_vocab=51200, rms_eps=1e-5, max_context=2048, rope_neox=True,
             norm_type="ln", parallel_residual=True, rope_dim=32, head_quant="Q6_K",
             trained=True, ln_layout=dict(gateless=True, shared_norm=True,
                                           biases=("norm", "qkv", "o", "ffn", "head")))
# Falcon-7B (tiiuae/falcon-7b's config.json: d 4544, 71 query heads over 1
# KV head (multi_query) of head_dim 64, d_ff 4 x 4544 = 18176, vocab 65024,
# eps 1e-5, context 2048, no projection biases): the fused qkv, one shared
# norm (with its bias) under the parallel residual. K = 4544 is no whole
# number of 256-blocks: no K-quant holds it, so it runs Q8_0, head too
FALCON_7B = dict(d_model=4544, n_heads=71, n_kv_heads=1, head_dim=64, d_ff=18176,
                 n_vocab=65024, rms_eps=1e-5, max_context=2048, rope_neox=True,
                 norm_type="ln", parallel_residual=True, head_quant="Q8_0", trained=True,
                 ln_layout=dict(gateless=True, fused_qkv=True, shared_norm=True,
                                biases=("norm",)))

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
    # Gemma-2B's published widths (its model card: d 2048, 8 query heads
    # over 1 KV head of head_dim 256, d_ff 16384, vocab 256000) in the llama
    # layout (none of gemma's norms, scalings or softcaps) at two layers:
    # card-vs-CPU checks of decode at head_dim 256
    "gemma-2b-widths-2l": dict(n_layers=2, d_model=2048, n_heads=8, n_kv_heads=1,
                               d_ff=16384, n_vocab=256000, max_context=8192),
    # Gemma-2-9B's published widths (its model card and config.json: 42
    # layers, d 3584, 16 query heads over 8 KV heads of head_dim 256, d_ff
    # 14336, vocab 256000, rms eps 1e-6, context 8192, GELU-tanh, a 4096
    # window on every other layer, softcaps 50 / 30, sandwich norms) with
    # the gemma2 features the loader sets; the head, tied to the embedding
    # in the model, is a separate random matrix in Q6_K, the format
    # llama.cpp's Q4_K_M gives a tied embedding
    "gemma-2-9b": dict(n_layers=42, **GEMMA2_9B),
    # the same widths at two layers, distinct weights: card-vs-plain checks.
    # centered: Q4_K weights of mean zero, as a trained checkpoint's are. The
    # other presets' (code 0..15 times a scale, plus a bias in [-0.1, 0])
    # have a mean of about 0.029, whose common mode drives most gate outputs
    # far into GELU-tanh's negative tail, where 1 + tanh(z) cancels: there a
    # 0.2% parting of the gate became 17% of the FFN output, kernels and
    # plain versions agreeing on every op's own inputs
    "gemma-2-9b-2l": dict(n_layers=2, **GEMMA2_9B),
    # Gemma-7B at full depth (28 layers) and at two; as every gemma preset,
    # centred Q4_K weights and a separate random Q6_K head
    "gemma-7b": dict(n_layers=28, **GEMMA_7B),
    "gemma-7b-2l": dict(n_layers=2, **GEMMA_7B),
    # Gemma-3-27B at full depth (62 layers) and at six, so that layer 5 is a
    # global one beside five windowed layers
    "gemma-3-27b": dict(n_layers=62, **GEMMA3_27B),
    "gemma-3-27b-6l": dict(n_layers=6, **GEMMA3_27B),
    # Qwen2.5-7B and Qwen3-32B at full depth and at two layers; as the gemma
    # presets, centred Q4_K weights and a separate random Q6_K head (both
    # models' own heads are untied)
    "qwen2.5-7b": dict(n_layers=28, **QWEN2_5_7B),
    "qwen2.5-7b-2l": dict(n_layers=2, **QWEN2_5_7B),
    "qwen3-32b": dict(n_layers=64, **QWEN3_32B),
    "qwen3-32b-2l": dict(n_layers=2, **QWEN3_32B),
    # StarCoder2-7B and Command-R v01 at full depth and at two layers; two
    # layers of Pythia-6.9B, Phi-2 and Falcon-7B (card-vs-plain checks)
    "starcoder2-7b": dict(n_layers=32, **STARCODER2_7B),
    "starcoder2-7b-2l": dict(n_layers=2, **STARCODER2_7B),
    "command-r-v01": dict(n_layers=40, **COMMAND_R_V01),
    "command-r-v01-2l": dict(n_layers=2, **COMMAND_R_V01),
    "pythia-6.9b-2l": dict(n_layers=2, **PYTHIA_6_9B),
    "phi-2-2l": dict(n_layers=2, **PHI_2),
    "falcon-7b-2l": dict(n_layers=2, **FALCON_7B),
    "tiny-moe": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                     n_vocab=1024, max_context=2048, n_experts=4,
                     n_experts_used=2, moe_norm_topk=True),
}


def _rand_qtensor(gen: Optional[torch.Generator], n: int, k: int, quant: str,
                  device, centered: bool = False, trained: bool = False) -> QTensor:
    """Random QTensor in the production layout (storage N padded to 2048);
    on the meta device (gen None) the layout without data. centered: a Q4_K
    group's bias is -(6.5 .. 8.5) times its scale, so that its weights have
    a mean near zero. trained: weights of a trained checkpoint's spread, an
    RMS near 0.03 (write_synthetic_gguf's blocks spread alike), mean near
    zero: Q8_0 and Q6_K scales of 1e-4 .. 1e-3; Q4_K groups of
    q * a + b with a in 2e-3 .. 1.1e-2 and b = -(6.5 .. 8.5) a, the hi
    plane's groups stored as its codes 16q - 128 need (a / 16, b + 8a).
    Without it the draw's scales give an RMS near 0.9 (q8b) and 0.6 (q4b:
    the hi plane's codes are 16 times the lo plane's): products of
    outputs near 1e4 and attention near one-hot. The llama-family presets
    keep that draw: at a trained spread their int8 activation codes turn
    the f32-order partings of kernel and plain version into steps that two
    SwiGLU layers grow past the checks' 2e-2 (PERF.md §6)."""
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
            *((1e-4, 1e-3) if trained else (1e-3, 2e-2)), generator=gen)
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
        *((2e-3, 1.1e-2) if trained else (1e-3, 2e-2)), generator=gen)
    if centered or trained:
        bias = -scales * torch.empty((k // 32, ns), device=device).uniform_(
            6.5, 8.5, generator=gen)
    else:
        bias = torch.empty((k // 32, ns), device=device).uniform_(
            -0.1, 0.0, generator=gen)
    if trained:                     # groups 4-7 of each 256 rows: the hi plane
        hi_plane = (torch.arange(k // 32, device=device) % 8 >= 4)[:, None]
        bias = torch.where(hi_plane, bias + 8 * scales, bias)
        scales = torch.where(hi_plane, scales / 16, scales)
    return QTensor("q4b", (n, k), 32, qs, scales.to(torch.bfloat16),
                   bias.to(torch.bfloat16))


def make_synthetic_llama(preset: str = "tiny", quant: str = "Q4_K",
                         seed: int = 0, fuse: bool = False, device="cuda",
                         n_layers: Optional[int] = None):
    """Returns (cfg, params) with random weights on `device`. A MoE preset
    gives each layer a dense router and expert stacks (stack_experts; gate|up
    joined when fuse), as the loader does. device "meta" gives the shapes,
    dtypes and byte counts of the layout with no data (param_bytes and
    decode_read_bytes of a preset, without building it). n_layers cuts (or
    deepens) the preset's depth, its widths unchanged."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    kw = dict(PRESETS[preset])
    if n_layers is not None:
        kw["n_layers"] = n_layers
    rope_theta = kw.pop("rope_theta", 10000.0)
    share_layers = kw.pop("share_layers", False)
    head_quant = kw.pop("head_quant", quant)
    centered = kw.pop("centered", False)
    trained = kw.pop("trained", False)
    ln = kw.pop("ln_layout", None) or {}
    biases = ln.get("biases", ())
    kw.setdefault("head_dim", kw["d_model"] // kw["n_heads"])
    cfg = LlamaConfig(rope_theta=rope_theta, **kw)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rq = lambda n, k: _rand_qtensor(gen, n, k, quant, dev, centered, trained)
    rvec = lambda n, std: torch.randn(n, generator=gen, device=dev) * std
    layers = []
    for _ in range(1 if share_layers else cfg.n_layers):
        attn = (dict(wqkv=rq((h + 2 * kvh) * hd, d)) if ln.get("fused_qkv") else
                dict(wq=rq(h * hd, d), wk=rq(kvh * hd, d), wv=rq(kvh * hd, d)))
        attn["wo"] = rq(d, h * hd)
        if cfg.n_experts:
            ex = {}
            for e in range(cfg.n_experts):
                ex[f"gate.{e}"], ex[f"up.{e}"] = rq(cfg.d_ff, d), rq(cfg.d_ff, d)
                ex[f"down.{e}"] = rq(d, cfg.d_ff)
            ffn = dict(experts=stack_experts(ex, cfg.n_experts, fuse_gate_up=fuse),
                       gate_inp=_rand_qtensor(gen, cfg.n_experts, d, "F16", dev))
        elif ln.get("gateless"):            # the LayerNorm families' up and down
            ffn = dict(w_up=rq(cfg.d_ff, d), w_down=rq(d, cfg.d_ff))
        else:
            ffn = dict(w_gate=rq(cfg.d_ff, d), w_up=rq(cfg.d_ff, d),
                       w_down=rq(d, cfg.d_ff))
        if cfg.post_norms:                  # gemma2/3's sandwich norms, random
            attn.update({f: torch.empty(d, device=dev).uniform_(0.5, 1.5, generator=gen)
                         for f in ("attn_post_norm", "ffn_post_norm")})
        if cfg.qk_norm:                     # gemma3/qwen3's per-head q/k norms, drawn alike
            attn.update({f: torch.empty(hd, device=dev).uniform_(0.5, 1.5, generator=gen)
                         for f in ("q_norm", "k_norm")})
        if cfg.attn_qkv_bias or "qkv" in biases:   # q/k/v biases, at the products' scale
            attn.update({f: rvec(n, 1.0)
                         for f, n in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd))})
        if "o" in biases:
            attn["bo"] = rvec(d, 1.0)
        if "ffn" in biases:
            ffn.update(b_up=rvec(cfg.d_ff, 1.0), b_down=rvec(d, 1.0))
        shared = ln.get("shared_norm", False)
        if "norm" in biases:
            attn.update(attn_norm_b=rvec(d, 0.1), ffn_norm_b=None if shared else rvec(d, 0.1))
        layers.append(LlamaLayer(attn_norm=torch.ones(d, device=dev),
                                 ffn_norm=None if shared else torch.ones(d, device=dev),
                                 **attn, **ffn))
    if share_layers:
        layers = layers * cfg.n_layers       # the same buffers in every layer
    embd = (torch.randn((cfg.n_vocab, d), generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)
    # gemma2 presets: the final norm at 1/8, so that the random head's
    # logits (std about 6.5) stay under the final softcap of 30 as a trained
    # model's do; at 1 most of them saturate it and the greedy token is a tie
    out_norm = torch.full((d,), 0.125 if cfg.final_softcap else 1.0, device=dev)
    params = LlamaParams(tok_embd=embd, layers=layers, out_norm=out_norm,
                         output=_rand_qtensor(gen, cfg.n_vocab, d, head_quant, dev,
                                              trained=trained),
                         out_norm_b=rvec(d, 0.1) if "norm" in biases else None,
                         out_b=rvec(cfg.n_vocab, 1.0) if "head" in biases else None)
    if fuse:
        from .loader import fuse_projections
        params = fuse_projections(params, cfg)
    return cfg, params


def _leaves(params: LlamaParams):
    """Every weight tensor, a layer's shared buffers once for each layer."""
    layers = params.layers if isinstance(params.layers, list) else [params.layers]
    out = [t for t in (params.tok_embd, params.out_norm, params.out_norm_b, params.out_b)
           if t is not None]
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
    count). A gateless FFN reads its two matrices (and the biases). The
    decode roofline's numerator."""
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


# The f16 fields of each block format, (byte offset, low, high) of the
# uniform draw: d-like scales small and positive, mins small and negative.
# A K-quant's d multiplies 6-bit (or 4-bit) sub-scales, so it is drawn
# 16-64 times smaller than a 32-element format's. A grid IQ type's d is
# drawn so that its weights spread as the others' do (an RMS near 0.03):
# its sub-scales reach 3.9 (IQ2), 31 (IQ3) or 15 (IQ1) and its grid values
# 43 (IQ2), 62 (IQ3) or 1.125 (IQ1).
RAW_F16_FIELDS = {
    "Q4_0": ((0, 1e-3, 2e-2),), "Q4_1": ((0, 1e-3, 2e-2), (2, -2e-2, 0.0)),
    "Q5_0": ((0, 1e-3, 2e-2),), "Q5_1": ((0, 1e-3, 2e-2), (2, -2e-2, 0.0)),
    "Q8_0": ((0, 1e-4, 1e-3),), "IQ4_NL": ((0, 1e-4, 1e-3),),
    "Q2_K": ((80, 1e-4, 1e-3), (82, 1e-5, 1e-4)), "Q3_K": ((108, 1e-5, 1e-4),),
    "Q4_K": ((0, 1e-5, 1e-4), (2, 1e-5, 1e-4)), "Q5_K": ((0, 1e-5, 1e-4), (2, 1e-5, 1e-4)),
    "Q6_K": ((208, 1e-5, 1e-4),), "IQ4_XS": ((0, 1e-5, 1e-4),),
    "IQ2_XXS": ((0, 2e-4, 1e-3),), "IQ2_XS": ((0, 2e-4, 1e-3),),
    "IQ2_S": ((0, 2e-4, 1e-3),), "IQ3_XXS": ((0, 1e-4, 4e-4),),
    "IQ3_S": ((0, 1e-4, 4e-4),), "IQ1_S": ((0, 2e-3, 8e-3),), "IQ1_M": (),
}
# IQ1_M has no d field: its f16 d is spelled by the top nibbles of the four
# u16 scales at bytes 48:56, nibble i of d in scale i (dequant_iq1_m), so
# random bytes there give any f16, inf and NaN too; (offset, low, high)
RAW_NIBBLE_D = {"IQ1_M": (48, 2e-3, 8e-3)}


def random_blocks(rng: np.random.Generator, quant: str, n_elems: int) -> np.ndarray:
    """Raw blocks of `quant` holding n_elems values: random bytes, then each
    f16 field of RAW_F16_FIELDS (and IQ1_M's nibble-spelled d,
    RAW_NIBBLE_D) drawn small and finite."""
    from ..gguf.quants import TYPE_BY_NAME
    spec = TYPE_BY_NAME[quant]
    nb = n_elems // spec.block_elems
    b = rng.integers(0, 256, (nb, spec.block_bytes), dtype=np.uint8)
    for off, lo, hi in RAW_F16_FIELDS[quant]:
        b[:, off:off + 2] = rng.uniform(lo, hi, nb).astype(np.float16).view(
            np.uint8).reshape(nb, 2)
    if quant in RAW_NIBBLE_D:
        off, lo, hi = RAW_NIBBLE_D[quant]
        d = rng.uniform(lo, hi, nb).astype(np.float16).view(np.uint16)
        sc = np.ascontiguousarray(b[:, off:off + 8]).view(np.uint16)
        for i in range(4):
            sc[:, i] = (sc[:, i] & 0x0FFF) | (((d >> (4 * i)) & 0xF) << 12)
        b[:, off:off + 8] = sc.view(np.uint8)
    return b


def synthetic_vocab(n_vocab: int):
    """(tokens, scores, types) of a llama vocab of n_vocab entries: the
    specials, the 256 byte tokens, then plain filler pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    tokens += [f"\u2581t{i}" for i in range(n_vocab - len(tokens))]
    types += [1] * (n_vocab - len(types))
    return tokens[:n_vocab], [0.0] * n_vocab, types[:n_vocab]


def write_synthetic_gguf(path: str, preset: str = "llama3-8b", quant: str = "Q4_K", *,
                         n_layers: Optional[int] = None, n_vocab: Optional[int] = None,
                         head_quant: Optional[str] = None, embd_quant: Optional[str] = None,
                         seed: int = 0) -> str:
    """Write a llama-architecture GGUF of a dense preset's widths to path
    through the port's GGUFWriter: every layer matrix random raw blocks of
    quant (random_blocks), norms of ones in f32, the embedding in embd_quant
    and the head in head_quant (both quant unless given; F16 where a row is
    not a whole number of blocks), a synthetic_vocab tokenizer. n_layers and
    n_vocab cut (or grow) the preset's depth and vocabulary, its widths
    unchanged. Returns path."""
    from ..gguf.quants import TYPE_BY_NAME
    from ..gguf.writer import GGUFWriter
    kw = dict(PRESETS[preset])
    if kw.get("n_experts") or kw.get("ln_layout"):
        raise ValueError(f"{preset}: write_synthetic_gguf writes dense llama presets")
    layers = n_layers if n_layers is not None else kw["n_layers"]
    vocab = n_vocab if n_vocab is not None else kw["n_vocab"]
    d, h, kvh, dff = kw["d_model"], kw["n_heads"], kw["n_kv_heads"], kw["d_ff"]
    hd = kw.get("head_dim", d // h)
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    w.add("general.architecture", "llama")
    w.add("general.name", f"synthetic-{preset}-{quant}")
    w.add("llama.block_count", layers)
    w.add("llama.embedding_length", d)
    w.add("llama.attention.head_count", h)
    w.add("llama.attention.head_count_kv", kvh)
    w.add("llama.attention.key_length", hd)
    w.add("llama.attention.value_length", hd)
    w.add("llama.feed_forward_length", dff)
    w.add("llama.rope.freq_base", float(kw.get("rope_theta", 10000.0)))
    w.add("llama.attention.layer_norm_rms_epsilon", float(kw.get("rms_eps", 1e-5)))
    w.add("llama.context_length", kw.get("max_context", 2048))
    w.add("llama.vocab_size", vocab)
    tokens, scores, types = synthetic_vocab(vocab)
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", tokens)
    w.add("tokenizer.ggml.scores", scores)
    w.add("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)
    w.add("tokenizer.ggml.unknown_token_id", 0)
    w.add("tokenizer.ggml.add_bos_token", True)

    def add(name, n, k, fmt):
        if k % TYPE_BY_NAME[fmt].block_elems:
            w.add_tensor_f16(name, rng.standard_normal((n, k), np.float32) * 0.02)
        else:
            w.add_tensor(name, (n, k), fmt, random_blocks(rng, fmt, n * k))

    add("token_embd.weight", vocab, d, embd_quant or quant)
    ones = np.ones(d, np.float32)
    for i in range(layers):
        p = f"blk.{i}."
        w.add_tensor_f32(p + "attn_norm.weight", ones)
        for name, n, k in (("attn_q", h * hd, d), ("attn_k", kvh * hd, d),
                           ("attn_v", kvh * hd, d), ("attn_output", d, h * hd)):
            add(f"{p}{name}.weight", n, k, quant)
        w.add_tensor_f32(p + "ffn_norm.weight", ones)
        for name, n, k in (("ffn_gate", dff, d), ("ffn_up", dff, d), ("ffn_down", d, dff)):
            add(f"{p}{name}.weight", n, k, quant)
    w.add_tensor_f32("output_norm.weight", ones)
    add("output.weight", vocab, d, head_quant or quant)
    w.write()
    return path
