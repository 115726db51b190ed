"""Quantized matmuls of the port: dispatch, activation prep, twelve kernels.

Counterpart of llamafile_tpu/ops/qmatmul.py for what the stacked and the
unrolled llama paths and the routed MoE FFN reach. The TPU kernels become
CUDA kernels for Hopper (csrc/):

  qmm_txn_m1   <- _qmm_kernel_txn_m1(_l)  (q4b M = 1 decode: qkv, o, lm head)
  qmm_txn      <- _qmm_kernel_txn(_l)     (q4b 2 <= M <= 32: short prefill)
  qmm_moe_m1   <- _qmm_kernel_moe_m1      (fused q4b M = 1 FFN of every
                                           routed slot; the dense FFN's layer
                                           as its one expert)
  qmm_q8_m1    <- _qmm_kernel_q8_m1(_l)   (q8b M = 1 decode, g 16 or 32)
  qmm_dequant  <- _qmm_kernel             (bf16-dequant GEMM: stacked q4b
                                           M > 32, q8b M >= 2)
  qmm_planes   <- _qmm_kernel_planes      (unstacked q4b M > 32: the prefill
                                           of unrolled layers; bf16 out from
                                           M = 256)
  qmm_txn_m1_r <- _qmm_kernel_txn_m1_r    (routed q4b GEMV per MoE slot)
  qmm_q8_m1_r  <- _qmm_kernel_q8_m1_r     (routed q8b GEMV per MoE slot)
  qmm_txn_g    <- _qmm_kernel_txn_g       (grouped q4b MoE product, row
                                           tiles of 8 or 32)
  qmm_planes_g <- _qmm_kernel_planes_g    (grouped q4b MoE GEMM, row tiles
                                           of 128, bias fused)
  qmm_i8p      <- _qmm_kernel_i8p(_l)     (the int8 prefill, M > 32, on the
                                           int8-g256 companion of an
                                           I8PQTensor; f32 out)
  qmm_int8     <- _qmm_kernel_int8(_l)    (q4b padded M <= 32 under the
                                           int8 flavour; bias outside)

qmm_planes also replaces _qmm_kernel_planes_l: a stacked caller passes
layer li's views, which the kernel reads by pointer.

The q4b kernel flavour (LLAMAFILE_TPU_Q4B, read into Q4B_KERNEL at import
as the reference reads it) picks among these for q4b weights: "txn" (the
default) takes the txn kernels and the fused FFN; "int8" takes qmm_int8 for
padded M <= 32 and qmm_planes above; "planes" takes qmm_planes for every
q4b product; "concat" takes qmm_dequant for every q4b and q8b product.
Outside "txn" the RMSNorm is applied before the product, the bias term is
added outside every kernel, M = 1 pads to 8 rows as M > 1 does, the dense
M = 1 FFN is not fused and routed q4b experts take _routed_fallback.
Dispatch reads the module global at every call (product_route), so a test
may set Q4B_KERNEL; nothing else binds it.

Each kernel has a wrapper and a plain PyTorch version beside it. The wrapper
runs the plain version only for tensors that lie on the CPU (the tests); for
CUDA tensors it launches the kernel or raises. `wrapper.launches` counts
kernel launches (qmm_moe_m1 adds two a call: its gate|up and down kernels).
The MoE kernels take their expert ids, token rows and routing weights as
device tensors and read them themselves, so the router's top-k never goes
to the host.

Weight math of the int8-activation kernels (txn_m1, txn, moe_m1, q8_m1 and
their routed and grouped forms):
    y[m, n] = sum_g (float(sum_{k in g} xq[m,k] * w[k,n]) * scale[g,n]) * sx[m,g]
            + sum_g bf16(float(sum_{k in g} xq[m,k]) * sx[m,g]) * bias[g,n]
with xq, sx from quantize_activations_g32 and w the stored codes (q4b: lo
plane q, hi plane 16q - 128, the fold living in the stored scales and bias;
q8b: int8 codes, one per-32 sx spanning two groups when g = 16).
The dequant GEMM instead computes y = bf16(xn) @ bf16(code * scale) in f32,
with the bias term groupsum_g(xn) @ bias added outside, as the reference;
the grouped planes GEMM fuses that term in its f32 sum. The int8 prefill
computes, per 256-deep K block b in K order,
    acc[m, n] = acc[m, n] + (float(sum_{k in b} xq[m,k] * w8[n,k]) * sxa[m,b]) * sw[b,n]
with xq, sxa from i8p_prep and w8, sw the companion (the bias folded in).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from . import _build
from ._build import I, P
from .repack import GU_STRIPE, I8P_BLOCK, QTensor, q4b_codes

Q4B_KERNEL = os.environ.get("LLAMAFILE_TPU_Q4B", "txn")
Q4B_FLAVOURS = ("txn", "int8", "planes", "concat")
# calls of the routes that are not kernels, counted as `.launches` counts
# the kernels (reset with them by ops.reset_launch_counts)
ROUTE_COUNTS = {"routed_fallback": 0}


def q4b_flavour() -> str:
    """The q4b kernel flavour in force: Q4B_KERNEL, checked."""
    f = Q4B_KERNEL
    if f == "uplanes":
        raise NotImplementedError(
            "LLAMAFILE_TPU_Q4B=uplanes is not ported: the reference's unsigned-hi "
            "planes kernel reads the hi nibble as 16q against scales folded for "
            "16q - 128, so its products are wrong (ROADMAP C.5)")
    if f not in Q4B_FLAVOURS:
        raise ValueError(f"LLAMAFILE_TPU_Q4B={f!r}: expected one of {Q4B_FLAVOURS}")
    return f

# ---------------------------------------------------------------------------
# Activation prep (plain torch: XLA code on the TPU, not a kernel there)
# ---------------------------------------------------------------------------


def quantize_activations_g32(x: torch.Tensor, nrm=None, eps: float = 0.0):
    """x [M, K] float -> (xq int8 [M, K], sx f32 [M, K//32]) per-32 absmax.

    nrm (f32 [K]) folds an RMSNorm of x into the quantization exactly: the
    codes depend only on the per-group absmax of x*nrm, and the positive
    rsqrt(mean(x^2)+eps) rides in the scales."""
    m, k = x.shape
    x32 = x.float()
    if nrm is not None:
        xw = x32 * nrm.float()
        r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    else:
        xw = x32
        r = None
    xg = xw.reshape(m, k // 32, 32)
    amax = xg.abs().amax(dim=2)
    sx = amax / 127.0
    if r is not None:
        sx = sx * r
    inv = torch.where(amax > 0, 127.0 / torch.where(amax > 0, amax, 1.0),
                      torch.zeros_like(amax))
    xq = torch.clamp(torch.round(xg * inv[:, :, None]), -127, 127).to(torch.int8)
    return xq.reshape(m, k), sx


def i8p_prep(x: torch.Tensor):
    """x float [M, K] (normed) -> (xq int8 [M, K], sxa f32 [M, K/256]): the
    int8 prefill's activations (the reference's _i8p_prep, without its
    padding of M to the TPU's row tile). The scale is max(amax, 1e-12)
    times the f32 reciprocal of 127, a multiply (quantize_activations_g32
    divides); the codes are clip(round(x / sxa), -127, 127), round half to
    even, a true divide."""
    m, k = x.shape
    xg = x.float().reshape(m, k // I8P_BLOCK, I8P_BLOCK)
    sxa = torch.clamp(xg.abs().amax(dim=2), min=1e-12) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xg / sxa[:, :, None]), -127, 127).to(torch.int8)
    return xq.reshape(m, k), sxa


def apply_rmsnorm(x: torch.Tensor, nrm, eps: float) -> torch.Tensor:
    """Plain RMSNorm (prenorm for the dense path)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)) * nrm


def split_gu(gu: torch.Tensor, dff: int, interleaved: bool):
    """Split a fused gate|up output [..., 2*dff] into (g, u): plain halves, or
    de-interleave the GU_STRIPE-striped layout."""
    if not interleaved:
        return gu[..., :dff], gu[..., dff:]
    lead = gu.shape[:-1]
    p = gu.reshape(*lead, dff // GU_STRIPE, 2, GU_STRIPE)
    return (p[..., 0, :].reshape(*lead, dff), p[..., 1, :].reshape(*lead, dff))


# ---------------------------------------------------------------------------
# Plain versions (the CPU path of the wrappers; the card's yardstick)
# ---------------------------------------------------------------------------


def q4b_plain(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
              scales: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain q4b product of one layer's weights: f32 [M, Ns].

    The group dots run as an f32 batched product of integer codes: every
    partial sum is an integer below 2**24, so they are exact in any order."""
    m, k = xq.shape
    ns = qs.shape[-1]
    g = k // 32
    xg = xq.float().reshape(m, g, 32).transpose(0, 1)           # [G, M, 32]
    wg = q4b_codes(qs).float().reshape(g, 32, ns)               # [G, 32, Ns]
    parts = torch.bmm(xg, wg)                                   # [G, M, Ns]
    y = ((parts * scales.float()[:, None, :]) * sx.t()[:, :, None]).sum(0)
    if bias is not None:
        xsum = xq.float().reshape(m, g, 32).sum(-1)             # exact
        bsx = (xsum * sx).to(torch.bfloat16).float()
        y = y + bsx @ bias.float()
    return y


qmm_txn_m1_plain = q4b_plain     # the M = 1 kernel computes the same function
qmm_txn_plain = q4b_plain


def qmm_int8_plain(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """Plain int8-flavour q4b product (_qmm_kernel_int8): q4b_plain with no
    bias term (the caller adds it outside); f32 [M, Ns]."""
    return q4b_plain(xq, sx, qs, scales, None)


def qmm_q8_m1_plain(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
                    scales: torch.Tensor, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain q8b product of one layer's int8 codes [K, Ns]: f32 [M, Ns].

    g = K / scales rows (16 or 32); for g = 16 each per-32 activation scale
    covers two weight groups (_qmm_kernel_q8_m1). The group dots are exact
    integers in f32, as in q4b_plain."""
    m, k = xq.shape
    ns = qs.shape[-1]
    ng = scales.shape[-2]
    g = k // ng
    xg = xq.float().reshape(m, ng, g)
    parts = torch.bmm(xg.transpose(0, 1), qs.float().reshape(ng, g, ns))  # [G, M, Ns]
    sxg = sx.repeat_interleave(32 // g, dim=1)                  # [M, G]
    y = ((parts * scales.float()[:, None, :]) * sxg.t()[:, :, None]).sum(0)
    if bias is not None:
        bsx = (xg.sum(-1) * sxg).to(torch.bfloat16).float()
        y = y + bsx @ bias.float()
    return y


def dequant_bf16(qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One layer's weights as the dequant GEMM sees them: bf16 [K, Ns] with
    W[k, n] = bf16(code[k, n] * scale[k // g, n]), the product rounded once
    (_dequant_tile multiplies in bf16). qs uint8 [K/2, Ns] is q4b, int8
    [K, Ns] is q8b."""
    codes = q4b_codes(qs) if qs.dtype == torch.uint8 else qs
    k, ns = codes.shape
    ng = scales.shape[-2]
    w = codes.float().reshape(ng, k // ng, ns) * scales.float()[:, None, :]
    return w.to(torch.bfloat16).reshape(k, ns)


def qmm_dequant_plain(x: torch.Tensor, qs: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Plain bf16-dequant product: f32 [M, Ns] = bf16(x) @ dequant_bf16(W),
    every product of two bf16 values exact in f32 and summed in f32."""
    return x.to(torch.bfloat16).float() @ dequant_bf16(qs, scales).float()


def planes_bf16_out(m: int) -> bool:
    """The planes kernel's output dtype rule: bf16 once the row count,
    padded to a multiple of 8 as the reference pads it, reaches 256."""
    return -(-m // 8) * 8 >= 256


def qmm_planes_plain(x: torch.Tensor, qs: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Plain two-plane product (_qmm_kernel_planes): x_even @ W_lo + x_odd @
    W_hi, with x_even/x_odd the even and odd 128-wide K chunks of each
    256-superblock of bf16(x), W_lo = bf16(lo * s_lo), W_hi = bf16(hi * s_hi)
    from the nibble planes of qs uint8 [K/2, Ns] and the scale rows r % 8 < 4
    (lo) and r % 8 >= 4 (hi) of scales [K/32, Ns]. Two f32 products summed;
    f32 [M, Ns], or bf16 when planes_bf16_out(M)."""
    y = _planes_f32(x, qs, scales)
    return y.to(torch.bfloat16) if planes_bf16_out(x.shape[0]) else y


def _planes_f32(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """qmm_planes_plain before its output rounding: f32 [M, Ns]."""
    m, k = x.shape
    ns = qs.shape[-1]
    x4 = x.to(torch.bfloat16).float().reshape(m, k // 256, 2, 128)
    xe, xo = x4[:, :, 0].reshape(m, k // 2), x4[:, :, 1].reshape(m, k // 2)
    sc3 = scales.float().reshape(k // 256, 8, ns)
    y = None
    for codes, sc in (((qs & 0x0F).view(torch.int8), sc3[:, :4]),
                      (((qs ^ 0x80) & 0xF0).view(torch.int8), sc3[:, 4:])):
        w = (codes.float().reshape(k // 64, 32, ns) * sc.reshape(k // 64, 1, ns))
        part = (xe if y is None else xo) @ w.to(torch.bfloat16).float().reshape(k // 2, ns)
        y = part if y is None else y + part
    return y


def qmm_i8p_plain(xq: torch.Tensor, sxa: torch.Tensor, w8: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """Plain int8 prefill product (_qmm_kernel_i8p): f32 [M, Ns]. Each
    256-block's dot runs as an f32 product of integer codes, exact in any
    order (every partial sum is an integer of at most 256 * 127**2 < 2**24);
    the blocks then accumulate serially in K order in f32, each scaled by
    sxa, then sw, as the reference does."""
    m, k = xq.shape
    acc = torch.zeros((m, w8.shape[0]), dtype=torch.float32, device=xq.device)
    for b in range(k // I8P_BLOCK):
        blk = slice(b * I8P_BLOCK, (b + 1) * I8P_BLOCK)
        p = xq[:, blk].float() @ w8[:, blk].float().t()
        acc = acc + (p * sxa[:, b:b + 1]) * sw[b]
    return acc


def _expert(t: Optional[torch.Tensor], e: torch.Tensor) -> Optional[torch.Tensor]:
    """Expert e (a one-element int index tensor) of a stacked leaf, gathered
    with index_select: no read of the index on the host."""
    return None if t is None else t.index_select(0, e)[0]


def qmm_moe_m1_plain(xq, sx, gu_qs, gu_sc, gu_b, dn_qs, dn_sc, dn_b,
                     ei: torch.Tensor, ti: Optional[torch.Tensor],
                     topw: torch.Tensor) -> torch.Tensor:
    """Plain fused FFN of every slot s: row ti[s] (s when ti is None) through
    expert ei[s] of the stacks [E, ...], silu(g)*u requantized per 32 with
    topw[s] in its scales, then down. f32 [S, Nd]."""
    dff = dn_qs.shape[-2] * 2
    outs = []
    for s in range(ei.shape[0]):
        e = ei[s:s + 1]
        r = torch.full_like(e, s) if ti is None else ti[s:s + 1]
        g, u = split_gu(q4b_plain(xq.index_select(0, r), sx.index_select(0, r),
                                  _expert(gu_qs, e), _expert(gu_sc, e),
                                  _expert(gu_b, e)), dff, True)
        y = (g * torch.sigmoid(g)) * u
        yq, sy = quantize_activations_g32(y)
        outs.append(q4b_plain(yq, sy * topw[s:s + 1].float(), _expert(dn_qs, e),
                              _expert(dn_sc, e), _expert(dn_b, e)))
    return torch.cat(outs, dim=0)


def _routed_plain(prod, xq, sx, qs, scales, bias, ei, ti):
    """out[s] = prod(xq[ti[s]], sx[ti[s]], W[ei[s]]) for every slot: f32 [S, Ns]."""
    outs = []
    for s in range(ei.shape[0]):
        e, r = ei[s:s + 1], ti[s:s + 1]
        outs.append(prod(xq.index_select(0, r), sx.index_select(0, r), _expert(qs, e),
                         _expert(scales, e), _expert(bias, e)))
    return torch.cat(outs, dim=0)


def qmm_txn_m1_r_plain(xq, sx, qs, scales, bias, ei, ti) -> torch.Tensor:
    """Plain routed q4b GEMV (_qmm_kernel_txn_m1_r): out[s] = x[ti[s]] @
    W[ei[s]] over q4b expert stacks [E, K/2, Ns]; f32 [S, Ns]."""
    return _routed_plain(q4b_plain, xq, sx, qs, scales, bias, ei, ti)


def qmm_q8_m1_r_plain(xq, sx, qs, scales, bias, ei, ti) -> torch.Tensor:
    """Plain routed q8b GEMV (_qmm_kernel_q8_m1_r) over int8 expert stacks
    [E, K, Ns], g 16 or 32; f32 [S, Ns]."""
    return _routed_plain(qmm_q8_m1_plain, xq, sx, qs, scales, bias, ei, ti)


def qmm_txn_g_plain(xq, sx, qs, scales, bias, te, tm: int) -> torch.Tensor:
    """Plain grouped q4b product (_qmm_kernel_txn_g): row tile i (tm rows of
    the int8 activations) through expert te[i]; f32 [S_pad, Ns]."""
    outs = []
    for i in range(te.shape[0]):
        e = te[i:i + 1]
        rows = slice(i * tm, (i + 1) * tm)
        outs.append(q4b_plain(xq[rows], sx[rows], _expert(qs, e), _expert(scales, e),
                              _expert(bias, e)))
    return torch.cat(outs, dim=0)


def group_sums_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 of the f32 sums of each 32 of x [M, K]: the activation side of
    the grouped planes kernel's fused bias term."""
    m, k = x.shape
    return x.float().reshape(m, k // 32, 32).sum(-1).to(torch.bfloat16)


def qmm_planes_g_plain(x, qs, scales, bias, te, tm: int = 128) -> torch.Tensor:
    """Plain grouped two-plane product (_qmm_kernel_planes_g): row tile i of
    bf16(x) through expert te[i]'s planes (qmm_planes_plain's math), plus
    group_sums_bf16(x) @ bias[te[i]] in the same f32 sum, rounded once: f32
    [S_pad, Ns], or bf16 when S_pad >= 256."""
    bx = None if bias is None else group_sums_bf16(x).float()
    outs = []
    for i in range(te.shape[0]):
        e = te[i:i + 1]
        rows = slice(i * tm, (i + 1) * tm)
        y = _planes_f32(x[rows], _expert(qs, e), _expert(scales, e))
        if bias is not None:
            y = y + bx[rows] @ _expert(bias, e).float()
        outs.append(y)
    y = torch.cat(outs, dim=0)
    return y.to(torch.bfloat16) if x.shape[0] >= 256 else y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_TARGET_BLOCKS_PER_SM = 3
_counters = {}           # device index -> int32 counters (kernels leave them 0)


def _counter_buf(device: torch.device, n: int) -> torch.Tensor:
    """Split-K tile counters for `device`. The kernels return every counter
    to zero, so one buffer serves every launch on the device's stream."""
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


def n_split(tiles: int, chunks: int, cap: int, sms: int) -> int:
    """K splits so that tiles x splits fills the `sms` SMs
    _TARGET_BLOCKS_PER_SM blocks deep, at most `cap` and at most one a chunk."""
    return max(1, min(-(-_TARGET_BLOCKS_PER_SM * sms // tiles), cap, chunks))


def _n_split(device: torch.device, tiles: int, chunks: int, cap: int) -> int:
    return n_split(tiles, chunks, cap, _sms(device))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def txn_split(ns: int, k: int, sms: int) -> int:
    """K splits of a qmm_txn or qmm_int8 launch (the small-M body,
    csrc/qmm_txn.cuh) over Ns columns and K: n_split of its 128-column
    tiles, at most one a chunk."""
    return n_split(-(-ns // 128), k // 64, k // 64, sms)


# The M = 1 body (csrc/qmm_m1.cuh): warps a block, stages of a warp's ring,
# the bytes a stage holds (a chunk's 32 weight rows of 128 bytes and its two
# scale and two bias rows), the most splits (a column tile's splits are one
# thread-block cluster of the portable size), and the bytes of copies that
# a launch puts in flight at its start for each SM of the card.
M1_WARPS = 4
M1_STAGES = 2
M1_STAGE_BYTES = 32 * 128 + 4 * 128 * 2
M1_MAX_SPLITS = 8
M1_IN_FLIGHT_PER_SM = 24 * 1024


def m1_split(tiles: int, chunks: int, sms: int) -> int:
    """K splits of an M = 1 launch of `tiles` blocks a split (column tiles
    times slots) over `chunks` chunks: the fewest whose blocks put
    sms * M1_IN_FLIGHT_PER_SM bytes in flight at the start, every warp
    filling the M1_STAGES - 1 stages its ring keeps ahead; at most the
    splits that still give every warp that many chunks and at most
    M1_MAX_SPLITS, at least 1."""
    ahead = M1_WARPS * (M1_STAGES - 1)
    most = max(1, min(chunks // ahead, M1_MAX_SPLITS))
    blocks = -(-sms * M1_IN_FLIGHT_PER_SM // (ahead * M1_STAGE_BYTES))
    return max(1, min(-(-blocks // tiles), most))


def _check_tensors(dev: torch.device, named) -> None:
    """Device, dtype, contiguity and 16-byte alignment of kernel inputs;
    named = ((name, tensor or None, dtype), ...)."""
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    for name, t, dt in named:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_q4b(xq, sx, qs, scales, bias, ns_multiple: int):
    m, k = xq.shape
    _check_tensors(xq.device, (
        ("xq", xq, torch.int8), ("sx", sx, torch.float32),
        ("qs", qs, torch.uint8), ("scales", scales, torch.bfloat16),
        ("bias", bias, torch.bfloat16)))
    ns = qs.shape[-1]
    if k % 256 or tuple(qs.shape) != (k // 2, ns) or ns % ns_multiple:
        raise ValueError(f"q4b shapes: xq {tuple(xq.shape)}, qs {tuple(qs.shape)}"
                         f" (K % 256 == 0, Ns % {ns_multiple} == 0)")
    if tuple(sx.shape) != (m, k // 32) or tuple(scales.shape) != (k // 32, ns) \
            or (bias is not None and bias.shape != scales.shape):
        raise ValueError("sx/scales/bias shapes do not match xq and qs")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def qmm_txn_m1(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
               scales: torch.Tensor, bias: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """M = 1 q4b GEMV (kernel qmm_txn_m1): xq int8 [1, K], sx f32 [1, K/32],
    one layer's qs/scales/bias -> f32 [1, Ns]."""
    if xq.device.type == "cpu":
        return qmm_txn_m1_plain(xq, sx, qs, scales, bias)
    _check_q4b(xq, sx, qs, scales, bias, 16)
    if xq.shape[0] != 1:
        raise ValueError(f"qmm_txn_m1 takes one row, got {xq.shape[0]}")
    k, ns = xq.shape[1], qs.shape[-1]
    s = m1_split(-(-ns // 128), k // 64, _sms(xq.device))
    y = torch.empty((1, ns), dtype=torch.float32, device=xq.device)
    f = _build.fn("qmm_txn_m1", "qmm_txn_m1", [P] * 6 + [I, I, I, P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(),
                   scales.data_ptr(), _ptr(bias), y.data_ptr(), k, ns, s,
                   _stream(xq.device)), "qmm_txn_m1")
    qmm_txn_m1.launches += 1
    return y


qmm_txn_m1.launches = 0


def qmm_txn(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
            scales: torch.Tensor, bias: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """q4b product for 1 <= M <= 32 rows (kernel qmm_txn) -> f32 [M, Ns]."""
    if xq.device.type == "cpu":
        return qmm_txn_plain(xq, sx, qs, scales, bias)
    _check_q4b(xq, sx, qs, scales, bias, 16)
    m, k = xq.shape
    if not 1 <= m <= 32:
        raise ValueError(f"qmm_txn takes 1..32 rows, got {m}")
    ns = qs.shape[-1]
    tiles = -(-ns // 128)
    s = txn_split(ns, k, _sms(xq.device))
    y = torch.empty((m, ns), dtype=torch.float32, device=xq.device)
    partial = torch.empty((s, m, ns), dtype=torch.float32, device=xq.device)
    f = _build.fn("qmm_txn", "qmm_txn", [P] * 8 + [I, I, I, I, P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(),
                   scales.data_ptr(), _ptr(bias), y.data_ptr(),
                   partial.data_ptr(),
                   _counter_buf(xq.device, tiles).data_ptr(), m, k, ns, s,
                   _stream(xq.device)), "qmm_txn")
    qmm_txn.launches += 1
    return y


qmm_txn.launches = 0


def _check_ids(dev: torch.device, named) -> None:
    """Slot maps (expert ids, rows, routing weights): device, dtype and
    contiguity (4-byte reads, so any element offset of a view will do)."""
    for name, t, dt in named:
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or not t.is_contiguous() or t.ndim != 1:
            raise ValueError(f"{name} must be a contiguous 1-D {dt} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_q4b_stack(xq, sx, qs, scales, bias, ns_multiple: int):
    """_check_q4b for expert-stacked weights [E, K/2, Ns]."""
    if qs.ndim != 3:
        raise ValueError(f"expected an expert stack [E, K/2, Ns], got {tuple(qs.shape)}")
    _check_q4b(xq, sx, qs[0], scales[0], None if bias is None else bias[0], ns_multiple)
    _check_tensors(xq.device, (("qs", qs, torch.uint8), ("scales", scales, torch.bfloat16),
                               ("bias", bias, torch.bfloat16)))


def qmm_moe_m1(xq, sx, gu_qs, gu_sc, gu_b, dn_qs, dn_sc, dn_b,
               ei: torch.Tensor, ti: Optional[torch.Tensor],
               topw: torch.Tensor) -> torch.Tensor:
    """Fused M = 1 FFN of every slot s (kernel qmm_moe_m1, one launch pair
    for all slots): row ti[s] of xq (s when ti is None) through expert ei[s]
    of the stacks (gate|up GU_STRIPE-interleaved [E, K/2, 2 dff], down
    [E, dff/2, Nd]), silu(g)*u requantized per 32 with topw[s] in its
    scales, then down. ei, ti int32 and topw f32 [S] are device tensors the
    kernel reads itself. -> f32 [S, Nd]."""
    if xq.device.type == "cpu":
        return qmm_moe_m1_plain(xq, sx, gu_qs, gu_sc, gu_b, dn_qs, dn_sc,
                                dn_b, ei, ti, topw)
    _check_q4b_stack(xq, sx, gu_qs, gu_sc, gu_b, 2048)
    dev = xq.device
    _check_ids(dev, (("ei", ei, torch.int32), ("ti", ti, torch.int32),
                     ("topw", topw, torch.float32)))
    k = xq.shape[1]
    slots = ei.shape[0]
    dff = dn_qs.shape[1] * 2
    n_gu, nd = gu_qs.shape[-1], dn_qs.shape[-1]
    if n_gu != 2 * dff or dff % GU_STRIPE or topw.shape[0] != slots \
            or (ti is not None and ti.shape[0] != slots):
        raise ValueError(f"qmm_moe_m1: gate|up width {n_gu} = 2 x d_ff {dff}, d_ff a "
                         f"multiple of {GU_STRIPE}, one ei/ti/topw entry a slot")
    yq = torch.empty((slots, dff), dtype=torch.int8, device=dev)
    sy = torch.empty((slots, dff // 32), dtype=torch.float32, device=dev)
    _check_q4b_stack(yq, sy, dn_qs, dn_sc, dn_b, 16)
    sa = m1_split(n_gu // 128 * slots, k // 64, _sms(dev))
    sb = m1_split(-(-nd // 128) * slots, dff // 64, _sms(dev))
    out = torch.empty((slots, nd), dtype=torch.float32, device=dev)
    f = _build.fn("qmm_moe_m1", "qmm_moe_m1", [P] * 14 + [I] * 6 + [P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), gu_qs.data_ptr(),
                   gu_sc.data_ptr(), _ptr(gu_b), dn_qs.data_ptr(),
                   dn_sc.data_ptr(), _ptr(dn_b), yq.data_ptr(), sy.data_ptr(),
                   out.data_ptr(), ei.data_ptr(), _ptr(ti), topw.data_ptr(),
                   k, dff, nd, sa, sb, slots, _stream(dev)), "qmm_moe_m1")
    qmm_moe_m1.launches += 2
    return out


qmm_moe_m1.launches = 0


def qmm_q8_m1(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
              scales: torch.Tensor, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """M = 1 q8b GEMV (kernel qmm_q8_m1): xq int8 [1, K], sx f32 [1, K/32],
    one layer's int8 codes [K, Ns], bf16 scales (and bias) [K/g, Ns] with
    g 16 or 32 -> f32 [1, Ns]."""
    if xq.device.type == "cpu":
        return qmm_q8_m1_plain(xq, sx, qs, scales, bias)
    _check_tensors(xq.device, (
        ("xq", xq, torch.int8), ("sx", sx, torch.float32),
        ("qs", qs, torch.int8), ("scales", scales, torch.bfloat16),
        ("bias", bias, torch.bfloat16)))
    m, k = xq.shape
    ns = qs.shape[-1]
    g = k // max(scales.shape[0], 1)
    if m != 1 or k % 32 or tuple(qs.shape) != (k, ns) or ns % 4 \
            or g not in (16, 32) or tuple(scales.shape) != (k // g, ns) \
            or tuple(sx.shape) != (1, k // 32) \
            or (bias is not None and bias.shape != scales.shape):
        raise ValueError(f"qmm_q8_m1 shapes: xq {tuple(xq.shape)}, qs "
                         f"{tuple(qs.shape)}, scales {tuple(scales.shape)} "
                         "(one row, K % 32 == 0, g 16 or 32, Ns % 4 == 0)")
    tiles = -(-ns // 128)
    s = _n_split(xq.device, tiles, k // 32, k // 32 // 8)
    y = torch.empty((1, ns), dtype=torch.float32, device=xq.device)
    partial = torch.empty((s, ns), dtype=torch.float32, device=xq.device)
    f = _build.fn("qmm_q8_m1", "qmm_q8_m1", [P] * 8 + [I] * 4 + [P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(),
                   scales.data_ptr(), _ptr(bias), y.data_ptr(),
                   partial.data_ptr(),
                   _counter_buf(xq.device, tiles).data_ptr(), k, ns, g, s,
                   _stream(xq.device)), "qmm_q8_m1")
    qmm_q8_m1.launches += 1
    return y


qmm_q8_m1.launches = 0


def qmm_dequant(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor
                ) -> torch.Tensor:
    """bf16-dequant GEMM (kernel qmm_dequant): x float [M, K] (rounded to
    bf16 here), one layer's q4b (uint8 [K/2, Ns], g 32) or q8b (int8
    [K, Ns], g 16 or 32) codes and bf16 scales [K/g, Ns] -> f32 [M, Ns].
    The bias term stays with the caller (qmatmul)."""
    if x.device.type == "cpu":
        return qmm_dequant_plain(x, qs, scales)
    xb = x.to(torch.bfloat16).contiguous()
    q4 = qs.dtype == torch.uint8
    _check_tensors(x.device, (("x", xb, torch.bfloat16),
                              ("qs", qs, torch.uint8 if q4 else torch.int8),
                              ("scales", scales, torch.bfloat16)))
    m, k = xb.shape
    ns = qs.shape[-1]
    g = k // max(scales.shape[0], 1)
    if m < 1 or k % (256 if q4 else 64) or ns % 16 \
            or tuple(qs.shape) != ((k // 2) if q4 else k, ns) \
            or g not in ((32,) if q4 else (16, 32)) \
            or tuple(scales.shape) != (k // g, ns):
        raise ValueError(f"qmm_dequant shapes: x {tuple(xb.shape)}, qs "
                         f"{tuple(qs.shape)} {qs.dtype}, scales "
                         f"{tuple(scales.shape)} (q4b K % 256, q8b K % 64, "
                         "Ns % 16 == 0, g 32 or q8b 16)")
    y = torch.empty((m, ns), dtype=torch.float32, device=x.device)
    f = _build.fn("qmm_dequant", "qmm_dequant", [P] * 4 + [I] * 5 + [P])
    _build.check(f(xb.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                   y.data_ptr(), m, k, ns, g, int(q4), _stream(x.device)),
                 "qmm_dequant")
    qmm_dequant.launches += 1
    return y


qmm_dequant.launches = 0


def qmm_planes(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
               stacked: bool = False) -> torch.Tensor:
    """q4b two-plane GEMM (kernel qmm_planes): x float [M, K] (rounded to
    bf16 here), one q4b weight (qs uint8 [K/2, Ns], bf16 scales [K/32, Ns])
    -> f32 [M, Ns], or bf16 when planes_bf16_out(M), rounded in the kernel.
    The bias term stays with the caller (qmatmul). stacked: qs and scales
    are layer li's views of a stack (_qmm_call_planes_stacked); such
    launches are also counted in stacked_launches."""
    if x.device.type == "cpu":
        return qmm_planes_plain(x, qs, scales)
    xb = x.to(torch.bfloat16).contiguous()
    _check_tensors(x.device, (("x", xb, torch.bfloat16), ("qs", qs, torch.uint8),
                              ("scales", scales, torch.bfloat16)))
    m, k = xb.shape
    ns = qs.shape[-1]
    if m < 1 or k % 256 or ns % 16 or tuple(qs.shape) != (k // 2, ns) \
            or tuple(scales.shape) != (k // 32, ns):
        raise ValueError(f"qmm_planes shapes: x {tuple(xb.shape)}, qs "
                         f"{tuple(qs.shape)}, scales {tuple(scales.shape)} "
                         "(K % 256 == 0, Ns % 16 == 0, g 32)")
    bf = planes_bf16_out(m)
    y = torch.empty((m, ns), dtype=torch.bfloat16 if bf else torch.float32,
                    device=x.device)
    f = _build.fn("qmm_planes", "qmm_planes", [P] * 4 + [I] * 4 + [P])
    _build.check(f(xb.data_ptr(), qs.data_ptr(), scales.data_ptr(), y.data_ptr(),
                   m, k, ns, int(bf), _stream(x.device)), "qmm_planes")
    qmm_planes.launches += 1
    qmm_planes.stacked_launches += stacked
    return y


qmm_planes.launches = 0
qmm_planes.stacked_launches = 0


def _routed_launch(name, xq, sx, qs, scales, bias, ei, ti, g=None):
    """Launch one of the routed GEMVs of csrc/qmm_routed.cu on all slots."""
    dev = xq.device
    _check_ids(dev, (("ei", ei, torch.int32), ("ti", ti, torch.int32)))
    m, k = xq.shape
    slots, ns = ei.shape[0], qs.shape[-1]
    if ti.shape[0] != slots:
        raise ValueError(f"{name}: ei and ti name {slots} and {ti.shape[0]} slots")
    tiles = -(-ns // 128)
    y = torch.empty((slots, ns), dtype=torch.float32, device=dev)
    head = (xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), scales.data_ptr(), _ptr(bias),
            y.data_ptr())
    if g is None:
        s = m1_split(tiles * slots, k // 64, _sms(dev))
        f = _build.fn("qmm_routed", name, [P] * 8 + [I] * 4 + [P])
        err = f(*head, ei.data_ptr(), ti.data_ptr(), k, ns, s, slots, _stream(dev))
    else:
        s = _n_split(dev, tiles * slots, k // 32, k // 32 // 8)
        partial = torch.empty((slots, s, ns), dtype=torch.float32, device=dev)
        f = _build.fn("qmm_routed", name, [P] * 10 + [I] * 5 + [P])
        err = f(*head, partial.data_ptr(), _counter_buf(dev, slots * tiles).data_ptr(),
                ei.data_ptr(), ti.data_ptr(), k, ns, g, s, slots, _stream(dev))
    _build.check(err, name)
    return y


def qmm_txn_m1_r(xq, sx, qs, scales, bias, ei, ti) -> torch.Tensor:
    """Routed q4b GEMV (kernel qmm_txn_m1_r): out[s] = xq[ti[s]] @ W[ei[s]]
    for every slot in one launch; xq int8 [M, K], sx f32 [M, K/32], expert
    stacks qs uint8 [E, K/2, Ns] and bf16 scales (bias) [E, K/32, Ns]; ei,
    ti int32 [S] on the device. -> f32 [S, Ns]."""
    if xq.device.type == "cpu":
        return qmm_txn_m1_r_plain(xq, sx, qs, scales, bias, ei, ti)
    _check_q4b_stack(xq, sx, qs, scales, bias, 16)
    y = _routed_launch("qmm_txn_m1_r", xq, sx, qs, scales, bias, ei, ti)
    qmm_txn_m1_r.launches += 1
    return y


qmm_txn_m1_r.launches = 0


def qmm_q8_m1_r(xq, sx, qs, scales, bias, ei, ti) -> torch.Tensor:
    """Routed q8b GEMV (kernel qmm_q8_m1_r): as qmm_txn_m1_r on int8 expert
    stacks qs [E, K, Ns], scales (bias) bf16 [E, K/g, Ns], g 16 or 32."""
    if xq.device.type == "cpu":
        return qmm_q8_m1_r_plain(xq, sx, qs, scales, bias, ei, ti)
    dev = xq.device
    _check_tensors(dev, (("xq", xq, torch.int8), ("sx", sx, torch.float32),
                         ("qs", qs, torch.int8), ("scales", scales, torch.bfloat16),
                         ("bias", bias, torch.bfloat16)))
    m, k = xq.shape
    ns = qs.shape[-1]
    g = k // max(scales.shape[-2], 1)
    if qs.ndim != 3 or k % 32 or tuple(qs.shape[1:]) != (k, ns) or ns % 4 \
            or g not in (16, 32) or tuple(scales.shape[1:]) != (k // g, ns) \
            or tuple(sx.shape) != (m, k // 32) \
            or (bias is not None and bias.shape != scales.shape):
        raise ValueError(f"qmm_q8_m1_r shapes: xq {tuple(xq.shape)}, qs "
                         f"{tuple(qs.shape)}, scales {tuple(scales.shape)} "
                         "(stack [E, K, Ns], K % 32 == 0, g 16 or 32, Ns % 4 == 0)")
    y = _routed_launch("qmm_q8_m1_r", xq, sx, qs, scales, bias, ei, ti, g)
    qmm_q8_m1_r.launches += 1
    return y


qmm_q8_m1_r.launches = 0


def qmm_txn_g(xq, sx, qs, scales, bias, te, tm: int) -> torch.Tensor:
    """Grouped q4b product (kernel qmm_txn_g): row tile i (tm rows, 8 or 32)
    of xq int8 [S_pad, K] / sx f32 [S_pad, K/32] through expert te[i] of the
    stacks [E, K/2, Ns]; te int32 [S_pad / tm] on the device. -> f32
    [S_pad, Ns]."""
    if xq.device.type == "cpu":
        return qmm_txn_g_plain(xq, sx, qs, scales, bias, te, tm)
    _check_q4b_stack(xq, sx, qs, scales, bias, 16)
    dev = xq.device
    _check_ids(dev, (("te", te, torch.int32),))
    m, k = xq.shape
    tiles, ns = te.shape[0], qs.shape[-1]
    if not 1 <= tm <= 32 or m != tiles * tm:
        raise ValueError(f"qmm_txn_g: {m} rows in {tiles} tiles of {tm} (tm <= 32)")
    col_tiles = -(-ns // 128)
    s = _n_split(dev, col_tiles * tiles, k // 64, k // 64)
    y = torch.empty((m, ns), dtype=torch.float32, device=dev)
    partial = torch.empty((tiles, s, tm, ns), dtype=torch.float32, device=dev)
    f = _build.fn("qmm_txn_g", "qmm_txn_g", [P] * 9 + [I] * 5 + [P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                   _ptr(bias), y.data_ptr(), partial.data_ptr(),
                   _counter_buf(dev, tiles * col_tiles).data_ptr(), te.data_ptr(),
                   tm, tiles, k, ns, s, _stream(dev)), "qmm_txn_g")
    qmm_txn_g.launches += 1
    return y


qmm_txn_g.launches = 0


def qmm_planes_g(x, qs, scales, bias, te, tm: int = 128) -> torch.Tensor:
    """Grouped q4b two-plane GEMM (kernel qmm_planes_g): row tile i of 128
    rows of x float [S_pad, K] (rounded to bf16 here) through expert te[i]
    of the stacks [E, K/2, Ns], the bias term (group_sums_bf16(x) @ bias)
    fused in the kernel's f32 sum. -> f32 [S_pad, Ns], bf16 when S_pad >= 256."""
    if x.device.type == "cpu":
        return qmm_planes_g_plain(x, qs, scales, bias, te, tm)
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    bx = None if bias is None else group_sums_bf16(x).contiguous()
    _check_tensors(dev, (("x", xb, torch.bfloat16), ("qs", qs, torch.uint8),
                         ("scales", scales, torch.bfloat16), ("bx", bx, torch.bfloat16),
                         ("bias", bias, torch.bfloat16)))
    _check_ids(dev, (("te", te, torch.int32),))
    m, k = xb.shape
    tiles, ns = te.shape[0], qs.shape[-1]
    if tm != 128 or m != tiles * tm or k % 256 or ns % 16 or qs.ndim != 3 \
            or tuple(qs.shape[1:]) != (k // 2, ns) or tuple(scales.shape[1:]) != (k // 32, ns) \
            or (bias is not None and bias.shape != scales.shape):
        raise ValueError(f"qmm_planes_g shapes: x {tuple(xb.shape)} in {tiles} tiles of "
                         f"{tm} (tm 128), qs {tuple(qs.shape)}, scales {tuple(scales.shape)}")
    bf = m >= 256
    y = torch.empty((m, ns), dtype=torch.bfloat16 if bf else torch.float32, device=dev)
    f = _build.fn("qmm_planes_g", "qmm_planes_g", [P] * 7 + [I] * 4 + [P])
    _build.check(f(xb.data_ptr(), qs.data_ptr(), scales.data_ptr(), te.data_ptr(),
                   _ptr(bx), _ptr(bias), y.data_ptr(), tiles, k, ns, int(bf),
                   _stream(dev)), "qmm_planes_g")
    qmm_planes_g.launches += 1
    return y


qmm_planes_g.launches = 0


def i8p_tile_n(m: int, ns: int, sms: int) -> int:
    """The n tile of qmm_i8p's launch: 128, or 64 where the 128 x 128 tiles
    of an M x Ns product would fill at most half of the card's sms SMs (a
    short prompt's bucket), so that twice as many blocks share the work;
    the output bits are the same at either width."""
    return 64 if 2 * -(-m // 128) * -(-ns // 128) <= sms else 128


def qmm_i8p(xq: torch.Tensor, sxa: torch.Tensor, w8: torch.Tensor,
            sw: torch.Tensor) -> torch.Tensor:
    """int8 prefill GEMM (kernel qmm_i8p, s8 warpgroup tensor cores): xq int8
    [M, K] and sxa f32 [M, K/256] from i8p_prep, one layer's companion w8
    int8 [Ns, K] and sw f32 [K/256, Ns] (a stacked caller passes layer li's
    views: the kernel reads them by pointer) -> f32 [M, Ns], equal to
    qmm_i8p_plain bit for bit, at the n tile of i8p_tile_n."""
    if xq.device.type == "cpu":
        return qmm_i8p_plain(xq, sxa, w8, sw)
    _check_tensors(xq.device, (("xq", xq, torch.int8), ("sxa", sxa, torch.float32),
                               ("w8", w8, torch.int8), ("sw", sw, torch.float32)))
    m, k = xq.shape
    ns = w8.shape[0]
    if m < 1 or k % I8P_BLOCK or ns % 16 or tuple(w8.shape) != (ns, k) \
            or tuple(sxa.shape) != (m, k // I8P_BLOCK) \
            or tuple(sw.shape) != (k // I8P_BLOCK, ns):
        raise ValueError(f"qmm_i8p shapes: xq {tuple(xq.shape)}, sxa {tuple(sxa.shape)}, "
                         f"w8 {tuple(w8.shape)}, sw {tuple(sw.shape)} (w8 [Ns, K], "
                         "K % 256 == 0, Ns % 16 == 0)")
    bn = i8p_tile_n(m, ns, torch.cuda.get_device_properties(xq.device).multi_processor_count)
    y = torch.empty((m, ns), dtype=torch.float32, device=xq.device)
    f = _build.fn("qmm_i8p", "qmm_i8p", [P] * 5 + [I] * 4 + [P])
    _build.check(f(xq.data_ptr(), sxa.data_ptr(), w8.data_ptr(), sw.data_ptr(),
                   y.data_ptr(), m, k, ns, bn, _stream(xq.device)), "qmm_i8p")
    qmm_i8p.launches += 1
    return y


qmm_i8p.launches = 0


def qmm_int8(xq: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor,
             scales: torch.Tensor) -> torch.Tensor:
    """q4b product for 1 <= M <= 32 rows under the int8 flavour (kernel
    qmm_int8: qmm_txn's body with no bias term, on s8 tensor cores; its
    split is qmm_txn's): xq int8 [M, K] and sx f32 [M, K/32] from
    quantize_activations_g32 of the normed x, one layer's qs uint8 [K/2,
    Ns] and bf16 scales [K/32, Ns] (a stacked caller passes layer li's
    views) -> f32 [M, Ns]. No bias: the caller adds that term outside."""
    if xq.device.type == "cpu":
        return qmm_int8_plain(xq, sx, qs, scales)
    _check_q4b(xq, sx, qs, scales, None, 16)
    m, k = xq.shape
    if not 1 <= m <= 32:
        raise ValueError(f"qmm_int8 takes 1..32 rows, got {m}")
    ns = qs.shape[-1]
    tiles = -(-ns // 128)
    s = txn_split(ns, k, _sms(xq.device))
    y = torch.empty((m, ns), dtype=torch.float32, device=xq.device)
    partial = torch.empty((s, m, ns), dtype=torch.float32, device=xq.device)
    f = _build.fn("qmm_int8", "qmm_int8", [P] * 7 + [I] * 4 + [P])
    _build.check(f(xq.data_ptr(), sx.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                   y.data_ptr(), partial.data_ptr(),
                   _counter_buf(xq.device, tiles).data_ptr(), m, k, ns, s,
                   _stream(xq.device)), "qmm_int8")
    qmm_int8.launches += 1
    return y


qmm_int8.launches = 0

KERNELS = (qmm_txn_m1, qmm_txn, qmm_moe_m1, qmm_q8_m1, qmm_dequant, qmm_planes,
           qmm_txn_m1_r, qmm_q8_m1_r, qmm_txn_g, qmm_planes_g, qmm_i8p, qmm_int8)


# ---------------------------------------------------------------------------
# Dispatch (the JAX package's order, for the branches the port reaches)
# ---------------------------------------------------------------------------


def _layer(t: Optional[torch.Tensor], li):
    """Layer li of a stacked leaf: a view, no copy (the kernels take its
    pointer)."""
    return t if (t is None or li is None) else t[li]


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """x with zero rows appended up to a multiple of `multiple` rows."""
    pad = -x.shape[0] % multiple
    return x if pad == 0 else torch.cat([x, x.new_zeros((pad, x.shape[1]))])


def product_route(qt: QTensor, m: int, k: int, li=None, fl=None) -> str:
    """The kernel that qmatmul runs for x [m, k] against qt (li: stacked
    layer id or None), by the reference's branches under flavour fl (None:
    the flavour in force): "qmm_q8_m1", "qmm_txn_m1", "qmm_txn", "qmm_i8p",
    "qmm_int8", "qmm_planes", "qmm_dequant", or "dense" (no kernel)."""
    if qt.kind == "dense":
        return "dense"
    if qt.kind not in ("q4b", "q8b"):
        raise NotImplementedError(f"QTensor kind {qt.kind!r}")
    if fl is None:
        fl = q4b_flavour()
    txn = fl == "txn"
    if qt.kind == "q8b" and txn and m == 1 and qt.g in (16, 32) and k % (8 * qt.g) == 0:
        return "qmm_q8_m1"
    if qt.kind == "q4b" and txn and m <= 32 and k % 256 == 0:
        return "qmm_txn_m1" if m == 1 else "qmm_txn"
    if getattr(qt, "qs8", None) is not None and m > 32 and k % I8P_BLOCK == 0:
        return "qmm_i8p"
    if qt.kind == "q4b" and k % 256 == 0:
        if fl == "int8" and -(-m // 8) * 8 <= 32:
            return "qmm_int8"
        if fl in ("int8", "planes") or (txn and li is None):
            return "qmm_planes"
    return "qmm_dequant"


def qmatmul(x: torch.Tensor, qt: QTensor, li=None, prenorm=None) -> torch.Tensor:
    """y[M, N] = x[M, K] @ W.T for a GGML weight W[N, K] stored K-major.

    x float [M, K]; returns f32 [M, N], or bf16 where the reference's is
    (a q4b product on the planes kernel at a padded M >= 256). With li (a
    Python int), qt holds layer-stacked leaves and layer li is used in
    place. prenorm=(w, eps) applies RMSNorm(x)*w first; on the txn
    flavour's int8-activation paths it folds into the activation
    quantization (exact, see quantize_activations_g32).

    The kernel is product_route's, the reference's branch order
    (llamafile_tpu/ops/qmatmul.py qmatmul). Under "txn": q8b M = 1 ->
    qmm_q8_m1; q4b M = 1 -> qmm_txn_m1; q4b 2 <= M <= 32 -> qmm_txn. Under
    every flavour, an I8PQTensor at M > 32 -> qmm_i8p on its companion (f32
    out, the bias folded in). The rest runs on the normed x, its rows padded
    to a multiple of 8 outside "txn": q4b under "int8" at padded M <= 32 ->
    qmm_int8; q4b under "int8" or "planes", or unstacked under "txn" ->
    qmm_planes; everything else -> qmm_dequant. These add the bias term
    on the f32 group sums of that x in the product's dtype."""
    if qt.kind == "dense":
        w = _layer(qt.qs, li)
        if prenorm is not None:
            x = apply_rmsnorm(x, *prenorm)
        # f32 product of bf16-rounded operands (jnp.dot with f32 accumulation)
        return x.to(torch.bfloat16).float() @ w.float()
    m, k = x.shape
    fl = q4b_flavour()
    route = product_route(qt, m, k, li, fl)
    nrm, eps = _norm_args(prenorm)
    qs, sc, b = _layer(qt.qs, li), _layer(qt.scales, li), _layer(qt.bias, li)
    if route == "qmm_txn_m1":
        y = qmm_txn_m1(*quantize_activations_g32(x, nrm, eps), qs, sc, b)
    elif route == "qmm_txn":
        y = qmm_txn(*quantize_activations_g32(x, nrm, eps), qs, sc, b)
    elif route == "qmm_q8_m1":
        y = qmm_q8_m1(*quantize_activations_g32(x, nrm, eps), qs, sc, b)
    elif route == "qmm_i8p":
        xq, sxa = i8p_prep(x.float() if nrm is None else apply_rmsnorm(x, nrm, eps))
        y = qmm_i8p(xq, sxa, _layer(qt.qs8, li), _layer(qt.s8, li))
    else:
        xn = x.float() if nrm is None else apply_rmsnorm(x, nrm, eps)
        if fl != "txn":
            xn = _pad_rows(xn, 8)
        if route == "qmm_int8":
            y = qmm_int8(*quantize_activations_g32(xn), qs, sc)
        elif route == "qmm_planes":
            y = qmm_planes(xn, qs, sc, stacked=li is not None)
        else:
            y = qmm_dequant(xn, qs, sc)
        if b is not None:
            # outside the kernel, as the reference: f32 sums of the
            # un-rounded normed x against the bias rows, in y's dtype
            bias = xn.reshape(xn.shape[0], k // qt.g, qt.g).sum(-1) @ b.float()
            y = y + bias.to(y.dtype)
        y = y[:m]
    n = qt.shape[0]
    return y[:, :n] if y.shape[1] > n else y


def qmatmul_fallback(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Reference path with the dequantized weight materialized (tests)."""
    from .repack import dequant_qtensor
    w = dequant_qtensor(qt)                                       # [N, K]
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()


def moe_fusable(gu_qt, dn_qt, k: int, dff: int) -> bool:
    """Shape/kind gate for the fused FFN kernel (stacked q4b, il layout,
    the txn flavour)."""
    if gu_qt is None or dn_qt is None:
        return False
    if gu_qt.kind != "q4b" or dn_qt.kind != "q4b" or q4b_flavour() != "txn":
        return False
    if gu_qt.qs.ndim != 3 or dn_qt.qs.ndim != 3:
        return False
    n_gu, d_out = gu_qt.qs.shape[2], dn_qt.qs.shape[2]
    ok = (k % 256 == 0 and dff % 1024 == 0 and n_gu == 2 * dff
          and n_gu % 2048 == 0 and dff % 256 == 0 and d_out % 256 == 0)
    kd = dn_qt.qs.shape[1] * 2
    if ok and kd != dff:
        # the reference reads phase B's depth from the down stack unchecked
        raise ValueError(f"down stack depth {kd} != d_ff {dff}")
    return ok


def _slot_rows(m: int, s_n: int, device) -> torch.Tensor:
    """Default slot -> row map: each row's S/M slots contiguous (s // (S/M))."""
    return (torch.arange(s_n, dtype=torch.int32, device=device)
            // (s_n // m)).to(torch.int32)


def _norm_args(prenorm):
    return (None, 0.0) if prenorm is None else (prenorm[0], float(prenorm[1]))


def qmatmul_moe(x: torch.Tensor, gu_qt: QTensor, dn_qt: QTensor,
                expert_ids: torch.Tensor, topw: torch.Tensor,
                row_map: Optional[torch.Tensor] = None, prenorm=None) -> torch.Tensor:
    """Fused routed FFN entry: out[s] = (silu(g)*u*topw[s]) @ Wdn[e].T with
    [g|u] = x[row_map[s]] @ Wgu[e].T and e = expert_ids[s], for every slot in
    one kernel call. expert_ids int [S] and topw float [S] are tensors on
    x's device (the router's top-k, or the dense llama FFN's layer id and a
    weight of one); row_map defaults to s // (S / M). gu_qt is the
    GU_STRIPE-interleaved gate|up stack, dn_qt the down stack. Returns f32
    [S, d]. Callers check moe_fusable first."""
    m = x.shape[0]
    s_n = expert_ids.shape[0]
    if row_map is None and s_n != m:
        row_map = _slot_rows(m, s_n, x.device)
    nrm, eps = _norm_args(prenorm)
    xq, sx = quantize_activations_g32(x, nrm, eps)
    as_i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
    y = qmm_moe_m1(xq, sx, gu_qt.qs, gu_qt.scales, gu_qt.bias, dn_qt.qs,
                   dn_qt.scales, dn_qt.bias, as_i32(expert_ids), as_i32(row_map),
                   topw.to(torch.float32).contiguous())
    n = dn_qt.shape[0]
    return y[:, :n] if y.shape[1] > n else y


def _routed_fallback(x: torch.Tensor, qt: QTensor, ei: torch.Tensor,
                     ti: torch.Tensor) -> torch.Tensor:
    """Reference routed product for experts the kernels do not take (dense
    kind, odd shapes, q4b outside the txn flavour): each slot's expert
    gathered and dequantized, then qmatmul_fallback's bf16 product. f32
    [S, N]. Counted in ROUTE_COUNTS["routed_fallback"]."""
    from .repack import dequant_qtensor
    ROUTE_COUNTS["routed_fallback"] += 1
    outs = []
    for s in range(ei.shape[0]):
        e = ei[s:s + 1]
        sub = QTensor(qt.kind, qt.shape, qt.g, _expert(qt.qs, e), _expert(qt.scales, e),
                      _expert(qt.bias, e))
        w = dequant_qtensor(sub)                                  # [N, K]
        row = x.index_select(0, ti[s:s + 1])
        outs.append(row.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t())
    return torch.cat(outs, dim=0)


def qmatmul_routed(x: torch.Tensor, qt: QTensor, expert_ids: torch.Tensor,
                   row_map: Optional[torch.Tensor] = None, prenorm=None) -> torch.Tensor:
    """Expert-routed product: y[s] = x[row_map[s]] @ W[expert_ids[s]].T over
    expert-stacked leaves (leading axis E, or L*E under stacked layers).
    expert_ids and row_map are int tensors on x's device, row_map
    defaulting to s // (S / M). q4b under the txn flavour -> qmm_txn_m1_r,
    q8b (g 16 or 32) -> qmm_q8_m1_r under every flavour (the reference
    does not test it there), the rest -> _routed_fallback. Returns f32
    [S, N]."""
    m, k = x.shape
    s_n = expert_ids.shape[0]
    if row_map is None:
        row_map = _slot_rows(m, s_n, x.device)
    ei, ti = (t.to(torch.int32).contiguous() for t in (expert_ids, row_map))
    nrm, eps = _norm_args(prenorm)
    if qt.kind == "q4b" and q4b_flavour() == "txn" and k % 256 == 0:
        xq, sx = quantize_activations_g32(x, nrm, eps)
        y = qmm_txn_m1_r(xq, sx, qt.qs, qt.scales, qt.bias, ei, ti)
    elif qt.kind == "q8b" and qt.g in (16, 32) and k % (8 * qt.g) == 0 and k % 32 == 0:
        xq, sx = quantize_activations_g32(x, nrm, eps)
        y = qmm_q8_m1_r(xq, sx, qt.qs, qt.scales, qt.bias, ei, ti)
    else:
        if prenorm is not None:
            x = apply_rmsnorm(x, nrm, eps)
        y = _routed_fallback(x, qt, ei, ti)
    n = qt.shape[0]
    return y[:, :n] if y.shape[1] > n else y


def qmatmul_grouped(x: torch.Tensor, qt: QTensor, tile_expert: torch.Tensor, *,
                    tm: int) -> torch.Tensor:
    """Grouped expert product: row tile i (tm rows) of x [S_pad, K] float
    multiplies W[tile_expert[i]].T of a q4b expert stack, K % 256 == 0
    (callers guard). tm <= 32 -> qmm_txn_g on per-32 int8 activations (f32
    out); tm 128 -> qmm_planes_g (bf16 out from 256 rows). Returns [S_pad, N]."""
    k = x.shape[1]
    if qt.kind != "q4b" or k % 256 or x.shape[0] % tm:
        raise ValueError("qmatmul_grouped: q4b experts, K % 256 == 0, rows a multiple of tm")
    te = tile_expert.to(torch.int32).contiguous()
    if tm <= 32:
        xq, sx = quantize_activations_g32(x)
        y = qmm_txn_g(xq, sx, qt.qs, qt.scales, qt.bias, te, tm)
    else:
        y = qmm_planes_g(x, qt.qs, qt.scales, qt.bias, te, tm)
    n = qt.shape[0]
    return y[:, :n] if y.shape[1] > n else y
