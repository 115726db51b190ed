"""Repack GGUF block formats into the kernels' quantized tensors (QTensor).

Counterpart of llamafile_tpu/ops/repack.py for the formats the port loads
(Q4_K, Q5_K, Q8_0, Q6_K, F32, F16, BF16). The device layout is byte-identical to
the JAX package's `repack_numpy` + `repack` (held so by
tests/test_torch_repack.py):

  kind "q4b":   qs uint8 [K/2, Ns] -- nibble-planar per 256-superblock:
                byte 128*sb+i = q[256sb+i] | q[256sb+128+i] << 4
                scales/bias bf16 [K/32, Ns], the hi-plane groups folded
                (a' = a/16, b' = b + 8a) so a kernel reads the hi nibble as
                int8((p ^ 0x80) & 0xF0) = 16q - 128
  kind "q8b":   qs int8 [K, Ns] codes, scales bf16 [K/g, Ns] (g 32 for Q8_0
                and Q5_K, 16 for Q6_K); Q5_K's codes 0..31 carry a bias
                bf16 [K/32, Ns] (-dmin * min), Q8_0 and Q6_K none
  kind "dense": qs bf16 [K, N]

Ns is N padded to a multiple of 2048 (logical N stays in QTensor.shape;
qmatmul slices the output). A leading layer axis L appears after
models.llama.stack_layers, a leading expert axis E after stack_experts (L*E
for stacked MoE layers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..gguf import quants as Q

# 1024-wide gate|up stripes ([g0|u0|g1|u1|...]): each 2048-wide column tile
# holds one g/u pair, so the fused FFN kernel forms silu(g)*u in its epilogue
GU_STRIPE = 1024


@dataclass
class QTensor:
    """Device-resident quantized weight (torch leaves)."""
    kind: str                    # "q4b" | "q8b" | "dense"
    shape: tuple                 # logical (N, K), GGML convention
    g: int                       # scale group size along K (0 for dense)
    qs: torch.Tensor             # uint8 [(L,) K/2, Ns] | int8 [(L,) K, Ns]
    #                              | bf16 [(L,) K, N]
    scales: Optional[torch.Tensor] = None   # bf16 [(L,) K/g, Ns]
    bias: Optional[torch.Tensor] = None     # bf16 [(L,) K/g, Ns]
    il: bool = False             # columns are GU_STRIPE-interleaved gate|up

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.qs, self.scales, self.bias) if t is not None)

    def to(self, device) -> "QTensor":
        mv = lambda t: None if t is None else t.to(device)
        return QTensor(self.kind, self.shape, self.g, mv(self.qs),
                       mv(self.scales), mv(self.bias), self.il)


# ---------------------------------------------------------------------------
# Host-side (numpy) extraction: own copies of the reference's helpers
# ---------------------------------------------------------------------------

def _pack_nibbles_sb128(qT: np.ndarray) -> np.ndarray:
    """int (K, N) values 0..15 -> uint8 (K/2, N), planar per 256-superblock."""
    k, n = qT.shape
    assert k % 256 == 0
    sb = qT.reshape(k // 256, 2, 128, n).astype(np.uint8)
    return (sb[:, 0] | (sb[:, 1] << 4)).reshape(k // 2, n)


def _fold_hi_plane(a: np.ndarray, b: Optional[np.ndarray], g: int):
    """Fold the hi nibble's 16x and -128 into the group metadata: for hi-plane
    groups a' = a/16, b' = b + 8a, so a'*(16q - 128) + b' = a*q + b exactly."""
    kg, n = a.shape
    rows_per_sb = 256 // g                 # groups per superblock
    hi = (np.arange(kg) % rows_per_sb) >= rows_per_sb // 2
    if b is None:
        b = np.zeros_like(a)
    b = b + np.where(hi[:, None], 8.0 * a, 0.0)
    a = np.where(hi[:, None], a / 16.0, a)
    return a.astype(np.float32), b.astype(np.float32)


def _extract_q4_k(b):
    d = Q._f16(b[:, 0:2])[:, 0]
    dmin = Q._f16(b[:, 2:4])[:, 0]
    sc, mn = Q._scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144]
    nb = b.shape[0]
    q = np.empty((nb, 256), np.uint8)
    for blk in range(4):
        g = qs[:, 32 * blk:32 * blk + 32]
        q[:, 64 * blk:64 * blk + 32] = g & 0xF
        q[:, 64 * blk + 32:64 * blk + 64] = g >> 4
    a = d[:, None] * sc
    bb = -dmin[:, None] * mn
    return q, a, bb, 32


def _extract_q8_0(b):
    d = Q._f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8)
    return q, d, None, 32


def _extract_q5_k(b):
    q, a, bb = Q.q5_k_codes(b)
    return q, a, bb, 32


def _extract_q6_k(b):
    q, a = Q.q6_k_codes(b)
    return q, a, None, 16


_EXTRACTORS = {"Q8_0": _extract_q8_0, "Q4_K": _extract_q4_k,
               "Q5_K": _extract_q5_k, "Q6_K": _extract_q6_k}


def repack_numpy(raw: np.ndarray, type_name: str, shape: tuple):
    """Raw block bytes -> (kind, qs, scales, bias, g) numpy arrays, unpadded.

    shape = (N, K) with K contiguous (GGML weight W[N, K], y = x @ W.T).
    """
    Q.check_supported(type_name)
    n, k = int(np.prod(shape[:-1])), shape[-1]
    spec = Q.TYPE_BY_NAME[type_name]
    if type_name in ("F32", "F16", "BF16"):
        w = Q.dequantize(raw, spec.type_id, (n, k))
        return "dense", np.ascontiguousarray(w.T), None, None, 0
    nblocks = n * k // spec.block_elems
    blocks = (np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray)
              else raw).reshape(nblocks, spec.block_bytes)
    q, a, b, g = _EXTRACTORS[type_name](blocks)
    qT = np.ascontiguousarray(q.reshape(n, k).T)                  # (K, N)
    a = np.ascontiguousarray(a.reshape(n, k // g).T, dtype=np.float32)
    if b is not None:
        b = np.ascontiguousarray(b.reshape(n, k // g).T, dtype=np.float32)
    if type_name == "Q4_K" and k % 256 == 0:
        a, b = _fold_hi_plane(a, b, g)
        return "q4b", _pack_nibbles_sb128(qT), a, b, g
    return "q8b", np.ascontiguousarray(qT.astype(np.int8)), a, b, g


def _pad_n(arrs, n: int, multiple: int = 2048):
    """Pad the N (last) axis of K-major arrays to a multiple of 2048."""
    pad = (-n) % multiple
    if pad == 0:
        return arrs
    return [None if a is None else
            np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)]) for a in arrs]


def repack(raw: np.ndarray, type_name: str, shape: tuple,
           device="cuda") -> QTensor:
    """Repack raw GGUF bytes to a QTensor on `device` (scales/bias bf16)."""
    kind, qs, a, b, g = repack_numpy(raw, type_name, shape)
    n, k = int(np.prod(shape[:-1])), shape[-1]
    if kind == "dense":
        return QTensor("dense", (n, k), 0,
                       torch.from_numpy(qs).to(device).to(torch.bfloat16))
    qs, a, b = _pad_n([qs, a, b], n)
    bf = lambda x: None if x is None else torch.from_numpy(
        np.ascontiguousarray(x)).to(device).to(torch.bfloat16)
    return QTensor(kind, (n, k), g, torch.from_numpy(qs).to(device), bf(a),
                   bf(b))


# ---------------------------------------------------------------------------
# Device-side helpers (plain torch)
# ---------------------------------------------------------------------------

def q4b_codes(qs: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K/2, Ns] packed nibbles -> int8 [..., K, Ns] codes in the
    kernels' convention: lo plane q (0..15), hi plane 16q - 128."""
    *lead, k2, ns = qs.shape
    lo = (qs & 0x0F).view(torch.int8)
    hi = ((qs ^ 0x80) & 0xF0).view(torch.int8)
    lo = lo.reshape(*lead, k2 // 128, 1, 128, ns)
    hi = hi.reshape(*lead, k2 // 128, 1, 128, ns)
    return torch.cat([lo, hi], dim=-3).reshape(*lead, 2 * k2, ns)


def dequant_qtensor(qt: QTensor) -> torch.Tensor:
    """Reconstruct f32 weights [N, K] (logical N) of an unstacked QTensor."""
    n, k = qt.shape
    if qt.kind == "dense":
        return qt.qs.float().t()[:n]
    q = (q4b_codes(qt.qs) if qt.kind == "q4b" else qt.qs).float()   # [K, Ns]
    ns = q.shape[-1]
    w = (q.reshape(k // qt.g, qt.g, ns) * qt.scales.float()[:, None, :])
    if qt.bias is not None:
        w = w + qt.bias.float()[:, None, :]
    return w.reshape(k, ns)[:, :n].t()


def concat_qtensors(qts) -> QTensor:
    """Fuse column-parallel projections along N (storage axis -1). Storage
    padding is stripped to each tensor's logical N first; missing biases
    become zeros so the fused tensor has one bias path."""
    kind, g = qts[0].kind, qts[0].g
    k = qts[0].shape[1]
    if not all(q.kind == kind and q.g == g and q.shape[1] == k for q in qts):
        raise ValueError("concat_qtensors needs one kind, group size and K")
    n_total = sum(q.shape[0] for q in qts)

    def logical(arr, qt):
        return arr[..., : qt.shape[0]]

    qs = torch.cat([logical(q.qs, q) for q in qts], dim=-1)
    if kind == "dense":
        return QTensor(kind, (n_total, k), g, qs)
    scales = torch.cat([logical(q.scales, q) for q in qts], dim=-1)
    bias = None
    if any(q.bias is not None for q in qts):
        bias = torch.cat([logical(q.bias if q.bias is not None
                                  else torch.zeros_like(q.scales), q)
                          for q in qts], dim=-1)
    return QTensor(kind, (n_total, k), g, qs, scales, bias)


def interleave_gateup(g_qt: QTensor, u_qt: QTensor) -> QTensor:
    """Fuse a dense-FFN gate/up pair into one GU_STRIPE-interleaved QTensor:
    columns [g0|u0|g1|u1|...] in 1024-wide stripes. Outputs de-interleave
    with qmatmul.split_gu."""
    dff = g_qt.shape[0]
    if not (g_qt.kind == u_qt.kind == "q4b" and g_qt.g == u_qt.g
            and g_qt.shape == u_qt.shape and dff % GU_STRIPE == 0):
        raise ValueError("interleave_gateup needs matching q4b gate/up with "
                         f"d_ff a multiple of {GU_STRIPE}")

    def cat(a, b):
        if a is None:
            return None
        lead = a.shape[:-1]
        p = torch.stack(
            [a[..., :dff].reshape(*lead, dff // GU_STRIPE, GU_STRIPE),
             b[..., :dff].reshape(*lead, dff // GU_STRIPE, GU_STRIPE)],
            dim=-2)
        return p.reshape(*lead, 2 * dff)

    return QTensor(g_qt.kind, (2 * dff, g_qt.shape[1]), g_qt.g,
                   cat(g_qt.qs, u_qt.qs), cat(g_qt.scales, u_qt.scales),
                   cat(g_qt.bias, u_qt.bias), True)


def stack_experts(experts: dict, n_experts: int, fuse_gate_up: bool = False) -> dict:
    """Per-expert QTensors ("gate.{e}", "up.{e}", "down.{e}") -> one QTensor
    a role with a leading expert axis: qs [E, K(/2), Ns], scales/bias
    [E, K/g, Ns]. Raises KeyError or ValueError on heterogeneous experts
    (the caller then keeps the per-expert dict).

    fuse_gate_up joins gate and up along N: GU_STRIPE-interleaved
    ("gateup_il", the fused FFN kernel's layout) when both are q4b and d_ff
    is a multiple of GU_STRIPE, concatenated ("gateup") otherwise. The
    stacks are byte-identical to the reference's stack_experts."""
    out = {}
    for role in ("gate", "up", "down"):
        qts = [experts[f"{role}.{e}"] for e in range(n_experts)]
        kind, shape, g = qts[0].kind, qts[0].shape, qts[0].g
        if any(q.kind != kind or q.shape != shape or q.g != g for q in qts):
            raise ValueError(f"heterogeneous experts for {role}")
        st = lambda ts: None if ts[0] is None else torch.stack(ts)
        out[role] = QTensor(kind, shape, g, st([q.qs for q in qts]),
                            st([q.scales for q in qts]), st([q.bias for q in qts]))
    g_qt, u_qt = out["gate"], out["up"]
    dff = g_qt.shape[0]
    if (fuse_gate_up and g_qt.kind != "dense" and dff % 128 == 0
            and g_qt.shape == u_qt.shape and g_qt.kind == u_qt.kind
            and g_qt.g == u_qt.g and (g_qt.bias is None) == (u_qt.bias is None)):
        if g_qt.kind == "q4b" and dff % GU_STRIPE == 0:
            out["gateup_il"] = interleave_gateup(g_qt, u_qt)
        else:
            cat = lambda a, b: None if a is None else torch.cat(
                [a[..., :dff], b[..., :dff]], dim=-1)
            out["gateup"] = QTensor(g_qt.kind, (2 * dff, g_qt.shape[1]), g_qt.g,
                                    cat(g_qt.qs, u_qt.qs),
                                    cat(g_qt.scales, u_qt.scales),
                                    cat(g_qt.bias, u_qt.bias))
        del out["gate"], out["up"]
    return out


def expert_slice(qt: QTensor, e: int) -> QTensor:
    """View of expert e (a Python int) of an expert-stacked QTensor."""
    pick = lambda a: None if a is None else a[e]
    return QTensor(qt.kind, qt.shape, qt.g, pick(qt.qs), pick(qt.scales),
                   pick(qt.bias), qt.il)
