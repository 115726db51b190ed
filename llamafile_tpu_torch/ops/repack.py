"""Repack GGUF block formats into the kernels' quantized tensors (QTensor).

Counterpart of llamafile_tpu/ops/repack.py for every format the port
loads (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, IQ4_NL,
IQ4_XS, the grid IQ types IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S and
IQ1_M; dense: F32, F16, BF16, F64, the integer types, Q8_K), and the int8
prefill companion (I8PQTensor, attach_int8_prefill). Q8_0, Q4_0, Q4_K,
Q5_K and Q6_K go through the native repacker (native.py) where it builds.
The device layout is byte-identical to the JAX package's `repack_numpy` +
`repack` (held so by tests/test_torch_repack.py):

  kind "q4b":   qs uint8 [K/2, Ns] -- nibble-planar per 256-superblock:
                byte 128*sb+i = q[256sb+i] | q[256sb+128+i] << 4
                scales/bias bf16 [K/32, Ns], the hi-plane groups folded
                (a' = a/16, b' = b + 8a) so a kernel reads the hi nibble as
                int8((p ^ 0x80) & 0xF0) = 16q - 128
                Q4_0 and Q4_1 (the nibble formats) take it too when K %
                256 == 0: Q4_0 with bias -8d, Q4_1 with its min
  kind "q8b":   qs int8 [K, Ns] codes, scales bf16 [K/g, Ns] (g 32 for Q8_0,
                Q5_0, Q5_1, Q5_K, IQ4_NL, IQ4_XS, IQ2_XXS, IQ3_XXS, IQ3_S,
                IQ1_S and Q4_0/Q4_1 at K % 256; 16 for Q2_K, Q3_K, Q6_K,
                IQ2_XS, IQ2_S; 8 for IQ1_M); codes with an offset carry a
                bias bf16 [K/g, Ns] (Q5_0's -16d, Q5_1's min, Q2_K's and
                Q5_K's -dmin * min, IQ1_S's and IQ1_M's +-delta * scale),
                Q8_0, Q3_K, Q6_K and the IQ4 and IQ2/IQ3 grid codes none
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


@dataclass
class I8PQTensor(QTensor):
    """QTensor carrying an int8-g256 prefill companion (the reference's
    I8PQTensor, llamafile_tpu/ops/repack.py:79-101): the base weights
    dequantized once and requantized to symmetric int8 with one f32 scale
    per 256-deep K block of each column. Prefill products of M > 32 rows run
    the int8 tensor-core kernel on it (ops/qmatmul.qmm_i8p); decode keeps
    reading the base leaves, which are shared, not copied.

    qs8 is int8 [(L,) Ns, K], the transpose of the reference's [K, Ns]: K
    contiguous, as both operands of the kernel's s8 mma.sync are. s8 is f32
    [(L,) K/256, Ns], as the reference's."""
    qs8: Optional[torch.Tensor] = None
    s8: Optional[torch.Tensor] = None

    def to(self, device) -> "I8PQTensor":
        b = super().to(device)
        return I8PQTensor(b.kind, b.shape, b.g, b.qs, b.scales, b.bias, b.il,
                          self.qs8.to(device), self.s8.to(device))


I8P_BLOCK = 256


@torch.no_grad()
def attach_int8_prefill(qt):
    """An I8PQTensor with the int8-g256 companion built on qt's device by
    torch ops, in the arithmetic of the reference's jitted build
    (attach_int8_prefill): w = code * scale (+ bias), s = max(absmax of a
    256-block, 1e-12) times the f32 reciprocal of 127 (jit's rewrite of
    / 127.0), q8 = clip(round(w / s), -127, 127) with a true divide and
    round half to even. qt itself for what the prefill kernel does not
    take: dense, a kind other than q4b/q8b, K % 256, leaves already
    stacked, a companion already attached."""
    if (not isinstance(qt, QTensor) or isinstance(qt, I8PQTensor)
            or qt.kind not in ("q4b", "q8b") or qt.shape[1] % I8P_BLOCK
            or qt.qs.ndim != 2):
        return qt
    k, ns = qt.shape[1], qt.qs.shape[-1]
    q = (q4b_codes(qt.qs) if qt.kind == "q4b" else qt.qs).float()      # [K, Ns]
    w = (q.reshape(k // qt.g, qt.g, ns) * qt.scales.float()[:, None, :]).reshape(k, ns)
    del q
    if qt.bias is not None:
        w = w + qt.bias.float().repeat_interleave(qt.g, dim=0)
    wb = w.reshape(k // I8P_BLOCK, I8P_BLOCK, ns)
    s = torch.clamp(wb.abs().amax(dim=1), min=1e-12) * (1.0 / 127.0)
    q8 = torch.clamp(torch.round(wb / s[:, None, :]), -127, 127).to(torch.int8)
    return I8PQTensor(qt.kind, qt.shape, qt.g, qt.qs, qt.scales, qt.bias, qt.il,
                      q8.reshape(k, ns).t().contiguous(), s)


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


def _extract_q4_0(b):
    d = Q._f16(b[:, 0:2])
    qs = b[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)          # (nb, 32) 0..15
    return q, d.astype(np.float32), (-8.0 * d).astype(np.float32), 32


def _extract_q4_1(b):
    d = Q._f16(b[:, 0:2])
    m = Q._f16(b[:, 2:4])
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d, m, 32


def _q5_codes(qh, qs):
    """A Q5_0/Q5_1 block's 32 codes 0..31 from its qh word and qs bytes."""
    j = np.arange(16, dtype=np.uint32)
    lo = (qs & 0xF) | (((qh >> j) & 1) << 4).astype(np.uint8)
    hi = (qs >> 4) | (((qh >> (j + 16)) & 1) << 4).astype(np.uint8)
    return np.concatenate([lo, hi], axis=1)


def _extract_q5_0(b):
    d = Q._f16(b[:, 0:2])
    q = _q5_codes(Q._u32(b[:, 2:6]).reshape(-1, 1), b[:, 6:22])
    return q, d, -16.0 * d, 32


def _extract_q5_1(b):
    d = Q._f16(b[:, 0:2])
    m = Q._f16(b[:, 2:4])
    return _q5_codes(Q._u32(b[:, 4:8]).reshape(-1, 1), b[:, 8:24]), d, m, 32


def _extract_q2_k(b):
    nb = b.shape[0]
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = Q._f16(b[:, 80:82])
    dmin = Q._f16(b[:, 82:84])
    q = np.empty((nb, 256), np.uint8)
    a = np.empty((nb, 16), np.float32)
    bb = np.empty((nb, 16), np.float32)
    for half in range(2):
        blkq = qs[:, 32 * half:32 * half + 32]
        for shift_i in range(4):
            qv = (blkq >> (2 * shift_i)) & 3
            for sub in range(2):
                is_ = 8 * half + sub + 2 * shift_i
                gidx = (128 * half + 32 * shift_i + 16 * sub) // 16
                q[:, 16 * gidx:16 * gidx + 16] = qv[:, 16 * sub:16 * sub + 16]
                a[:, gidx] = d[:, 0] * (scales[:, is_] & 0xF)
                bb[:, gidx] = -dmin[:, 0] * (scales[:, is_] >> 4).astype(np.float32)
    return q, a, bb, 16


def _extract_q3_k(b):
    nb = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    us = Q.q3_k_scales(b[:, 96:108]).astype(np.float32)
    d = Q._f16(b[:, 108:110])
    q = np.empty((nb, 256), np.int8)
    a = np.empty((nb, 16), np.float32)
    for half in range(2):
        blkq = qs[:, 32 * half:32 * half + 32]
        for j in range(4):
            m = np.uint8(1 << (4 * half + j))
            qv = ((blkq >> (2 * j)) & 3).astype(np.int8)
            qv = qv - np.where((hmask & m) != 0, 0, 4).astype(np.int8)
            for sub in range(2):
                is_ = 8 * half + 2 * j + sub
                gidx = (128 * half + 32 * j + 16 * sub) // 16
                q[:, 16 * gidx:16 * gidx + 16] = qv[:, 16 * sub:16 * sub + 16]
                a[:, gidx] = d[:, 0] * (us[:, is_] - 32)
    return q, a, None, 16


def _extract_iq4_nl(b):
    d = Q._f16(b[:, 0:2])
    qs = b[:, 2:18]
    idx = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int64)
    return Q.KVALUES_IQ4NL[idx], d, None, 32


def _extract_iq4_xs(b):
    nb = b.shape[0]
    qs = b[:, 8:136].reshape(nb, 8, 16)
    q = np.concatenate([Q.KVALUES_IQ4NL[(qs & 0xF).astype(np.int64)],
                        Q.KVALUES_IQ4NL[(qs >> 4).astype(np.int64)]], axis=2)
    return q.reshape(nb, 256), Q.iq4_xs_scales(b), None, 32


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


def _extract_via_dequant_grid(name):
    """The grid types but IQ1_M: q = grid * sign int8 codes, a (and IQ1_S's
    bias) from the scale structure. (q, a, b) come from the dequantizer's
    floats rather than from the bit plumbing again: y = a*q + b with a > 0
    a group and q integral, so q = rint((y - b) / a) is exact for these
    ranges (the reference's arithmetic, dtypes included: IQ1_S's bias and
    y - b in f64)."""
    spec = Q.TYPE_BY_NAME[name]

    def extract(b):
        nb = b.shape[0]
        y = spec.dequant(b)                              # (nb, 256) = a*q + b
        if name in ("IQ2_XXS", "IQ3_XXS"):
            g = 32
            if name == "IQ2_XXS":
                d = Q._f16(b[:, 0:2])[:, 0]
                q2 = Q._u16(b[:, 2:66]).reshape(nb, 8, 4)
                aux32 = (q2[:, :, 2].astype(np.uint32)
                         | (q2[:, :, 3].astype(np.uint32) << 16))
                a = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25
            else:
                d = Q._f16(b[:, 0:2])[:, 0]
                aux32 = Q._u32(b[:, 66:98]).reshape(nb, 8)
                a = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.5
            bias = None
        elif name in ("IQ2_XS", "IQ2_S"):
            g = 16
            d = Q._f16(b[:, 0:2])[:, 0]
            scales = b[:, 66:74] if name == "IQ2_XS" else b[:, 74:82]
            sc = np.stack([scales & 0xF, scales >> 4], axis=-1).astype(np.float32)
            a = (d[:, None, None] * (0.5 + sc) * 0.25).reshape(nb, 16)
            bias = None
        elif name == "IQ3_S":
            g = 32
            d = Q._f16(b[:, 0:2])[:, 0]
            scales = b[:, 106:110]
            ls = np.stack([scales & 0xF, scales >> 4], axis=-1).reshape(nb, 8)
            a = d[:, None] * (1 + 2 * ls.astype(np.float32))
            bias = None
        elif name == "IQ1_S":
            g = 32
            d = Q._f16(b[:, 0:2])[:, 0]
            qh = Q._u16(b[:, 34:50]).reshape(nb, 8)
            a = d[:, None] * (2 * ((qh >> 12) & 7).astype(np.float32) + 1)
            delta = np.where((qh & 0x8000) != 0, -Q.IQ1S_DELTA, Q.IQ1S_DELTA)
            bias = (a * delta).astype(np.float32)
        else:
            raise NotImplementedError(name)
        a_full = np.repeat(a, g, axis=1)
        b_full = np.repeat(bias, g, axis=1) if bias is not None else 0.0
        q = np.rint((y - b_full) / np.where(a_full == 0, 1, a_full))
        q = np.where(a_full == 0, 0, q)
        if not np.abs(q).max() <= 127:          # NaN too: a non-finite d
            raise ValueError(f"{name}: codes outside int8 (a malformed block)")
        return q.astype(np.int8), a.astype(np.float32), bias, g

    return extract


def _extract_iq1_m(b):
    """IQ1_M decomposes exactly at g = 8: y = dl * (grid + delta) = a*q +
    bias with a = dl, q = grid (-1, 0 or 1), bias = dl * delta."""
    n = b.shape[0]
    grid, dl, delta = Q.iq1_m_parts(b)
    q = grid.reshape(n, 256).astype(np.int8)
    a = dl.reshape(n, 32).astype(np.float32)
    bias = (dl * delta).reshape(n, 32).astype(np.float32)
    return q, a, bias, 8


_EXTRACTORS = {"Q4_0": _extract_q4_0, "Q4_1": _extract_q4_1,
               "Q5_0": _extract_q5_0, "Q5_1": _extract_q5_1, "Q8_0": _extract_q8_0,
               "Q2_K": _extract_q2_k, "Q3_K": _extract_q3_k, "Q4_K": _extract_q4_k,
               "Q5_K": _extract_q5_k, "Q6_K": _extract_q6_k,
               "IQ4_NL": _extract_iq4_nl, "IQ4_XS": _extract_iq4_xs,
               **{name: _extract_via_dequant_grid(name) for name in (
                   "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S")},
               "IQ1_M": _extract_iq1_m}

# formats packed to 4-bit nibbles on the device when K % 256 == 0 (q4b);
# the others, and these at other K, stay int8 codes (q8b)
_NIBBLE_FORMATS = {"Q4_0", "Q4_1", "Q4_K"}


def repack_numpy(raw: np.ndarray, type_name: str, shape: tuple, native: bool = True):
    """Raw block bytes -> (kind, qs, scales, bias, g) numpy arrays, unpadded.

    shape = (N, K) with K contiguous (GGML weight W[N, K], y = x @ W.T).
    Types with no extractor (the float and integer types, Q8_K) load dense.
    With native, the formats the native repacker takes go through it
    (native.native_repack, byte-identical to the numpy path below).
    """
    Q.check_supported(type_name)
    n, k = int(np.prod(shape[:-1])), shape[-1]
    spec = Q.TYPE_BY_NAME[type_name]
    if type_name not in _EXTRACTORS:
        w = Q.dequantize(raw, spec.type_id, (n, k))
        return "dense", np.ascontiguousarray(w.T), None, None, 0
    if native:
        from ..native import native_repack
        out = native_repack(raw, type_name, n, k)
        if out is not None:
            return out
    nblocks = n * k // spec.block_elems
    blocks = (np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray)
              else raw).reshape(nblocks, spec.block_bytes)
    q, a, b, g = _EXTRACTORS[type_name](blocks)
    qT = np.ascontiguousarray(q.reshape(n, k).T)                  # (K, N)
    a = np.ascontiguousarray(a.reshape(n, k // g).T, dtype=np.float32)
    if b is not None:
        b = np.ascontiguousarray(b.reshape(n, k // g).T, dtype=np.float32)
    if type_name in _NIBBLE_FORMATS and k % 256 == 0:
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


def slice_qtensor_cols(qt: QTensor, a: int, b: int) -> QTensor:
    """The exact column slice [a, b) of the logical N axis (storage axis
    -1), a copy: splits a pre-fused projection without requantizing."""
    cut = lambda t: None if t is None else t[..., a:b].contiguous()
    return QTensor(qt.kind, (b - a, qt.shape[1]), qt.g, cut(qt.qs), cut(qt.scales),
                   cut(qt.bias))


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
