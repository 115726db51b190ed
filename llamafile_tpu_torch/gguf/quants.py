"""GGML block-format registry and the host dequantizers this port loads.

Own copy of the parts of llamafile_tpu/gguf/quants.py that the port loads:
the full type table (so a reader can size every tensor of a file), and
dequantization for F32, F16, BF16, Q8_0, Q4_K, Q5_K and Q6_K: the formats
of Q8_0, Q4_K_M, Q4_K_S and Q5_K_M llama files (Q4_K_M and Q5_K_M mix
their main format with Q6_K layers and head; Q4_K_S mixes Q4_K and Q5_K).
Every other format raises NotImplementedError naming the type.

Dequantizers take raw little-endian block bytes shaped (nblocks, block_bytes)
as uint8 and return float32 (nblocks, block_elems); layouts follow
ggml-common.h.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

QK = 32       # simple-quant block size
QK_K = 256    # K-quant superblock size


def _f16(u8pair: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as float16 -> float32."""
    return np.ascontiguousarray(u8pair).view(np.float16).astype(np.float32)


def _scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 12-byte K-quant scales into 8 (scale, min) 6-bit pairs
    (get_scale_min_k4 of the ggml reference)."""
    n = scales.shape[0]
    sc = np.empty((n, 8), dtype=np.float32)
    mn = np.empty((n, 8), dtype=np.float32)
    q = scales
    for j in range(8):
        if j < 4:
            sc[:, j] = (q[:, j] & 63).astype(np.float32)
            mn[:, j] = (q[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)).astype(np.float32)
            mn[:, j] = ((q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def dequant_q8_0(b: np.ndarray) -> np.ndarray:
    # block: half d; int8 qs[32]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].view(np.int8)
    return d * qs.astype(np.float32)


def dequant_q4_k(b: np.ndarray) -> np.ndarray:
    # block: half d; half dmin; uint8 scales[12]; uint8 qs[128]
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    dmin = _f16(b[:, 2:4])[:, 0]
    sc, mn = _scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144]
    y = np.empty((n, QK_K), dtype=np.float32)
    for blk in range(4):                 # 64-element chunks, each with 2 sub-scales
        q = qs[:, 32 * blk:32 * blk + 32]
        d1 = (d * sc[:, 2 * blk])[:, None]
        m1 = (dmin * mn[:, 2 * blk])[:, None]
        d2 = (d * sc[:, 2 * blk + 1])[:, None]
        m2 = (dmin * mn[:, 2 * blk + 1])[:, None]
        y[:, 64 * blk:64 * blk + 32] = d1 * (q & 0xF).astype(np.float32) - m1
        y[:, 64 * blk + 32:64 * blk + 64] = d2 * (q >> 4).astype(np.float32) - m2
    return y


def q5_k_codes(b: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Q5_K blocks -> (codes uint8 (nblocks, 256) in 0..31, per-32 scales
    d * sc and offsets -dmin * mn, f32 (nblocks, 8)); element i of a block
    is codes[i] * a[i // 32] + b[i // 32]."""
    # block: half d; half dmin; uint8 scales[12]; uint8 qh[32]; uint8 qs[128]
    d = _f16(b[:, 0:2])[:, 0]
    dmin = _f16(b[:, 2:4])[:, 0]
    sc, mn = _scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    q = np.empty((b.shape[0], QK_K), np.uint8)
    for blk in range(4):                 # 64-element chunks, two 32-groups each
        g = qs[:, 32 * blk:32 * blk + 32]
        q[:, 64 * blk:64 * blk + 32] = (g & 0xF) | (((qh >> (2 * blk)) & 1) << 4)
        q[:, 64 * blk + 32:64 * blk + 64] = (g >> 4) | (((qh >> (2 * blk + 1)) & 1) << 4)
    return q, d[:, None] * sc, -dmin[:, None] * mn


def dequant_q5_k(b: np.ndarray) -> np.ndarray:
    q, a, m = q5_k_codes(b)
    n = b.shape[0]
    return (a[:, :, None] * q.reshape(n, 8, 32).astype(np.float32)
            + m[:, :, None]).reshape(n, QK_K)


def q6_k_codes(b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q6_K blocks -> (codes int8 (nblocks, 256) in -32..31, per-16 scales
    d * scale f32 (nblocks, 16)); element i of a block is codes[i] * a[i // 16]."""
    # block: uint8 ql[128]; uint8 qh[64]; int8 scales[16]; half d
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16(b[:, 208:210])[:, 0]
    q = np.empty((b.shape[0], QK_K), np.int8)
    for half in range(2):                # 128-element halves
        lq = ql[:, 64 * half:64 * half + 64]
        hq = qh[:, 32 * half:32 * half + 32]
        # l in 0..32 -> 4 output rows at offsets 0,32,64,96 within the half
        rows = ((lq[:, 0:32] & 0xF) | (((hq >> 0) & 3) << 4),
                (lq[:, 32:64] & 0xF) | (((hq >> 2) & 3) << 4),
                (lq[:, 0:32] >> 4) | (((hq >> 4) & 3) << 4),
                (lq[:, 32:64] >> 4) | (((hq >> 6) & 3) << 4))
        for row, r in enumerate(rows):
            q[:, 128 * half + 32 * row:128 * half + 32 * row + 32] = r.astype(np.int16) - 32
    return q, d[:, None] * scales


def dequant_q6_k(b: np.ndarray) -> np.ndarray:
    q, a = q6_k_codes(b)
    n = b.shape[0]
    return (a[:, :, None] * q.reshape(n, 16, 16).astype(np.float32)).reshape(n, QK_K)


@dataclass(frozen=True)
class QuantSpec:
    name: str
    type_id: int
    block_elems: int
    block_bytes: int
    dequant: Optional[Callable[[np.ndarray], np.ndarray]] = None


GGML_TYPES = [
    QuantSpec("F32", 0, 1, 4),
    QuantSpec("F16", 1, 1, 2),
    QuantSpec("Q4_0", 2, QK, 18),
    QuantSpec("Q4_1", 3, QK, 20),
    QuantSpec("Q5_0", 6, QK, 22),
    QuantSpec("Q5_1", 7, QK, 24),
    QuantSpec("Q8_0", 8, QK, 34, dequant_q8_0),
    QuantSpec("Q8_1", 9, QK, 36),
    QuantSpec("Q2_K", 10, QK_K, 84),
    QuantSpec("Q3_K", 11, QK_K, 110),
    QuantSpec("Q4_K", 12, QK_K, 144, dequant_q4_k),
    QuantSpec("Q5_K", 13, QK_K, 176, dequant_q5_k),
    QuantSpec("Q6_K", 14, QK_K, 210, dequant_q6_k),
    QuantSpec("Q8_K", 15, QK_K, 292),
    QuantSpec("IQ2_XXS", 16, QK_K, 66),
    QuantSpec("IQ2_XS", 17, QK_K, 74),
    QuantSpec("IQ3_XXS", 18, QK_K, 98),
    QuantSpec("IQ1_S", 19, QK_K, 50),
    QuantSpec("IQ4_NL", 20, QK, 18),
    QuantSpec("IQ3_S", 21, QK_K, 110),
    QuantSpec("IQ2_S", 22, QK_K, 82),
    QuantSpec("IQ4_XS", 23, QK_K, 136),
    QuantSpec("I8", 24, 1, 1),
    QuantSpec("I16", 25, 1, 2),
    QuantSpec("I32", 26, 1, 4),
    QuantSpec("I64", 27, 1, 8),
    QuantSpec("F64", 28, 1, 8),
    QuantSpec("IQ1_M", 29, QK_K, 56),
    QuantSpec("BF16", 30, 1, 2),
]

TYPE_BY_ID: Dict[int, QuantSpec] = {s.type_id: s for s in GGML_TYPES}
TYPE_BY_NAME: Dict[str, QuantSpec] = {s.name: s for s in GGML_TYPES}

# formats the port loads; anything else raises NotImplementedError
SUPPORTED = ("F32", "F16", "BF16", "Q8_0", "Q4_K", "Q5_K", "Q6_K")


def check_supported(type_name: str) -> None:
    if type_name not in SUPPORTED:
        raise NotImplementedError(
            f"GGML type {type_name} is not ported yet: the port loads "
            f"{', '.join(SUPPORTED)} only")


def type_size(n_elems: int, spec: QuantSpec) -> int:
    if n_elems % spec.block_elems:
        raise ValueError(f"{n_elems} elements is not a whole number of "
                         f"{spec.name} blocks")
    return n_elems // spec.block_elems * spec.block_bytes


def dequantize(raw: np.ndarray, type_id: int, shape: tuple) -> np.ndarray:
    """Dequantize raw tensor bytes to float32 with the given logical shape
    (numpy order: the contiguous dim last; blocks run along it)."""
    spec = TYPE_BY_ID[type_id]
    check_supported(spec.name)
    n = int(np.prod(shape))
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    raw = raw.reshape(-1)
    if spec.name == "F32":
        return raw[: n * 4].view(np.float32).reshape(shape).astype(np.float32)
    if spec.name == "F16":
        return raw[: n * 2].view(np.float16).reshape(shape).astype(np.float32)
    if spec.name == "BF16":
        u = raw[: n * 2].view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32).reshape(shape)
    nblocks = n // spec.block_elems
    blocks = raw[: nblocks * spec.block_bytes].reshape(nblocks, spec.block_bytes)
    return spec.dequant(blocks).reshape(shape)
