"""GGML block-format registry and the host dequantizers this port loads.

Own copy of llamafile_tpu/gguf/quants.py's dequantization: the full type
table (so a reader can size every tensor of a file), and dequantization for
F32, F16, BF16, F64, I8, I16, I32, I64, Q8_0, Q8_K, Q4_K, Q5_K and Q6_K
(the formats of Q8_0, Q4_K_M, Q4_K_S and Q5_K_M llama files: Q4_K_M and
Q5_K_M mix their main format with Q6_K layers and head; Q4_K_S mixes Q4_K
and Q5_K), the classic 32-element formats Q4_0, Q4_1, Q5_0 and Q5_1, the
small K-quants Q2_K and Q3_K, the non-linear IQ4_NL and IQ4_XS (with their
KVALUES_IQ4NL table) and the grid IQ types IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S, IQ1_S and IQ1_M (their codebooks in iq_grids.npz, a copy
of the reference's). Q8_1, which the reference cannot dequantize either,
raises NotImplementedError naming the type.

Dequantizers take raw little-endian block bytes shaped (nblocks, block_bytes)
as uint8 and return float32 (nblocks, block_elems); layouts follow
ggml-common.h. The grid types keep the reference's float32 operation order
exactly: ops/repack.py recovers their integer codes from these floats.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

QK = 32       # simple-quant block size
QK_K = 256    # K-quant superblock size

# IQ4_NL / IQ4_XS non-linear 4-bit codebook (ggml-common.h kvalues_iq4nl)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)

_GRIDS: Optional[dict] = None


def _grids() -> dict:
    """The IQ codebooks (iq_grids.npz beside this module), loaded once."""
    global _GRIDS
    if _GRIDS is None:
        with np.load(os.path.join(os.path.dirname(__file__), "iq_grids.npz")) as z:
            _GRIDS = dict(z)
    return _GRIDS


def _f16(u8pair: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as float16 -> float32."""
    return np.ascontiguousarray(u8pair).view(np.float16).astype(np.float32)


def _u16(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.uint16)


def _u32(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.uint32)


def dequant_q4_0(b: np.ndarray) -> np.ndarray:
    # block: half d; uint8 qs[16]; w[j] = d*((qs[j]&0xF)-8), w[j+16] = d*((qs[j]>>4)-8)
    d = _f16(b[:, 0:2])                      # (n,1)
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32)


def dequant_q4_1(b: np.ndarray) -> np.ndarray:
    # block: half d; half m; uint8 qs[16]
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return d * np.concatenate([lo, hi], axis=1) + m


def _q5_high(qh: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The fifth bits of a Q5_0/Q5_1 block's 32 codes, as 0 or 16: bit j
    of qh for element j, bit j + 16 for element j + 16."""
    j = np.arange(16, dtype=np.uint32)
    return (((qh >> j) & 1).astype(np.uint8) << 4,
            ((qh >> (j + 16)) & 1).astype(np.uint8) << 4)


def dequant_q5_0(b: np.ndarray) -> np.ndarray:
    # block: half d; uint32 qh; uint8 qs[16]
    d = _f16(b[:, 0:2])
    hlo, hhi = _q5_high(_u32(b[:, 2:6]).reshape(-1, 1))
    qs = b[:, 6:22]
    lo = ((qs & 0x0F) | hlo).astype(np.int16) - 16
    hi = ((qs >> 4) | hhi).astype(np.int16) - 16
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32)


def dequant_q5_1(b: np.ndarray) -> np.ndarray:
    # block: half d; half m; uint32 qh; uint8 qs[16]
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    hlo, hhi = _q5_high(_u32(b[:, 4:8]).reshape(-1, 1))
    qs = b[:, 8:24]
    lo = ((qs & 0x0F) | hlo).astype(np.float32)
    hi = ((qs >> 4) | hhi).astype(np.float32)
    return d * np.concatenate([lo, hi], axis=1) + m


def dequant_q2_k(b: np.ndarray) -> np.ndarray:
    # block: uint8 scales[16]; uint8 qs[64]; half d; half dmin
    n = b.shape[0]
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    y = np.empty((n, QK_K), dtype=np.float32)
    for half in range(2):               # elements 128 * half ...
        q = qs[:, 32 * half:32 * half + 32]
        for shift_i in range(4):        # rows of 32 within the half
            qv = ((q >> (2 * shift_i)) & 3).astype(np.float32)
            for sub in range(2):        # 16-element sub-blocks, a scale each
                is_ = 8 * half + sub + 2 * shift_i
                sc = scales[:, is_:is_ + 1]
                dl = d * (sc & 0xF).astype(np.float32)
                ml = dmin * (sc >> 4).astype(np.float32)
                cols = slice(128 * half + 32 * shift_i + 16 * sub,
                             128 * half + 32 * shift_i + 16 * sub + 16)
                y[:, cols] = dl * qv[:, 16 * sub:16 * sub + 16] - ml
    return y


def q3_k_scales(scales: np.ndarray) -> np.ndarray:
    """A Q3_K block's 12 scale bytes -> its 16 6-bit scales, raw 0..63
    (the -32 offset is the caller's)."""
    n = scales.shape[0]
    us = np.empty((n, 16), dtype=np.int8)
    s = scales.astype(np.uint8)
    for is_ in range(16):
        if is_ < 4:
            v = (s[:, is_] & 0xF) | (((s[:, is_ + 8] >> 0) & 3) << 4)
        elif is_ < 8:
            v = (s[:, is_] & 0xF) | (((s[:, is_ + 4] >> 2) & 3) << 4)
        elif is_ < 12:
            v = (s[:, is_ - 8] >> 4) | (((s[:, is_] >> 4) & 3) << 4)
        else:
            v = (s[:, is_ - 8] >> 4) | (((s[:, is_ - 4] >> 6) & 3) << 4)
        us[:, is_] = v.astype(np.int8)
    return us


def dequant_q3_k(b: np.ndarray) -> np.ndarray:
    # block: uint8 hmask[32]; uint8 qs[64]; uint8 scales[12]; half d
    n = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    us = q3_k_scales(b[:, 96:108])
    d = _f16(b[:, 108:110])
    y = np.empty((n, QK_K), dtype=np.float32)
    for half in range(2):
        q = qs[:, 32 * half:32 * half + 32]
        for j in range(4):
            m = np.uint8(1 << (4 * half + j))
            qv = ((q >> (2 * j)) & 3).astype(np.int8)
            # the high bit of code l is bit 4 * half + j of hmask[l]: clear -> -4
            qv = qv - np.where((hmask & m) != 0, 0, 4).astype(np.int8)
            for sub in range(2):
                is_ = 8 * half + 2 * j + sub
                dl = d[:, 0] * (us[:, is_].astype(np.float32) - 32)
                cols = slice(128 * half + 32 * j + 16 * sub,
                             128 * half + 32 * j + 16 * sub + 16)
                y[:, cols] = dl[:, None] * qv[:, 16 * sub:16 * sub + 16].astype(np.float32)
    return y


def dequant_q8_k(b: np.ndarray) -> np.ndarray:
    # block: float d; int8 qs[256]; int16 bsums[16]
    d = _u32(b[:, 0:4]).view(np.float32)
    qs = b[:, 4:260].view(np.int8)
    return d * qs.astype(np.float32)


def _signs_from_ksigns(idx: np.ndarray) -> np.ndarray:
    """ksigns index (n,g) -> sign multipliers (n,g,8) of ±1 float32."""
    ks = _grids()["ksigns_iq2xs"][idx]          # (n,g) uint8
    bits = (ks[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits == 1, -1.0, 1.0).astype(np.float32)


def _signs_from_bytes(sb: np.ndarray) -> np.ndarray:
    bits = (sb[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits == 1, -1.0, 1.0).astype(np.float32)


def dequant_iq2_xxs(b: np.ndarray) -> np.ndarray:
    # block: half d; uint16 qs[32]  (per 32 elems: 4 grid-index bytes + u32 signs/scale)
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    q2 = _u16(b[:, 2:66]).reshape(n, 8, 4)       # (n, ib32, 4 u16)
    aux8 = np.ascontiguousarray(q2[:, :, 0:2]).view(np.uint8).reshape(n, 8, 4)
    aux32 = (q2[:, :, 2].astype(np.uint32) | (q2[:, :, 3].astype(np.uint32) << 16))
    db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25   # (n,8)
    grid = _grids()["iq2xxs_grid"][aux8]         # (n,8,4,8) uint8
    signs = _signs_from_ksigns(
        ((aux32[..., None] >> (7 * np.arange(4, dtype=np.uint32))) & 127).astype(np.int64)
    )                                            # (n,8,4,8)
    y = db[:, :, None, None] * grid.astype(np.float32) * signs
    return y.reshape(n, QK_K)


def dequant_iq2_xs(b: np.ndarray) -> np.ndarray:
    # block: half d; uint16 qs[32]; uint8 scales[8]
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    q2 = _u16(b[:, 2:66]).reshape(n, 8, 4)
    scales = b[:, 66:74]
    grid = _grids()["iq2xs_grid"][(q2 & 511).astype(np.int64)]     # (n,8,4,8)
    signs = _signs_from_ksigns((q2 >> 9).astype(np.int64))
    sc = np.stack([scales & 0xF, scales >> 4], axis=-1).astype(np.float32)  # (n,8,2)
    db = d[:, None, None] * (0.5 + sc) * 0.25                       # (n,8,2)
    db4 = np.repeat(db, 2, axis=2)                                  # (n,8,4) il/2
    y = db4[..., None] * grid.astype(np.float32) * signs
    return y.reshape(n, QK_K)


def dequant_iq2_s(b: np.ndarray) -> np.ndarray:
    # block: half d; uint8 qs[64]; uint8 qh[8]; uint8 scales[8]
    # qs[0:32] grid low bytes, qs[32:64] sign bytes
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    qs = b[:, 2:34].reshape(n, 8, 4)
    sgn = b[:, 34:66].reshape(n, 8, 4)
    qh = b[:, 66:74]
    scales = b[:, 74:82]
    il = np.arange(4)
    gidx = qs.astype(np.int64) | (
        ((qh[:, :, None].astype(np.int64) << (8 - 2 * il)) & 0x300)
    )
    grid = _grids()["iq2s_grid"][gidx]
    signs = _signs_from_bytes(sgn)
    sc = np.stack([scales & 0xF, scales >> 4], axis=-1).astype(np.float32)
    db4 = np.repeat(d[:, None, None] * (0.5 + sc) * 0.25, 2, axis=2)
    y = db4[..., None] * grid.astype(np.float32) * signs
    return y.reshape(n, QK_K)


def dequant_iq3_xxs(b: np.ndarray) -> np.ndarray:
    # block: half d; uint8 qs[96]  (64 grid bytes + 32 bytes of sign/scale u32 per ib32)
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    q3 = b[:, 2:66].reshape(n, 8, 8)             # 8 grid indices per 32 elems
    aux32 = _u32(b[:, 66:98]).reshape(n, 8)
    db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.5
    grid = _grids()["iq3xxs_grid"][q3.astype(np.int64)]      # (n,8,8,4)
    signs = _signs_from_ksigns(
        ((aux32[..., None] >> (7 * np.arange(4, dtype=np.uint32))) & 127).astype(np.int64)
    )                                            # (n,8,4,8)
    vals = grid.astype(np.float32).reshape(n, 8, 4, 8)       # 2 grids of 4 per sign grp
    y = db[:, :, None, None] * vals * signs
    return y.reshape(n, QK_K)


def dequant_iq3_s(b: np.ndarray) -> np.ndarray:
    # block: half d; uint8 qs[64]; uint8 qh[8]; uint8 signs[32]; uint8 scales[4]
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    qs = b[:, 2:66].reshape(n, 8, 8)
    qh = b[:, 66:74]
    sgn = b[:, 74:106].reshape(n, 8, 4)
    scales = b[:, 106:110]
    j = np.arange(8)
    gidx = qs.astype(np.int64) | (((qh[:, :, None].astype(np.int64) << (8 - j)) & 256))
    grid = _grids()["iq3s_grid"][gidx]           # (n,8,8,4)
    signs = _signs_from_bytes(sgn)               # (n,8,4,8)
    ls = np.stack([scales & 0xF, scales >> 4], axis=-1).reshape(n, 8)  # per ib32
    db = d[:, None] * (1 + 2 * ls.astype(np.float32))
    vals = grid.astype(np.float32).reshape(n, 8, 4, 8)
    y = db[:, :, None, None] * vals * signs
    return y.reshape(n, QK_K)


IQ1S_DELTA = 0.125


def dequant_iq1_s(b: np.ndarray) -> np.ndarray:
    # block: half d; uint8 qs[32]; uint16 qh[8]
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    qs = b[:, 2:34].reshape(n, 8, 4)
    qh = _u16(b[:, 34:50]).reshape(n, 8)
    il = np.arange(4)
    gidx = qs.astype(np.int64) | (
        (((qh[:, :, None].astype(np.int64) >> (3 * il)) & 7) << 8)
    )
    grid = _grids()["iq1s_grid"][gidx].astype(np.float32)    # (n,8,4,8)
    dl = d[:, None] * (2 * ((qh >> 12) & 7).astype(np.float32) + 1)
    delta = np.where((qh & 0x8000) != 0, -IQ1S_DELTA, IQ1S_DELTA).astype(np.float32)
    y = dl[:, :, None, None] * (grid + delta[:, :, None, None])
    return y.reshape(n, QK_K)


IQ1M_DELTA = 0.125


def iq1_m_parts(b: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IQ1_M blocks -> (grid codes int8 (nblocks, 8, 4, 8) in -1..1, per-8
    scales dl f32 (nblocks, 8, 4), deltas +-IQ1M_DELTA f32 (nblocks, 8, 4));
    element j of 8-group g is dl[g] * (grid[g, j] + delta[g])."""
    # block: uint8 qs[32]; uint8 qh[16]; uint8 scales[8] — d is hidden in scales nibbles
    n = b.shape[0]
    qs = b[:, 0:32].reshape(n, 8, 4)
    qh = b[:, 32:48].reshape(n, 8, 2)            # per ib32: 2 bytes, nibble per il-pair
    sc16 = _u16(b[:, 48:56]).reshape(n, 4)
    d = ((sc16[:, 0] >> 12) | ((sc16[:, 1] >> 8) & 0x00F0)
         | ((sc16[:, 2] >> 4) & 0x0F00) | (sc16[:, 3] & 0xF000)).astype(np.uint16)
    d = d[:, None].view(np.float16).astype(np.float32)[:, 0]
    il = np.arange(4)
    qh4 = qh[:, :, il // 2]                      # (n,8,4)
    hbits = (qh4.astype(np.int64) >> (4 * (il % 2))) & 0xF
    gidx = qs.astype(np.int64) | ((hbits & 7) << 8)
    grid = _grids()["iq1s_grid"][gidx]
    # scale: ib16 = 2*ib + il/2; sc[ib16/4] >> 3*(ib16%4) & 7
    ib = np.arange(8)
    ib16 = 2 * ib[:, None] + il[None, :] // 2    # (8,4)
    sl = (sc16[:, ib16 // 4] >> (3 * (ib16 % 4)).astype(np.uint16)) & 7   # (n,8,4)
    dl = d[:, None, None] * (2 * sl.astype(np.float32) + 1)
    delta = np.where((hbits & 8) != 0, -IQ1M_DELTA, IQ1M_DELTA).astype(np.float32)
    return grid, dl, delta


def dequant_iq1_m(b: np.ndarray) -> np.ndarray:
    grid, dl, delta = iq1_m_parts(b)
    y = dl[..., None] * (grid.astype(np.float32) + delta[..., None])
    return y.reshape(b.shape[0], QK_K)


def dequant_iq4_nl(b: np.ndarray) -> np.ndarray:
    # block (32 elems): half d; uint8 qs[16]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    lo = KVALUES_IQ4NL[(qs & 0xF).astype(np.int64)].astype(np.float32)
    hi = KVALUES_IQ4NL[(qs >> 4).astype(np.int64)].astype(np.float32)
    return d * np.concatenate([lo, hi], axis=1)


def iq4_xs_scales(b: np.ndarray) -> np.ndarray:
    """An IQ4_XS block's 8 sub-block scales, d times the 6-bit scale - 32,
    f32 (nblocks, 8)."""
    n = b.shape[0]
    d = _f16(b[:, 0:2])[:, 0]
    scales_h = _u16(b[:, 2:4]).reshape(n)
    scales_l = b[:, 4:8]
    ib = np.arange(8)
    ls = (((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF).astype(np.int32)
          | (((scales_h[:, None].astype(np.int32) >> (2 * ib)) & 3) << 4)) - 32
    return d[:, None] * ls.astype(np.float32)


def dequant_iq4_xs(b: np.ndarray) -> np.ndarray:
    # block: half d; uint16 scales_h; uint8 scales_l[4]; uint8 qs[128]
    n = b.shape[0]
    dl = iq4_xs_scales(b)                         # (n,8)
    qs = b[:, 8:136].reshape(n, 8, 16)
    lo = KVALUES_IQ4NL[(qs & 0xF).astype(np.int64)].astype(np.float32)
    hi = KVALUES_IQ4NL[(qs >> 4).astype(np.int64)].astype(np.float32)
    y = dl[:, :, None] * np.concatenate([lo, hi], axis=2)    # (n,8,32)
    return y.reshape(n, QK_K)


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
    QuantSpec("Q4_0", 2, QK, 18, dequant_q4_0),
    QuantSpec("Q4_1", 3, QK, 20, dequant_q4_1),
    QuantSpec("Q5_0", 6, QK, 22, dequant_q5_0),
    QuantSpec("Q5_1", 7, QK, 24, dequant_q5_1),
    QuantSpec("Q8_0", 8, QK, 34, dequant_q8_0),
    QuantSpec("Q8_1", 9, QK, 36),
    QuantSpec("Q2_K", 10, QK_K, 84, dequant_q2_k),
    QuantSpec("Q3_K", 11, QK_K, 110, dequant_q3_k),
    QuantSpec("Q4_K", 12, QK_K, 144, dequant_q4_k),
    QuantSpec("Q5_K", 13, QK_K, 176, dequant_q5_k),
    QuantSpec("Q6_K", 14, QK_K, 210, dequant_q6_k),
    QuantSpec("Q8_K", 15, QK_K, 292, dequant_q8_k),
    QuantSpec("IQ2_XXS", 16, QK_K, 66, dequant_iq2_xxs),
    QuantSpec("IQ2_XS", 17, QK_K, 74, dequant_iq2_xs),
    QuantSpec("IQ3_XXS", 18, QK_K, 98, dequant_iq3_xxs),
    QuantSpec("IQ1_S", 19, QK_K, 50, dequant_iq1_s),
    QuantSpec("IQ4_NL", 20, QK, 18, dequant_iq4_nl),
    QuantSpec("IQ3_S", 21, QK_K, 110, dequant_iq3_s),
    QuantSpec("IQ2_S", 22, QK_K, 82, dequant_iq2_s),
    QuantSpec("IQ4_XS", 23, QK_K, 136, dequant_iq4_xs),
    QuantSpec("I8", 24, 1, 1),
    QuantSpec("I16", 25, 1, 2),
    QuantSpec("I32", 26, 1, 4),
    QuantSpec("I64", 27, 1, 8),
    QuantSpec("F64", 28, 1, 8),
    QuantSpec("IQ1_M", 29, QK_K, 56, dequant_iq1_m),
    QuantSpec("BF16", 30, 1, 2),
]

TYPE_BY_ID: Dict[int, QuantSpec] = {s.type_id: s for s in GGML_TYPES}
TYPE_BY_NAME: Dict[str, QuantSpec] = {s.name: s for s in GGML_TYPES}

# formats the port loads (every type but Q8_1); anything else raises
# NotImplementedError
DENSE_INTS = {"I8": np.int8, "I16": np.int16, "I32": np.int32, "I64": np.int64}
SUPPORTED = ("F32", "F16", "BF16", "F64", *DENSE_INTS, *(
    s.name for s in GGML_TYPES if s.dequant is not None))


def check_supported(type_name: str) -> None:
    if type_name not in SUPPORTED:
        raise NotImplementedError(
            f"GGML type {type_name} has no dequantizer (the reference has none "
            f"either): the port loads {', '.join(SUPPORTED)}")


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
    if spec.name == "F64":
        return raw[: n * 8].view(np.float64).reshape(shape).astype(np.float32)
    if spec.name in DENSE_INTS:
        dt = DENSE_INTS[spec.name]
        return raw[: n * np.dtype(dt).itemsize].view(dt).reshape(shape).astype(np.float32)
    nblocks = n // spec.block_elems
    blocks = raw[: nblocks * spec.block_bytes].reshape(nblocks, spec.block_bytes)
    return spec.dequant(blocks).reshape(shape)
