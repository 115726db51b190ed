"""GGUF v3 writer of the port, and the page-aligned ZIP packer.

The port's own copy of llamafile_tpu/gguf/writer.py (no quantizer comes with
it: a tensor is added from its raw block bytes, or as f32 / f16): the same
calls write the same bytes. Metadata takes every GGUF value type (the
reference's writer infers bool, u32 / i64, f32, str and arrays, and takes
u64 and i32 when asked; this one also u8, i8, u16, i16 and f64), tensor data
is aligned to 32 bytes, and `write` streams the tensors to the file instead
of assembling it in memory, so a full-width model needs no second copy.
`pack_zip` stores members uncompressed with their data page-aligned, ZIP64
past 4 GiB (the reference's zipalign analog).
"""
from __future__ import annotations

import os
import struct
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .quants import TYPE_BY_NAME, type_size

GGUF_MAGIC = 0x46554747
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

ALIGNMENT = 32
_ZIP64_THRESHOLD = 0xFFFFFFFF

# struct codes of the scalar value types
_SCALAR = {T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h", T_U32: "<I", T_I32: "<i",
           T_F32: "<f", T_U64: "<Q", T_I64: "<q", T_F64: "<d"}


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _infer_type(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_I64 if (v < 0 or v >= 2 ** 32) else T_U32
    if isinstance(v, float):
        return T_F32
    if isinstance(v, str):
        return T_STR
    if isinstance(v, (list, tuple, np.ndarray)):
        return T_ARR
    raise TypeError(f"cannot infer gguf type for {type(v)}")


def _pack_value(v: Any, vtype: int) -> bytes:
    if vtype == T_BOOL:
        return struct.pack("<B", 1 if v else 0)
    if vtype in _SCALAR:
        return struct.pack(_SCALAR[vtype], v)
    if vtype == T_STR:
        return _pack_str(v)
    if vtype == T_ARR:
        if isinstance(v, np.ndarray):
            etype = {np.dtype(np.int32): T_I32, np.dtype(np.uint32): T_U32,
                     np.dtype(np.float32): T_F32, np.dtype(np.int64): T_I64}[v.dtype]
            body = v.astype(v.dtype.newbyteorder("<")).tobytes()
            return struct.pack("<IQ", etype, len(v)) + body
        if len(v) and isinstance(v[0], str):
            return struct.pack("<IQ", T_STR, len(v)) + b"".join(_pack_str(s) for s in v)
        if len(v) and isinstance(v[0], float):
            return struct.pack("<IQ", T_F32, len(v)) + struct.pack(f"<{len(v)}f", *v)
        # default int array
        return struct.pack("<IQ", T_I32, len(v)) + struct.pack(f"<{len(v)}i", *v)
    raise TypeError(f"unsupported gguf value type {vtype}")


class GGUFWriter:
    def __init__(self, path: str):
        self.path = path
        self.metadata: List[Tuple[str, int, Any]] = []
        self.tensors: List[Tuple[str, Tuple[int, ...], int, bytes]] = []

    def add(self, key: str, value: Any, vtype: Optional[int] = None) -> None:
        self.metadata.append((key, _infer_type(value) if vtype is None else vtype, value))

    def add_tensor(self, name: str, shape: Sequence[int], type_name: str,
                   raw: np.ndarray) -> None:
        """shape in numpy convention (row-major); raw = packed block bytes (uint8)."""
        spec = TYPE_BY_NAME[type_name]
        n = int(np.prod(shape))
        raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
        expect = type_size(n, spec)
        if raw.nbytes != expect:
            raise ValueError(f"{name}: {raw.nbytes} bytes, {type_name} {tuple(shape)} "
                             f"takes {expect}")
        self.tensors.append((name, tuple(shape), spec.type_id, raw.tobytes()))

    def add_tensor_f32(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        self.tensors.append((name, arr.shape, TYPE_BY_NAME["F32"].type_id, arr.tobytes()))

    def add_tensor_f16(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, dtype=np.float16)
        self.tensors.append((name, arr.shape, TYPE_BY_NAME["F16"].type_id, arr.tobytes()))

    def write(self) -> None:
        head = bytearray()
        head += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self.tensors), len(self.metadata))
        for key, vtype, value in self.metadata:
            head += _pack_str(key) + struct.pack("<I", vtype) + _pack_value(value, vtype)
        offset = 0
        for name, shape, type_id, raw in self.tensors:
            ne = tuple(reversed(shape))          # GGUF stores innermost-first
            head += _pack_str(name) + struct.pack("<I", len(ne))
            head += struct.pack(f"<{len(ne)}Q", *ne)
            head += struct.pack("<IQ", type_id, offset)
            offset += (len(raw) + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT
        head += b"\x00" * ((-len(head)) % ALIGNMENT)
        with open(self.path, "wb") as f:
            f.write(head)
            for _, _, _, raw in self.tensors:
                f.write(raw)
                f.write(b"\x00" * ((-len(raw)) % ALIGNMENT))


def pack_zip(zip_path: str, members: Dict[str, str], alignment: int = 4096) -> None:
    """zipalign analog: store files uncompressed in a ZIP with member data aligned.

    Alignment is achieved by padding the local-header extra field so that each
    member's data begins on an `alignment` boundary (mmap-able weights inside
    the artifact). Members >= 4 GiB (or offsets past 4 GiB) use ZIP64
    records; _ZIP64_THRESHOLD is a test hook, lowered to exercise them.
    """
    FFFF = 0xFFFFFFFF
    thr = _ZIP64_THRESHOLD
    with open(zip_path, "wb") as f:
        central = []
        for name, src in members.items():
            size = os.path.getsize(src)
            nameb = name.encode()
            zip64 = size >= thr
            header_off = f.tell()
            z64_extra = (struct.pack("<HHQQ", 1, 16, size, size) if zip64 else b"")
            data_off_nopad = header_off + 30 + len(nameb) + len(z64_extra) + 4
            pad = (-data_off_nopad) % alignment
            extra = z64_extra + struct.pack("<HH", 0x7065, pad) + b"\x00" * pad
            lsize = FFFF if zip64 else size
            # stream the file while computing crc (weights can be huge)
            crc = 0
            lh_pos = f.tell()
            lh = struct.pack("<IHHHHHIIIHH", 0x04034B50, 45 if zip64 else 20,
                             0, 0, 0, 0, 0, lsize, lsize, len(nameb), len(extra))
            f.write(lh + nameb + extra)
            assert f.tell() % alignment == 0
            with open(src, "rb") as sf:
                while True:
                    chunk = sf.read(1 << 24)
                    if not chunk:
                        break
                    crc = zipfile.crc32(chunk, crc)
                    f.write(chunk)
            crc &= FFFF
            end = f.tell()
            f.seek(lh_pos + 14)
            f.write(struct.pack("<I", crc))          # backpatch crc
            f.seek(end)
            central.append((nameb, crc, size, header_off, zip64))
        cd_start = f.tell()
        for nameb, crc, size, header_off, zip64 in central:
            csize = FFFF if zip64 else size
            coff = FFFF if header_off >= thr else header_off
            cextra = b""
            if zip64 or header_off >= thr:
                fields = b""
                if zip64:
                    fields += struct.pack("<QQ", size, size)
                if header_off >= thr:
                    fields += struct.pack("<Q", header_off)
                cextra = struct.pack("<HH", 1, len(fields)) + fields
            cd = struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45 if zip64 else 20,
                             0, 0, 0, 0, crc, csize, csize, len(nameb),
                             len(cextra), 0, 0, 0, 0, coff)
            f.write(cd + nameb + cextra)
        cd_size = f.tell() - cd_start
        need_z64 = any(z or off >= thr for _, _, _, off, z in central) \
            or cd_start >= thr
        if need_z64:
            z64_eocd_off = f.tell()
            f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0,
                                len(central), len(central), cd_size, cd_start))
            f.write(struct.pack("<IIQI", 0x07064B50, 0, z64_eocd_off, 1))
        eocd_cd_start = FFFF if cd_start >= thr else cd_start
        eocd = struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(central),
                           len(central), cd_size, eocd_cd_start, 0)
        f.write(eocd)
