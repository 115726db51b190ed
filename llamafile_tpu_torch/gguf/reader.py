"""GGUF v1-v3 reader: mmap-backed, zero-copy tensor access, ZIP-member support.

Own copy of llamafile_tpu/gguf/reader.py. A path may be a `.gguf` file, or a
`.llamafile`-style ZIP whose uncompressed `.gguf` member is mmapped in place.
Tensor bytes are numpy views over the mmap; the loader repacks them and moves
them to the device.
"""
from __future__ import annotations

import mmap
import struct
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from .quants import TYPE_BY_ID, QuantSpec, dequantize, type_size

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h", T_U32: "<I", T_I32: "<i",
    T_F32: "<f", T_U64: "<Q", T_I64: "<q", T_F64: "<d",
}


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v

    def u32(self) -> int:
        return self.scalar("<I")

    def u64(self) -> int:
        return self.scalar("<Q")

    def string(self, version: int) -> str:
        n = self.u64() if version >= 2 else self.u32()
        return self.read(n).decode("utf-8", errors="replace")


def _read_value(c: _Cursor, vtype: int, version: int):
    if vtype in _SCALAR_FMT:
        return c.scalar(_SCALAR_FMT[vtype])
    if vtype == T_BOOL:
        return bool(c.scalar("<B"))
    if vtype == T_STR:
        return c.string(version)
    if vtype == T_ARR:
        etype = c.u32()
        n = c.u64() if version >= 2 else c.u32()
        if etype in _SCALAR_FMT and etype != T_F64:
            fmt = _SCALAR_FMT[etype]
            sz = struct.calcsize(fmt)
            return np.frombuffer(c.read(n * sz),
                                 dtype=np.dtype(fmt[1:]).newbyteorder("<"))
        return [_read_value(c, etype, version) for _ in range(n)]
    raise ValueError(f"unknown gguf value type {vtype}")


@dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]       # numpy convention (outermost first); reversed GGUF ne[]
    type_id: int
    offset: int                  # absolute offset into the mapped file
    nbytes: int

    @property
    def spec(self) -> QuantSpec:
        return TYPE_BY_ID[self.type_id]

    @property
    def type_name(self) -> str:
        return self.spec.name


class GGUFReader:
    """Parses a GGUF file and exposes metadata + zero-copy tensor bytes."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        base = 0
        if not self._mm[:4] == b"GGUF":
            base = self._find_zip_member()
        self._parse(base)

    def _find_zip_member(self) -> int:
        """Locate an uncompressed .gguf member inside a ZIP archive."""
        try:
            zf = zipfile.ZipFile(self.path)
        except zipfile.BadZipFile as e:
            raise ValueError(f"{self.path}: neither GGUF nor ZIP") from e
        for info in zf.infolist():
            if info.filename.endswith(".gguf"):
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{info.filename} is compressed; need stored (zipalign -0)")
                # local header: 30 bytes + name + extra
                lh = struct.unpack_from("<IHHHHHIIIHH", self._mm, info.header_offset)
                return info.header_offset + 30 + lh[9] + lh[10]
        raise ValueError(f"{self.path}: no .gguf member in archive")

    def _parse(self, base: int) -> None:
        c = _Cursor(self._mm, base)
        magic = c.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"bad GGUF magic {magic:#x}")
        self.version = c.u32()
        if self.version not in (1, 2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        read_count = c.u64 if self.version >= 2 else c.u32
        n_tensors = read_count()
        n_kv = read_count()
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = c.string(self.version)
            vtype = c.u32()
            self.metadata[key] = _read_value(c, vtype, self.version)
        self.alignment = int(self.metadata.get("general.alignment", 32))
        infos: List[Tuple[str, Tuple[int, ...], int, int]] = []
        for _ in range(n_tensors):
            name = c.string(self.version)
            n_dims = c.u32()
            ne = [read_count() for _ in range(n_dims)]
            type_id = c.u32()
            offset = c.u64()
            infos.append((name, tuple(reversed(ne)), type_id, offset))
        data_start = base + ((c.pos - base + self.alignment - 1)
                             // self.alignment) * self.alignment
        self.data_start = data_start
        self.tensors: Dict[str, TensorInfo] = {}
        for name, shape, type_id, offset in infos:
            spec = TYPE_BY_ID[type_id]
            nbytes = type_size(int(np.prod(shape)) if shape else 1, spec)
            self.tensors[name] = TensorInfo(name, shape, type_id,
                                            data_start + offset, nbytes)

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw little-endian bytes of a tensor as a zero-copy uint8 view."""
        t = self.tensors[name]
        return np.frombuffer(self._mm, dtype=np.uint8, count=t.nbytes,
                             offset=t.offset)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantized float32 copy (raises for formats not ported yet)."""
        t = self.tensors[name]
        return dequantize(self.tensor_bytes(name), t.type_id, t.shape)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "llama")

    def field(self, key: str, default=None):
        """Metadata lookup with {arch} substitution."""
        return self.metadata.get(key.format(arch=self.architecture), default)
