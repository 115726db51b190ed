"""The port's native host repacker: csrc/repack.cpp through ctypes.

Counterpart of llamafile_tpu/native.py. The C++ source is the port's own
copy; it is built with g++ at first use into build/librepack-<hash>.so, the
hash over the source and the flags (as ops/_build.py names the kernel
libraries), so a changed source or flag builds anew and a build dir reused
on another host holds no code for another CPU (no -march=native). The
flags keep -ffp-contract=off: the scale products must keep numpy's bits.

`native_repack` takes the formats and conditions of the reference's (Q8_0,
Q4_0 at K % 256 == 0, Q4_K, Q5_K, Q6_K) and returns None for the others;
ops/repack.repack_numpy calls it first. Its OpenMP team takes
torch.get_num_threads() threads, set before every call. On a host with no
g++ it warns once, naming the cause, and returns None (the numpy path runs);
a build that fails raises. `native_repack.calls` counts the repacks it ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from .ops._build import BUILD, CSRC

SOURCE = os.path.join(CSRC, "repack.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-ffp-contract=off", "-Wall"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def lib_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD, f"librepack-{h.hexdigest()[:16]}.so")


def _build(cxx: str, out: str) -> None:
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/repack.cpp:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)                  # atomic: concurrent builds agree


def lib() -> Optional[ctypes.CDLL]:
    """The loaded repacker, built on first use; None on a host with no g++."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = lib_path()
        if not os.path.exists(out):
            cxx = shutil.which("g++")
            if cxx is None:
                warnings.warn("the native repacker is not built: no g++ on this host; "
                              "the numpy repack runs instead", RuntimeWarning)
                return None
            _build(cxx, out)
        L = ctypes.CDLL(out)
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i8 = np.ctypeslib.ndpointer(np.int8, flags="C")
        f4 = np.ctypeslib.ndpointer(np.float32, flags="C")
        i64 = ctypes.c_int64
        L.repack_q8_0.argtypes = [u8, i64, i64, i8, f4]
        L.repack_q4_0.argtypes = [u8, i64, i64, u8, f4, f4]
        L.repack_q4_k.argtypes = [u8, i64, i64, u8, f4, f4]
        L.repack_q5_k.argtypes = [u8, i64, i64, i8, f4, f4]
        L.repack_q6_k.argtypes = [u8, i64, i64, i8, f4]
        L.repack_set_num_threads.argtypes = [ctypes.c_int]
        for f in (L.repack_q8_0, L.repack_q4_0, L.repack_q4_k, L.repack_q5_k,
                  L.repack_q6_k, L.repack_set_num_threads):
            f.restype = None
        L.repack_num_threads.argtypes = []
        L.repack_num_threads.restype = ctypes.c_int
        _lib = L
        return _lib


# format -> (block elems, block bytes, the C entry's name)
_FORMATS = {"Q8_0": (32, 34, "repack_q8_0"), "Q4_0": (32, 18, "repack_q4_0"),
            "Q4_K": (256, 144, "repack_q4_k"), "Q5_K": (256, 176, "repack_q5_k"),
            "Q6_K": (256, 210, "repack_q6_k")}


def native_repack(raw: np.ndarray, type_name: str, n: int, k: int):
    """(kind, qs, scales, bias, g) of ops/repack.repack_numpy from the
    native repacker, or None for a format or shape it does not take (Q4_0
    below K % 256) or a host with no g++."""
    if type_name not in _FORMATS or (type_name == "Q4_0" and k % 256):
        return None
    L = lib()
    if L is None:
        return None
    elems, nbytes, entry = _FORMATS[type_name]
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    if k % elems or raw.size != n * k // elems * nbytes:
        raise ValueError(f"{type_name} ({n}, {k}): {raw.size} bytes of blocks")
    L.repack_set_num_threads(torch.get_num_threads())
    f = getattr(L, entry)
    if type_name in ("Q4_0", "Q4_K"):
        from .ops.repack import _fold_hi_plane
        qT = np.empty((k // 2, n), np.uint8)
        aT = np.empty((k // 32, n), np.float32)
        bT = np.empty((k // 32, n), np.float32)
        f(raw, n, k, qT, aT, bT)
        aT, bT = _fold_hi_plane(aT, bT, 32)
        out = "q4b", qT, aT, bT, 32
    elif type_name == "Q5_K":
        qT = np.empty((k, n), np.int8)
        aT = np.empty((k // 32, n), np.float32)
        bT = np.empty((k // 32, n), np.float32)
        f(raw, n, k, qT, aT, bT)
        out = "q8b", qT, aT, bT, 32
    else:
        g = 32 if type_name == "Q8_0" else 16
        qT = np.empty((k, n), np.int8)
        aT = np.empty((k // g, n), np.float32)
        f(raw, n, k, qT, aT)
        out = "q8b", qT, aT, None, g
    native_repack.calls += 1
    return out


native_repack.calls = 0
