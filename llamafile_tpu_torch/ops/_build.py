"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exports plain C entry points and is compiled on its own
into `build/lib<name>-<hash>.so` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

at first use; a library whose source hash (the .cu, the shared headers and
the flags) matches is reused. Nothing is imported from outside the repository
and nothing is downloaded. Every C entry returns cudaGetLastError() and
`check` raises if it is not zero.

`build_all()` starts one nvcc per source at once, so a cold build costs the
slowest file, not the sum.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("qmm_txn_m1", "qmm_txn", "qmm_moe_m1", "flash_decode_write",
           "qmm_q8_m1", "qmm_dequant", "flash_prefill", "paged_attention",
           "qmm_planes", "flash_decode", "qmm_routed", "qmm_txn_g",
           "qmm_planes_g", "qmm_i8p", "qmm_int8")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns
    (process or None, tmp path, final path)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)                  # atomic: concurrent builders agree


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    started = [(n, *_start(n)) for n in names]
    errors = []
    for name, proc, tmp, out in started:
        try:
            _finish(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def fn(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry `symbol` of library `name` with its argtypes set; returns int."""
    f = _fns.get((name, symbol))
    if f is None:
        f = getattr(load(name), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[(name, symbol)] = f
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
