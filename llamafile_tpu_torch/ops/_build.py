"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exports plain C entry points and is compiled on its own
into `build/lib<name>-<hash>.so` (the hash over the source, every shared
header and the flags) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

at first use. A variant (VARIANTS) is a source built again with macros
defined on the command line: the decode kernels' f16 and f32 instances; a library whose source hash (the .cu, the shared headers and
the flags) matches is reused. Nothing is imported from outside the repository
and nothing is downloaded. Every C entry returns cudaGetLastError() and
`check` raises if it is not zero.

`build_all()` runs one nvcc a library, as many at once as the machine has
CPUs, the slowest first, and returns each library's compile seconds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# the decode kernels' f16 and f32 instances: library -> (its source, the
# macros defined for it); each exports the bf16 library's C entry
VARIANTS = {
    f"{src}_{kv}": (src, {"flash_decode_write": (f"FDW_ELEM={elem}",),
                          "flash_decode": (f"FD_FLOAT={elem}", "FD_INT8=0"),
                          "paged_attention": (f"PA_FLOAT={elem}", "PA_INT8=0")}[src])
    for kv, elem in (("f16", "__half"), ("f32", "float"))
    for src in ("flash_decode", "paged_attention", "flash_decode_write")}
# every library, the slowest to compile first (build_all's order)
SOURCES = ("flash_decode", "paged_attention", "flash_decode_write",
           "flash_decode_f32", "paged_attention_f32", "flash_decode_write_f32",
           "flash_decode_f16", "paged_attention_f16", "flash_decode_write_f16",
           "qmm_txn_m1", "qmm_txn", "qmm_moe_m1", "qmm_q8_m1", "qmm_dequant",
           "flash_prefill", "qmm_planes", "qmm_routed", "qmm_txn_g",
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


def _source(name: str):
    """(the .cu path, the nvcc flags) of library `name`."""
    src, defines = VARIANTS.get(name, (name, ()))
    return os.path.join(CSRC, f"{src}.cu"), NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    src, flags = _source(name)
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns
    (process or None, tmp path, final path)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src, flags = _source(name)
    cmd = [nvcc_path(), *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)                  # atomic: concurrent builders agree


def build_all(names: List[str] = SOURCES) -> Dict[str, float]:
    """Compile every kernel library in parallel, one nvcc each, at most one
    a CPU at a time in the order of names (SOURCES lists the slowest
    first): more at once would share the cores and stretch the slowest
    compile, which sets the build's time. Returns each library's compile
    seconds (0 for one already built)."""
    pending, running, errors, secs = list(names), [], [], {}
    while pending or running:
        while pending and len(running) < (os.cpu_count() or 8):
            name = pending.pop(0)
            running.append((name, time.time(), *_start(name)))
        for item in [r for r in running if r[2] is None or r[2].poll() is not None]:
            running.remove(item)
            name, t0 = item[:2]
            secs[name] = 0.0 if item[2] is None else round(time.time() - t0, 1)
            try:
                _finish(name, *item[2:])
            except RuntimeError as e:
                errors.append(str(e))
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


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
