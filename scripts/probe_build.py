"""What the kernel probes (scripts/probe_*.py) share: text patches of a
kernel source, the directories that hold a variant's sources, and one nvcc
for each source, all started at once.

A variant is a text patch of the kernel as the port builds it, so it cannot
drift from the kernel unnoticed: each anchor of a patch must occur exactly
once in the text it patches, or the probe stops.
"""
import ctypes
import glob
import os
import shutil
import subprocess


def patched(text, subs, what="the kernel source"):
    """text with each substitution of subs applied in order: (old, new)
    replaces old, (start, end, new) replaces the text from start up to (not
    including) end. Every anchor must occur once in the text."""
    for sub in subs:
        for a in sub[:-1]:
            if text.count(a) != 1:
                raise RuntimeError(f"{a!r} is not once in {what}")
        if len(sub) == 2:
            text = text.replace(*sub)
        else:
            i, j = text.index(sub[0]), text.index(sub[1])
            if j < i:
                raise RuntimeError(f"{sub[1]!r} precedes {sub[0]!r} in {what}")
            text = text[:i] + sub[2] + text[j:]
    return text


def variant_dir(base, name, copies, texts):
    """A fresh directory base/name holding a copy of each path of copies and
    each {file name: text} of texts; returns its path."""
    d = os.path.join(base, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in copies:
        shutil.copy(f, d)
    for fname, text in texts.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    return d


def headers(csrc):
    """The shared headers (*.cuh) of a csrc directory."""
    return glob.glob(os.path.join(csrc, "*.cuh"))


def build(jobs, out):
    """Compile every job at once: jobs maps a key to (.cu path, include
    directory); each becomes out/<key>.so. Prints ptxas's register, spill and
    wgmma notes of each; returns {key: ctypes.CDLL}."""
    from llamafile_tpu_torch.ops import _build
    os.makedirs(out, exist_ok=True)
    procs = {}
    for key, (cu, inc) in jobs.items():
        so = os.path.join(out, f"{key}.so".replace("/", "-"))
        procs[key] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", inc, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if any(w in ln.lower() for w in ("registers", "spill", "wgmma", "warning"))]
        print(f"[{key}] " + " | ".join(notes), flush=True)
        libs[key] = ctypes.CDLL(so)
    return libs


def entry(lib, symbol, argtypes):
    """C entry symbol of lib with its argtypes set; returns int."""
    f = getattr(lib, symbol)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
