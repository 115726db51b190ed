"""The port stands alone: llamafile_tpu_torch and chip_smoke.py import
neither jax nor anything of the JAX package llamafile_tpu."""
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "llamafile_tpu_torch")

_CHECK = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None                 # any import of jax now fails
import llamafile_tpu_torch
names = [m.name for m in pkgutil.walk_packages(llamafile_tpu_torch.__path__,
                                               "llamafile_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "llamafile_tpu" or m.startswith("llamafile_tpu."))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15          # every module was imported


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+llamafile_tpu(\.|\s|$)"
    r"|from\s+llamafile_tpu(\.|\s)|from\s+llamafile_tpu\s+import)", re.M)


def test_sources_name_no_jax_import():
    found = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            for m in _FORBIDDEN.finditer(f.read()):
                found.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not found, found


def test_every_module_counted():
    names = [m.name for m in pkgutil.walk_packages([PKG], "llamafile_tpu_torch.")]
    assert "llamafile_tpu_torch.ops.qmatmul" in names
    assert "llamafile_tpu_torch.runtime.engine" in names


# a path into the JAX package's native/ (a "native" component of a path join, or
# native/ written out) or its library's name
_NATIVE_REF = re.compile(r"native/|path\.join\([^)]*[\"']native[\"']|librepack\.so")


def test_sources_name_no_reference_native():
    """The port builds and loads its own repacker (csrc/repack.cpp into
    build/): no source of it names the JAX package's native/ directory or
    its library."""
    found = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    found += [f"{os.path.relpath(path, ROOT)}: {m.group(0)}"
                              for m in _NATIVE_REF.finditer(fh.read())]
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as fh:
        found += [f"chip_smoke.py: {m.group(0)}" for m in _NATIVE_REF.finditer(fh.read())]
    assert not found, found
