"""The port's native repacker (llamafile_tpu_torch/native.py, csrc/repack.cpp)
against the port's numpy path and the JAX package's repack_numpy, on the CPU.

- Q8_0, Q4_0, Q4_K, Q5_K and Q6_K through the native repacker are byte for
  byte the numpy path's and the reference's (kind, g, codes, scales, bias);
  Q4_0 at K % 256 != 0 and every other format go to numpy, as in the
  reference (native_repack returns None, its call count stays);
- the library is built at first use under llamafile_tpu_torch/build/, named
  by a hash of its source and flags, and takes torch's thread count;
- on a host with no g++ it warns once, naming the cause, and the numpy path
  runs; a short buffer raises.
"""
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from llamafile_tpu.ops import repack as JR
from llamafile_tpu_torch import native as N
from llamafile_tpu_torch.models.synthetic import random_blocks
from llamafile_tpu_torch.ops import repack as TR
from tests.test_torch_q4km import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = ("Q8_0", "Q4_0", "Q4_K", "Q5_K", "Q6_K")


def _same(got, want):
    assert got[0] == want[0] and got[4] == want[4]
    for a, b in zip(got[1:4], want[1:4]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("fmt", NATIVE)
@pytest.mark.parametrize("n,k", [(300, 512), (48, 256), (1000, 2048)])
def test_native_equals_numpy_and_reference(fmt, n, k):
    raw = random_blocks(np.random.default_rng(n + k), fmt, n * k)
    c0 = N.native_repack.calls
    got = TR.repack_numpy(raw, fmt, (n, k))
    assert N.native_repack.calls == c0 + 1               # the native path ran
    _same(got, TR.repack_numpy(raw, fmt, (n, k), native=False))
    _same(got, JR.repack_numpy(raw, fmt, (n, k)))
    assert got[0] == ("q4b" if fmt in ("Q4_0", "Q4_K") else "q8b")


@pytest.mark.parametrize("fmt,k", [("Q4_0", 96), ("Q4_0", 800), ("Q3_K", 512),
                                   ("IQ1_M", 512), ("Q5_0", 512)])
def test_other_formats_go_to_numpy(fmt, k):
    raw = random_blocks(np.random.default_rng(k), fmt, 64 * k)
    c0 = N.native_repack.calls
    assert N.native_repack(raw, fmt, 64, k) is None
    got = TR.repack_numpy(raw, fmt, (64, k))
    assert N.native_repack.calls == c0
    _same(got, JR.repack_numpy(raw, fmt, (64, k)))


def test_library_under_build_and_named_by_hash():
    assert N.lib() is not None
    path = N.lib_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "llamafile_tpu_torch", "build")
    assert os.path.exists(path)
    name = os.path.basename(path)
    assert name.startswith("librepack-") and name.endswith(".so") and len(name) == 29
    assert "-ffp-contract=off" in N.CXX_FLAGS
    assert not any(f.startswith("-march") for f in N.CXX_FLAGS)


def test_threads_follow_torch():
    raw = random_blocks(np.random.default_rng(0), "Q6_K", 64 * 256)
    n = torch.get_num_threads()
    try:
        for t in (2, 1):
            torch.set_num_threads(t)
            TR.repack_numpy(raw, "Q6_K", (64, 256))
            assert N.lib().repack_num_threads() == t
    finally:
        torch.set_num_threads(n)


def test_no_compiler_warns_and_numpy_runs(monkeypatch, tmp_path):
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_tried", False)
    monkeypatch.setattr(N, "lib_path", lambda: str(tmp_path / "librepack-none.so"))
    monkeypatch.setattr(N.shutil, "which", lambda name: None)
    raw = random_blocks(np.random.default_rng(1), "Q4_K", 32 * 256)
    with pytest.warns(RuntimeWarning, match="no g\\+\\+"):
        got = TR.repack_numpy(raw, "Q4_K", (32, 256))
    _same(got, TR.repack_numpy(raw, "Q4_K", (32, 256), native=False))
    assert N.lib() is None                                 # warned once, not again


def test_short_buffer_raises():
    raw = random_blocks(np.random.default_rng(2), "Q8_0", 64 * 256)
    with pytest.raises(ValueError, match="bytes of blocks"):
        N.native_repack(raw[:-1], "Q8_0", 64, 256)
