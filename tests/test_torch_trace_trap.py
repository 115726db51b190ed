"""--trace, --trap, the device trace and utils/crash.py of the port, on the CPU.

--trace writes the span recorder's Chrome JSON at exit (a CLI run in its own
process, as a user runs it); --trap holds each layer's output and the
logits of every forward to be finite: on a GGUF with one NaN weight in layer
1's FFN it raises FloatingPointError naming the entry point, layer 1 and the
position, and the same run without it completes. device_retry reruns a
transient device fault (a launch failure's cudaError) and passes a logic
error through at once.
"""
import faulthandler
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from llamafile_tpu_torch import cli
from llamafile_tpu_torch.gguf.reader import GGUFReader
from llamafile_tpu_torch.models import llama as TL
from llamafile_tpu_torch.runtime.engine import load_engine
from llamafile_tpu_torch.utils import crash, tracing
from tests.test_torch_q4km import _one_torch_thread  # noqa: F401
from tests.util_models import make_tiny_llama_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trap") / "tiny-f32.gguf")
    return make_tiny_llama_gguf(path, quant="F32", d_model=256, d_ff=512, n_heads=2,
                                n_kv_heads=1, n_layers=2)


@pytest.fixture(scope="module")
def nan_gguf(gguf, tmp_path_factory):
    """The same file with one NaN weight: element 0 of blk.1.ffn_down."""
    path = str(tmp_path_factory.mktemp("trap") / "tiny-nan.gguf")
    with open(gguf, "rb") as f:
        data = bytearray(f.read())
    off = GGUFReader(gguf).tensors["blk.1.ffn_down.weight"].offset
    data[off:off + 4] = np.float32(np.nan).tobytes()
    with open(path, "wb") as f:
        f.write(data)
    return path


def _cli(path, *extra):
    return ["--cli", "-m", path, "--device", "cpu", "-p", "hello", "-n", "3", "--temp", "0",
            *extra]


def test_trace_writes_chrome_json(gguf, tmp_path):
    out = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "llamafile_tpu_torch.cli",
                          *_cli(gguf, "--trace", str(out))], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"tracing to {out} (Chrome about://tracing)" in run.stderr
    trace = json.loads(out.read_text())
    assert trace == {"traceEvents": []}         # no span of its own, as the reference


def test_spans_and_device_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "_tracer", None)
    with tracing.span("off"):                   # no tracer: nothing recorded
        pass
    t = tracing.enable_tracing(str(tmp_path / "t.json"))
    with tracing.span("prefill", cat="engine"):
        torch.ones(4).sum()
    t.write()
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert [(e["name"], e["cat"], e["ph"]) for e in ev] == [("prefill", "engine", "X")]
    tracing.start_device_trace(str(tmp_path / "dev"))
    (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    path = tracing.stop_device_trace()
    assert json.loads(open(path).read())["traceEvents"]
    assert tracing.stop_device_trace() is None


def test_trap_names_the_layer(nan_gguf, monkeypatch, capsys):
    monkeypatch.setattr(tracing, "TRAP", False)
    assert cli.main(_cli(nan_gguf)) == 0           # completes without --trap
    with pytest.raises(FloatingPointError, match=r"forward: layer 1 output at position 0"):
        cli.main(_cli(nan_gguf, "--trap"))
    assert "NaN/Inf trapping enabled (--trap)" in capsys.readouterr().err


def test_trap_paged_decode_and_logits(nan_gguf, gguf, monkeypatch):
    """forward_paged_decode traps too; a finite model passes every check."""
    from llamafile_tpu_torch.runtime.paged import init_paged
    monkeypatch.setattr(tracing, "TRAP", True)
    for path, bad in ((gguf, False), (nan_gguf, True)):
        eng = load_engine(path, device="cpu", max_seq_len=64)
        cfg = eng.cfg
        pool = init_paged(cfg.n_layers, cfg.n_kv_heads, 3, 16, cfg.head_dim, device="cpu")
        tables = torch.tensor([[1], [2]], dtype=torch.int32)
        args = (eng.params, cfg, torch.tensor([5, 6]), torch.tensor([3, 7], dtype=torch.int32),
                pool, tables)
        if bad:
            with pytest.raises(FloatingPointError,
                               match=r"forward_paged_decode: layer 1 output at position 3"):
                TL.forward_paged_decode(*args)
        else:
            logits, _ = TL.forward_paged_decode(*args)
            assert bool(torch.isfinite(logits).all())


def test_check_finite_logits_position():
    x = torch.zeros(2, 3, 5)
    x[1, 2, 4] = float("inf")
    with pytest.raises(FloatingPointError,
                       match=r"forward: logits output at position 12 \(row 1\)"):
        tracing.check_finite(x, "forward", "logits", torch.tensor([0, 10]))
    tracing.check_finite(torch.zeros(2, 5), "forward", 0, torch.tensor([0, 1]))


def test_device_retry():
    calls = []

    @crash.device_retry(retries=2, backoff_s=0.0)
    def flaky(err):
        calls.append(err)
        if len(calls) == 1:
            raise err
        return "ok"

    assert flaky(RuntimeError("CUDA launch of qmm_txn failed: cudaError 719")) == "ok"
    assert len(calls) == 2
    calls.clear()
    assert flaky(RuntimeError("CUDA error: unspecified launch failure")) == "ok"
    for err in (ValueError("bad shape"), RuntimeError("CUDA launch of x failed: cudaError 1"),
                torch.cuda.OutOfMemoryError("CUDA out of memory"),
                RuntimeError("CUDA error: an illegal memory access was encountered")):
        calls.clear()
        with pytest.raises(type(err)):
            flaky(err)
        assert len(calls) == 1                      # passed through at once


def test_show_crash_reports():
    crash.show_crash_reports()
    assert faulthandler.is_enabled()
    faulthandler.unregister(signal.SIGUSR1)
