"""Tracing, profiling and the numeric trap of the port.

The port's own copy of llamafile_tpu/utils/tracing.py:
- `--trace PATH`: `ChromeTracer`, a host-side span recorder writing Chrome
  about://tracing JSON (`{"traceEvents": [...]}`); `enable_tracing`,
  `tracer` and `span` as in the reference, which records no span of its
  own, so the file holds the spans a caller opens.
- `start_device_trace` / `stop_device_trace`: the device timeline, through
  torch.profiler (CPU and, on a card, CUDA activities), exported as a
  Chrome trace into the directory given.
- `--trap`: the analog of jax_debug_nans / jax_debug_infs. While it is on,
  the model forwards (models/llama.py) hold each layer's output and the
  logits with torch.isfinite, and the first non-finite value raises
  FloatingPointError naming the entry point, the layer and the position.
  While it is off nothing is checked and nothing waits on the device.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

import torch


class ChromeTracer:
    """Host-side span recorder writing Chrome about://tracing JSON
    (same consumer UX as the reference's --trace output)."""

    def __init__(self, path: str, ring: int = 1_000_000):
        self.path = path
        self.events: List[dict] = []
        self.lock = threading.Lock()
        self.ring = ring
        self.t0 = time.perf_counter_ns()

    @contextmanager
    def span(self, name: str, cat: str = "op"):
        start = (time.perf_counter_ns() - self.t0) / 1e3
        try:
            yield
        finally:
            dur = (time.perf_counter_ns() - self.t0) / 1e3 - start
            with self.lock:
                if len(self.events) < self.ring:
                    self.events.append({
                        "name": name, "cat": cat, "ph": "X", "ts": start,
                        "dur": dur, "pid": os.getpid(),
                        "tid": threading.get_ident() % 1_000_000,
                    })

    def write(self) -> None:
        with open(self.path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


_tracer: Optional[ChromeTracer] = None


def enable_tracing(path: str) -> ChromeTracer:
    global _tracer
    _tracer = ChromeTracer(path)
    return _tracer


def tracer() -> Optional[ChromeTracer]:
    return _tracer


@contextmanager
def span(name: str, cat: str = "op"):
    t = _tracer
    if t is None:
        yield
    else:
        with t.span(name, cat):
            yield


_profiler = None
_profile_dir: Optional[str] = None


def start_device_trace(logdir: str) -> None:
    """Start a torch.profiler session over the CPU and, where there is a
    card, the CUDA activities; stop_device_trace writes its timeline."""
    global _profiler, _profile_dir
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=acts)
    _profiler.__enter__()
    _profile_dir = logdir


def stop_device_trace() -> Optional[str]:
    """Stop the session and export its Chrome trace to <logdir>/trace.json;
    returns that path (None when no session runs)."""
    global _profiler
    if _profiler is None:
        return None
    prof, _profiler = _profiler, None
    prof.__exit__(None, None, None)
    os.makedirs(_profile_dir, exist_ok=True)
    path = os.path.join(_profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


TRAP = False


def enable_trap(on: bool = True) -> None:
    """Hold every forward's layer outputs and logits to be finite (the
    reference's jax_debug_nans / jax_debug_infs); on=False turns it off."""
    global TRAP
    TRAP = on


def check_finite(x: torch.Tensor, entry: str, layer, pos) -> None:
    """Raise FloatingPointError at the first non-finite value of x [B, T,
    ...] (or [R, ...], one token a row), naming the entry point, the layer
    (an int, or a name such as "logits") and the token's position pos[b] +
    t. Reads the device: called only while TRAP is on."""
    if x.dim() == 2:
        x = x[:, None]
    bad = ~torch.isfinite(x)
    if not bool(bad.any()):
        return
    b, t = (int(i) for i in torch.nonzero(bad.flatten(2).any(-1))[0])
    p = int(pos.reshape(-1)[b]) + t
    what = f"layer {layer}" if isinstance(layer, int) else str(layer)
    raise FloatingPointError(f"non-finite value in {entry}: {what} output at "
                             f"position {p} (row {b}) (--trap)")
