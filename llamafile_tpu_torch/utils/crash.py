"""Crash reports and device-fault retries of the port.

The port's own copy of llamafile_tpu/utils/crash.py: `show_crash_reports`
(faulthandler backtraces on hard faults and on SIGUSR1, the reference's
ShowCrashReports) and `device_retry`, a decorator that reruns a function
across transient device faults. No main of the reference calls either, and
none of the port's does; the batcher recovers from an out-of-memory error
on its own (server/batcher.py Batcher._recover).

A transient device fault is what the port raises when the card, not the
program, failed: a kernel launch whose cudaError (ops/_build.check) is one
of TRANSIENT_CUDA_ERRORS, or a torch.cuda error with one of their messages.
An out-of-memory error, an invalid argument, an illegal address and any
other exception (ValueError, TypeError, ...) are the program's, and pass
through at once.
"""
from __future__ import annotations

import faulthandler
import functools
import re
import sys
import time
from typing import Callable

# cudaError codes of a fault of the device or its driver, not of the call:
# devices unavailable, uncorrectable ECC, launch timeout, launch failure,
# system not ready, unknown
TRANSIENT_CUDA_ERRORS = {46: "all CUDA-capable devices are busy or unavailable",
                         214: "uncorrectable ECC error encountered",
                         702: "the launch timed out and was terminated",
                         719: "unspecified launch failure",
                         802: "system not yet initialized",
                         999: "unknown error"}


def show_crash_reports() -> None:
    """Dump Python tracebacks on hard faults (SIGSEGV/SIGABRT) and on demand
    (SIGUSR1), like the reference's ShowCrashReports."""
    faulthandler.enable(file=sys.stderr, all_threads=True)
    try:
        import signal
        faulthandler.register(signal.SIGUSR1, file=sys.stderr, all_threads=True)
    except (ImportError, AttributeError, ValueError):
        pass


def _is_device_fault(e: BaseException) -> bool:
    if not isinstance(e, RuntimeError) or "out of memory" in str(e):
        return False
    msg = str(e)
    m = re.search(r"CUDA launch of \S+ failed: cudaError (\d+)", msg)
    if m:
        return int(m.group(1)) in TRANSIENT_CUDA_ERRORS
    return "CUDA error" in msg and any(s in msg for s in TRANSIENT_CUDA_ERRORS.values())


def device_retry(retries: int = 2, backoff_s: float = 2.0):
    """Decorator: retry a device-executing function across transient faults.

    Only retries errors that look like device/runtime failures (a launch
    failure, a lost device); logic errors propagate immediately.
    """
    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last = None
            for attempt in range(retries + 1):
                try:
                    return fn(*args, **kwargs)
                except Exception as e:   # noqa: BLE001 — filtered below
                    if not _is_device_fault(e) or attempt == retries:
                        raise
                    last = e
                    print(f"device fault (attempt {attempt + 1}/{retries + 1}): "
                          f"{str(e)[:200]} — retrying in {backoff_s}s",
                          file=sys.stderr)
                    time.sleep(backoff_s * (attempt + 1))
            raise last  # pragma: no cover
        return wrapper
    return deco
