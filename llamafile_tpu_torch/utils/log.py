"""Leveled, thread-safe logging (tinylog/SLOG analog; llamafile/log.{c,h});
the port's own copy of llamafile_tpu/utils/log.py, under its own logger name.

Thin wrapper over the stdlib logging module with the reference's UX:
timestamps + level + thread, a --verbose switch, a kill switch
(FLAG_log_disable), and a separate access-log channel for the server.
"""
from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s %(threadName)s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"

log = logging.getLogger("llamafile_tpu_torch")
access_log = logging.getLogger("llamafile_tpu_torch.access")


def setup(verbose: bool = False, disable: bool = False) -> None:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    root = logging.getLogger("llamafile_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(logging.CRITICAL + 1 if disable
                  else logging.DEBUG if verbose else logging.INFO)
    root.propagate = False
