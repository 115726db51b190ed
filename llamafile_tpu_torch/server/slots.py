"""Slot scoring helper of the port.

The port's copy of `common_prefix_len` (llamafile_tpu/server/slots.py:26),
which the continuous batcher uses to pick a row and its reusable prefix. The
reference's standalone Slot/Slots manager is not on the serving path and is
not ported yet.
"""
from __future__ import annotations

from typing import List


def common_prefix_len(a: List[int], b: List[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
