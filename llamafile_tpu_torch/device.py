"""Device selection for the port.

The port runs on the card by default. The CPU is used only when a caller asks
for it (the tests do); asking for CUDA where there is none raises instead of
carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the torch.device for `device` ("cuda", "cuda:N" or "cpu").

    Raises RuntimeError when CUDA is asked for and torch sees no card.
    Also pins float32 products to full float32 (no TF32), so the plain f32
    matmuls of the port stay f32 on the card as on the CPU.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
