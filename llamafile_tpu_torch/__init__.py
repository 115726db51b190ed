"""llamafile_tpu_torch: the PyTorch/CUDA port of llamafile_tpu for NVIDIA Hopper.

The JAX package `llamafile_tpu` is the reference; this package keeps its
module names and layout so that each counterpart is easy to find, and runs the
same numerics on an H100 through hand-written CUDA kernels (`csrc/`).

This package imports torch and numpy only: never jax, and nothing of
`llamafile_tpu` (it keeps its own copies of what it needs).

Entry points (`runtime.engine.Engine`, `models.loader.load_llama`,
`models.synthetic.make_synthetic_llama`, `cli`) run on the card unless the
caller asks for `device="cpu"`; on the CPU every kernel wrapper takes its
plain PyTorch version instead.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
