"""Ops of the port: repack, quantized matmuls, attention, and their kernels."""


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its `launches` count."""
    from .attention import KERNELS as attn
    from .qmatmul import KERNELS as qmm
    return qmm + attn


def reset_launch_counts() -> None:
    for w in kernel_wrappers():
        w.launches = 0
