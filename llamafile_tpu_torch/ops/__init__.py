"""Ops of the port: repack, quantized matmuls, attention, and their kernels."""


def kernel_wrappers():
    """Every kernel wrapper of the port, each with its `launches` count."""
    from .attention import KERNELS as attn
    from .qmatmul import KERNELS as qmm
    return qmm + attn


def reset_launch_counts() -> None:
    """Every kernel's launch count (qmm_planes' stacked share too), and the
    call counts of the routes that are not kernels (attention.ROUTE_COUNTS,
    qmatmul.ROUTE_COUNTS), set to 0."""
    from .attention import ROUTE_COUNTS as attn_routes
    from .qmatmul import ROUTE_COUNTS as qmm_routes
    from .qmatmul import qmm_planes
    for w in kernel_wrappers():
        w.launches = 0
    qmm_planes.stacked_launches = 0
    for counts in (attn_routes, qmm_routes):
        for route in counts:
            counts[route] = 0
