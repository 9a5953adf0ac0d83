"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), the least time a kernel could take, and the
operations a whole Lasso path fit needs."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(flops: float, nbytes: float) -> float:
    """The larger of the operations at the float32 rate (outside the
    tensor cores) and the bytes (each input read once, each output
    written once) at the memory rate."""
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def path_setup_flops(n: int, p: int) -> float:
    """A path fit's set-up (2 operations per multiply-add): standardizing
    and X'y; then, tall, the Gram matrix, 51 power steps on it, the
    Cholesky factor and inverse (p^3); wide, 51 power steps on XX'."""
    if n > p:
        return 8.0 * n * p + 2.0 * n * p * p + 102.0 * p * p + p ** 3
    return 8.0 * n * p + 51 * 4.0 * n * p


def path_iteration_flops(n: int, p: int) -> float:
    """One lane-iteration: a product with the (p, p) ridge inverse (tall),
    or X'v and X x (wide)."""
    return 2.0 * p * p if n > p else 4.0 * n * p
