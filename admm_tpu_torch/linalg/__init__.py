"""Linear algebra for the port: full-precision products, SPD inverses
and power iteration (counterpart of ``admm_tpu/linalg``).

Every product that feeds a Cholesky factor or a convergence test runs in
full float32.  PyTorch's defaults already do (``allow_tf32`` False,
float32 matmul precision "highest"); the port states the setting and
leaves it alone, and ``chip_smoke.py`` prints both on the card.  TF32
keeps about three decimal digits, which breaks the Boyd test at 1e-5.
"""
from __future__ import annotations

import torch

from .power_iter import (power_iteration, spectral_radius_gram,
                         spectral_radius_sym)
from .spd import chol_inverse, ridge_inverse
from ..parallel.mesh import is_sharded


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix/vector product at full precision (``jnp.dot`` semantics);
    either side may be a matrix sharded over a mesh
    (:class:`admm_tpu_torch.parallel.mesh.Sharded`)."""
    return a @ b


def gram(X: torch.Tensor) -> torch.Tensor:
    """X'X at full precision (reference: Linalg::cross_prod_lower, dsyrk);
    of a row-sharded X, the sum over the mesh of its blocks' Gram
    matrices."""
    if is_sharded(X):
        if X.axis != 0:
            raise ValueError("gram of a column-sharded matrix")
        return X.gram()
    return X.mT @ X


def tgram(X: torch.Tensor) -> torch.Tensor:
    """XX' at full precision (reference: Linalg::tcross_prod_lower); of a
    column-sharded X, the sum over the mesh of its blocks' products."""
    if is_sharded(X):
        if X.axis != 1:
            raise ValueError("tgram of a row-sharded matrix")
        return X.gram()
    return X @ X.mT


__all__ = [
    "power_iteration", "spectral_radius_gram", "spectral_radius_sym",
    "chol_inverse", "ridge_inverse", "dot", "gram", "tgram",
]
