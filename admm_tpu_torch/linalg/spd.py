"""SPD inverses built once, so that each ADMM iteration is one product
(counterpart of ``admm_tpu/linalg/spd.py``).

The reference caches a Cholesky factor and runs two triangular solves
per iteration (reference: src/ADMMLassoTall.h:70-80, :191-205).  The port
keeps the JAX package's design: one explicit inverse, after which the
x-update is a single matrix-vector product inside the path kernels.
These run once per path, outside any kernel, through
``torch.linalg.cholesky`` and ``torch.cholesky_inverse``.
"""
from __future__ import annotations

import torch


def chol_inverse(S: torch.Tensor, *, jitter: float = 0.0) -> torch.Tensor:
    """Explicit inverse of a symmetric positive-definite matrix via its
    Cholesky factor.  ``jitter`` adds ``jitter * mean(diag(S))`` to the
    diagonal first (the unregularised LAD/BP Gram matrices,
    reference: src/ADMMLAD.h:185-189)."""
    k = S.shape[0]
    if jitter:
        eye = torch.eye(k, dtype=S.dtype, device=S.device)
        S = S + (jitter * torch.mean(torch.diagonal(S))) * eye
    L = torch.linalg.cholesky(S)
    return torch.cholesky_inverse(L)


def ridge_inverse(S: torch.Tensor, rho) -> torch.Tensor:
    """Inverse of ``S + rho I`` for SPD ``S`` (the ADMM x-update system)."""
    k = S.shape[0]
    return chol_inverse(S + rho * torch.eye(k, dtype=S.dtype,
                                            device=S.device))
