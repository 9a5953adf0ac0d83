"""Robust PCA's singular-value thresholding (counterpart of
``svt`` in ``admm_tpu/models/rpca.py``).

Only the prox is ported so far: the multitask path's nuclear penalty
(:func:`admm_tpu_torch.models.multitask.multitask_nuclear_path`) uses it.
"""
from __future__ import annotations

import torch


def svt(A, tau):
    """Singular-value thresholding, the prox of ``tau * ||.||_*``, of a
    matrix or of a batch of matrices (``(..., m, n)``; ``tau`` a scalar or
    broadcastable against the ``(..., min(m, n))`` singular values).  The
    reconstruction is a full-float32 product: it feeds the Boyd
    residuals."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    return (U * torch.clamp(s - tau, min=0.0)[..., None, :]) @ Vh
