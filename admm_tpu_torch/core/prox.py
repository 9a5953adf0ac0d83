"""Proximal operators used by the ADMM solvers.

PyTorch counterparts of ``admm_tpu/core/prox.py`` (reference:
src/ADMMLassoTall.h:55-69, src/ADMMEnet.h:24-40,
src/TODO/ADMMDantzig.h:164-181).  Everything stays dense; reductions run
over the LAST axis, so a leading lane axis (one row per lambda) passes
through unchanged.
"""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, penalty) -> torch.Tensor:
    """Elementwise soft-thresholding prox of ``penalty * ||.||_1``.

    prox(v)_i = sign(v_i) * max(|v_i| - penalty, 0)
    """
    return torch.sign(v) * torch.clamp(torch.abs(v) - penalty, min=0.0)


def enet_prox(v: torch.Tensor, penalty, alpha) -> torch.Tensor:
    """Prox of ``penalty * (alpha*||.||_1 + (1-alpha)/2*||.||_2^2)``.

    prox(v)_i = sign(v_i) * max(|v_i| - alpha*penalty, 0) / (1 + penalty*(1-alpha))

    Matches the reference's ``enet()`` kernel (reference: src/ADMMEnet.h:24-40).
    """
    thresh = alpha * penalty
    denom = 1.0 + penalty * (1.0 - alpha)
    return (torch.sign(v) * torch.clamp(torch.abs(v) - thresh, min=0.0)
            / denom)


def box_clamp_neg(v: torch.Tensor, radius) -> torch.Tensor:
    """z-update of the Dantzig selector: ``z = -clip(v, -radius, radius)``
    (reference: src/TODO/ADMMDantzig.h:164-181)."""
    return -torch.clamp(v, -radius, radius)


def l2norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (dtype-preserving)."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def sqnorm(v: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean norm over the last axis."""
    return torch.sum(v * v, dim=-1)
