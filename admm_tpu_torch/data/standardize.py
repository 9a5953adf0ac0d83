"""glmnet-compatible data standardization and coefficient recovery
(counterpart of ``admm_tpu/data/standardize.py``; reference:
src/DataStd.h:10-210).

The four modes follow the reference's ``flag = standardize + 2*intercept``:

  flag 0: fit directly (no centering, no scaling)
  flag 1: scale x and y by their 1/n-denominator standard deviations
  flag 2: center x, center+scale y
  flag 3: standardize x and y (center + scale)

Standard deviations use glmnet's ``1/n`` convention in the centered
two-pass form (reference: src/DataStd.h:39-53).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class StdStats(NamedTuple):
    """Centering/scaling statistics needed to undo the transform."""
    mean_x: torch.Tensor   # (p,)
    scale_x: torch.Tensor  # (p,)
    mean_y: torch.Tensor   # scalar
    scale_y: torch.Tensor  # scalar


def _sd_n(v: torch.Tensor, axis=None) -> torch.Tensor:
    """Standard deviation with 1/n denominator, two-pass: the
    E[x^2] - E[x]^2 shortcut cancels catastrophically in float32."""
    if axis is None:
        c = v - torch.mean(v)
        return torch.sqrt(torch.mean(c * c))
    c = v - torch.mean(v, dim=axis, keepdim=True)
    return torch.sqrt(torch.mean(c * c, dim=axis))


def _guard(scale: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A numerically zero standard deviation must not poison the fit.

    The threshold is relative to the magnitude ``ref`` (the mean): a
    constant column of value c centers to +-eps*c of rounding noise, so
    anything with sd below 8*eps*|mean| is constant at working precision
    and is left unscaled."""
    floor = 8.0 * torch.finfo(scale.dtype).eps * torch.abs(ref)
    return torch.where(scale > floor, scale, torch.ones_like(scale))


def standardize(X: torch.Tensor, y: torch.Tensor, *, standardize_x: bool,
                intercept: bool, weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, StdStats]:
    """Transform (X, y) per the reference's flag semantics.

    ``weights`` (glmnet's ``weights``): observation weights normalized to
    sum to n; moments become weighted moments and the returned rows are
    scaled by ``sqrt(w)``, so the unweighted least-squares solvers solve
    the weighted problem (an integer weight k equals repeating the row k
    times).  ``recover`` is unchanged.
    """
    flag = int(standardize_x) + 2 * int(intercept)
    dtype, dev = X.dtype, X.device
    n, p = X.shape

    if weights is not None:
        w = torch.as_tensor(weights, dtype=dtype, device=dev).reshape(-1)
        w = w * (n / torch.sum(w))

        def wmean(v, axis=None):
            ww = w if axis is None or v.dim() == 1 else w[:, None]
            return torch.sum(ww * v, dim=axis) / n

        def wsd(v, axis=None):
            m = wmean(v, axis=axis)
            c = v - (m if axis is None else m.unsqueeze(axis))
            ww = w if axis is None or v.dim() == 1 else w[:, None]
            return torch.sqrt(torch.sum(ww * c * c, dim=axis) / n)
    else:
        def wmean(v, axis=None):
            return torch.mean(v) if axis is None else torch.mean(v, dim=axis)
        wsd = _sd_n

    mean_x = torch.zeros((p,), dtype=dtype, device=dev)
    scale_x = torch.ones((p,), dtype=dtype, device=dev)
    mean_y = torch.zeros((), dtype=dtype, device=dev)
    scale_y = torch.ones((), dtype=dtype, device=dev)

    if flag == 1:
        scale_y = _guard(wsd(y), wmean(y))
        y = y / scale_y
        scale_x = _guard(wsd(X, axis=0), wmean(X, axis=0))
        X = X / scale_x
    elif flag == 2:
        my = wmean(y)
        mean_y = my
        y = y - my
        scale_y = _guard(wsd(y), my)
        y = y / scale_y
        mean_x = wmean(X, axis=0)
        X = X - mean_x
    elif flag == 3:
        my = wmean(y)
        mean_y = my
        y = y - my
        scale_y = _guard(wsd(y), my)
        y = y / scale_y
        mean_x = wmean(X, axis=0)
        scale_x = _guard(wsd(X, axis=0), mean_x)
        X = (X - mean_x) / scale_x

    if weights is not None:
        sw = torch.sqrt(w)
        X = X * sw[:, None]
        y = y * sw

    return X, y, StdStats(mean_x, scale_x, mean_y, scale_y)


def recover(stats: StdStats, coef: torch.Tensor, *, standardize_x: bool,
            intercept: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map coefficients on the transformed scale back to the original
    (reference: src/DataStd.h:157-181).  ``coef`` is (..., p); returns
    ``(beta0 (...,), coef_orig (..., p))``."""
    flag = int(standardize_x) + 2 * int(intercept)
    if flag == 0:
        beta0 = torch.zeros(coef.shape[:-1], dtype=coef.dtype,
                            device=coef.device)
        return beta0, coef
    if flag == 1:
        coef = coef / stats.scale_x * stats.scale_y
        beta0 = torch.zeros(coef.shape[:-1], dtype=coef.dtype,
                            device=coef.device)
        return beta0, coef
    if flag == 2:
        coef = coef * stats.scale_y
        beta0 = stats.mean_y - coef @ stats.mean_x
        return beta0, coef
    # flag == 3
    coef = coef / stats.scale_x * stats.scale_y
    beta0 = stats.mean_y - coef @ stats.mean_x
    return beta0, coef
