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

X may be row-sharded over a mesh
(:class:`admm_tpu_torch.parallel.mesh.Sharded`, y replicated).  X's
moments are sums over its blocks of the blocks' partial moments, over
the true n (no padded rows), in the two passes of the centered form; a
block's mean enters scaled by its share of the rows, so a plain X (one
block) gets the plain two-pass bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..diag import profile
from ..parallel.mesh import rowsum


class StdStats(NamedTuple):
    """Centering/scaling statistics needed to undo the transform."""
    mean_x: torch.Tensor   # (p,)
    scale_x: torch.Tensor  # (p,)
    mean_y: torch.Tensor   # scalar
    scale_y: torch.Tensor  # scalar


def _sd_n(v: torch.Tensor) -> torch.Tensor:
    """Standard deviation of a vector with 1/n denominator, two-pass: the
    E[x^2] - E[x]^2 shortcut cancels catastrophically in float32."""
    c = v - torch.mean(v)
    return torch.sqrt(torch.mean(c * c))


def _guard(scale: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A numerically zero standard deviation must not poison the fit.

    The threshold is relative to the magnitude ``ref`` (the mean): a
    constant column of value c centers to +-eps*c of rounding noise, so
    anything with sd below 8*eps*|mean| is constant at working precision
    and is left unscaled."""
    floor = 8.0 * torch.finfo(scale.dtype).eps * torch.abs(ref)
    return torch.where(scale > floor, scale, torch.ones_like(scale))


def col_mean(X) -> torch.Tensor:
    """Column means of X, plain or row-sharded: the sum over the mesh of
    each block's mean times its share of the rows (one block: the plain
    mean's bits, times 1)."""
    n = X.shape[0]
    return rowsum(X, lambda b, sl: torch.mean(b, dim=0) * (b.shape[0] / n))


def wcolsum(X, w, squared: bool = False) -> torch.Tensor:
    """``sum_i w_i x_i`` (``squared``: ``sum_i w_i x_i^2``) over the rows
    of X; of a row-sharded X, a sum over the mesh."""
    if squared:
        return rowsum(X, lambda b, sl: torch.sum(w[sl, None] * b * b, dim=0))
    return rowsum(X, lambda b, sl: torch.sum(w[sl, None] * b, dim=0))


def _x_moments(X, w, n):
    """Column mean and 1/n standard deviation of X, plain or row-sharded
    (``w`` the normalized weights or None), as ``(mean_fn, sd_fn)``: the
    two passes of :func:`_sd_n`, each a sum over the blocks."""
    if w is None:
        def mean():
            return col_mean(X)

        def sd():
            m = mean()

            def part(b, sl):
                c = b - m
                return torch.mean(c * c, dim=0) * (b.shape[0] / n)
            return torch.sqrt(rowsum(X, part))
    else:
        def mean():
            return wcolsum(X, w) / n

        def sd():
            m = mean()

            def part(b, sl):
                c = b - m.unsqueeze(0)
                return torch.sum(w[sl, None] * c * c, dim=0)
            return torch.sqrt(rowsum(X, part) / n)
    return mean, sd


@profile.spanned("setup")
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

    # y's moments here; X's, plain or sharded, in _x_moments.
    if weights is not None:
        w = torch.as_tensor(weights, dtype=dtype, device=dev).reshape(-1)
        w = w * (n / torch.sum(w))

        def wmean(v):
            return torch.sum(w * v) / n

        def wsd(v):
            c = v - wmean(v)
            return torch.sqrt(torch.sum(w * c * c) / n)
    else:
        wmean, wsd = torch.mean, _sd_n

    xmean, xsd = _x_moments(X, None if weights is None else w, n)

    mean_x = torch.zeros((p,), dtype=dtype, device=dev)
    scale_x = torch.ones((p,), dtype=dtype, device=dev)
    mean_y = torch.zeros((), dtype=dtype, device=dev)
    scale_y = torch.ones((), dtype=dtype, device=dev)

    if flag == 1:
        scale_y = _guard(wsd(y), wmean(y))
        y = y / scale_y
        scale_x = _guard(xsd(), xmean())
        X = X / scale_x
    elif flag == 2:
        my = wmean(y)
        mean_y = my
        y = y - my
        scale_y = _guard(wsd(y), my)
        y = y / scale_y
        mean_x = xmean()
        X = X - mean_x
    elif flag == 3:
        my = wmean(y)
        mean_y = my
        y = y - my
        scale_y = _guard(wsd(y), my)
        y = y / scale_y
        mean_x = xmean()
        scale_x = _guard(xsd(), mean_x)
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
