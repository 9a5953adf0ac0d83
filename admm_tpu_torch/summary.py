"""glmnet-style per-lambda path summary: Df / %Dev / Lambda (counterpart of
``admm_tpu/summary.py``).

glmnet's ``print.glmnet`` table for a finished gaussian or GLM
``PathResult``: the number of exactly nonzero coefficients and the
fraction of the null deviance explained at every grid point.  Float64 on
the device of the fit's coefficients, numpy out; the deviances are the
CV losses of :mod:`admm_tpu_torch.models.cv` (``GLMFamily.cv_loss``), so
``1 - dev/nulldev`` agrees with what the ``cv_*_path`` drivers score.  A
``CoxPathResult`` is scored by its partial likelihood, in float64 numpy
on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .interop import to_numpy
from .predict import _device_of, _f64, _linear_predictor


class PathTable(NamedTuple):
    df: np.ndarray         # (nlambda,) exact nonzero coefficient counts
    dev_ratio: np.ndarray  # (nlambda,) 1 - deviance/null_deviance
    lambdas: np.ndarray    # (nlambda,) the penalty grid
    nulldev: float = 0.0   # the null (intercept-only) deviance


def _resolve_family(family):
    """None/'gaussian' -> None (squared error); a GLMFamily or factory
    -> the family instance."""
    if family is None or family == "gaussian":
        return None
    from .models.glm import GLMFamily

    fam = family() if callable(family) and not isinstance(
        family, GLMFamily) else family
    if not isinstance(fam, GLMFamily):
        raise ValueError("family must be 'gaussian', a GLMFamily or a "
                         "family factory (binomial, poisson, huber)")
    return fam


def _null_eta(fam, y, w):
    """Intercept-only linear predictor, a 0-d tensor: the root of the
    weighted score ``sum w grad_eta(b0, y) = 0``, by bisection on the data
    bracket (the loss is convex in eta, so the score is monotone), with
    no read on the host."""
    if fam is None:
        return torch.mean(y) if w is None else torch.sum(w * y) / torch.sum(w)

    def score(b0):
        g = fam.grad_eta(b0.expand_as(y), y)
        return torch.sum(g if w is None else w * g)

    lo, hi = torch.min(y) - 30.0, torch.max(y) + 30.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        below = score(mid) < 0.0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def path_table(result, X, y, *, family="gaussian",
               weights: Optional[np.ndarray] = None) -> PathTable:
    """Per-lambda ``Df`` (exact nonzeros), ``%Dev`` (fraction of the null
    deviance explained) and ``Lambda`` of a fitted path, glmnet's
    ``print.glmnet`` columns.

    ``family``: 'gaussian' (default, squared-error deviance) or the GLM
    family the path was fit with (the deviance is the family's
    per-observation CV loss; poisson's is the exact saturated-model
    deviance).  ``weights``: the observation weights of the fit; the
    deviances become weighted sums.
    """
    from .models.cox import CoxPathResult
    from .models.lasso import PathResult

    if isinstance(result, CoxPathResult):
        return _cox_table(result, X, y, weights)
    if not isinstance(result, PathResult):
        raise TypeError(f"path_table does not take "
                        f"{result.__class__.__name__} results in "
                        "admm_tpu_torch yet")
    fam = _resolve_family(family)
    device = _device_of(result)
    y = _f64(y, device)
    w = None if weights is None else _f64(weights, device)
    df = to_numpy(torch.count_nonzero(result.coef, dim=1)) \
        if isinstance(result.coef, torch.Tensor) \
        else np.count_nonzero(result.coef, axis=1)
    lams = np.asarray(to_numpy(result.lambdas), np.float64)

    eta = _linear_predictor(result, X, None)      # (L, n)
    b0 = _null_eta(fam, y, w)
    if fam is None:
        per_obs = (eta - y[None, :]) ** 2
        null_per = (y - b0) ** 2
    elif fam.name == "poisson":
        # The saturated-model deviance 2[y log(y/mu) - (y - mu)]: the
        # y log y - y term cancels in deviance differences but not in the
        # %Dev denominator.
        ylogy = torch.where(y > 0, y * torch.log(torch.clamp(y, min=1e-300)),
                            torch.zeros_like(y))

        def pdev(e):
            return 2.0 * (ylogy - y * e - (y - torch.exp(e)))

        per_obs = pdev(eta)
        null_per = pdev(b0.expand(1, y.numel()))[0]
    else:
        # binomial's cv_loss is the exact deviance for y in {0, 1};
        # huber's has no canonical deviance, its CV loss is reported.
        per_obs = fam.cv_loss(eta, y)
        null_per = fam.cv_loss(b0.expand(1, y.numel()), y)[0]

    if w is not None:
        per_obs = per_obs * w[None, :]
        null_per = null_per * w
    dev = to_numpy(per_obs.sum(dim=1))
    nulldev = float(null_per.sum())
    dev_ratio = (nulldev - dev) / nulldev if nulldev > 0 else \
        np.zeros_like(dev)
    return PathTable(df=df, dev_ratio=dev_ratio, lambdas=lams,
                     nulldev=nulldev)


def _cox_table(result, X, y, weights):
    """glmnet's print for family='cox': deviance -2 log partial
    likelihood (``models.cox._breslow_pl``, float64 numpy on the host),
    the null deviance at beta = 0; ``y`` is an (n, 2) [time, event] or
    (n, 3) [start, stop, event] array."""
    from .models.cox import _breslow_pl

    yz = np.asarray(to_numpy(y), np.float64)
    if yz.ndim == 2 and yz.shape[1] == 3:
        start, t, d = yz[:, 0], yz[:, 1], yz[:, 2]
    elif yz.ndim == 2 and yz.shape[1] == 2:
        (t, d), start = (yz[:, 0], yz[:, 1]), None
    else:
        raise ValueError("cox path_table needs y as an (n, 2) [time, "
                         "event] or (n, 3) [start, stop, event] array")
    X = np.asarray(to_numpy(X), np.float64)
    w = None if weights is None else np.asarray(to_numpy(weights))
    coef = np.asarray(to_numpy(result.coef), np.float64)
    dev = -2.0 * _breslow_pl(X, t, d, coef, w, None, None, start)
    nulldev = float(-2.0 * _breslow_pl(X, t, d, np.zeros((1, coef.shape[1])),
                                       w, None, None, start)[0])
    dev_ratio = ((nulldev - dev) / nulldev if nulldev > 0
                 else np.zeros_like(dev))
    return PathTable(df=np.count_nonzero(coef, axis=1), dev_ratio=dev_ratio,
                     lambdas=np.asarray(to_numpy(result.lambdas), np.float64),
                     nulldev=nulldev)


def deviance(result, X, y, *, family="gaussian", weights=None):
    """Residual deviance per path point (glmnet's ``deviance.glmnet``):
    ``(1 - dev.ratio) * nulldev``."""
    t = path_table(result, X, y, family=family, weights=weights)
    return (1.0 - t.dev_ratio) * t.nulldev


def format_path_table(table: PathTable) -> str:
    """A :class:`PathTable` as glmnet's printed table."""
    lines = [f"{'Df':>6} {'%Dev':>8} {'Lambda':>10}"]
    for d, r, l in zip(table.df, table.dev_ratio, table.lambdas):
        lines.append(f"{int(d):>6} {100.0 * r:>7.2f}% {l:>10.5f}")
    return "\n".join(lines)
