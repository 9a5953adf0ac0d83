"""Matplotlib equivalents of the reference's ggplot2 fit plots
(counterpart of ``admm_tpu/plotting.py``).

Reference plots: the solution path (R/30_admm_lasso.R:189-214), the
Basis-Pursuit coefficient stem plot (R/10_admm_bp.R:152-163) and the LAD
fitted-vs-observed scatter (R/20_admm_lad.R:87-100); glmnet's
``plot.glmnet``, ``plot.cv.glmnet`` and ``plot(survfit(...))``.  Every
helper takes the port's result types, with tensors on any device, as well
as numpy arrays; matplotlib is imported only when an axis is made.
"""
from __future__ import annotations

import numpy as np

from .interop import to_numpy


def _np(a) -> np.ndarray:
    """A tensor (any device), scipy sparse matrix or array as numpy."""
    if hasattr(a, "todense"):
        return np.asarray(a.todense())
    return to_numpy(a)


def _get_ax(ax):
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt

    _, ax = plt.subplots()
    return ax


def plot_solution_path(lambdas, beta, ax=None):
    """Coefficient paths against log(lambda); the intercept row and the
    all-zero variables are left out, as the reference does."""
    lambdas = _np(lambdas)
    if lambdas.size < 2:
        raise ValueError("need to have at least two lambda values")
    coef = _np(beta)[1:, :]  # drop the intercept row
    keep = np.any(coef != 0, axis=1)
    ax = _get_ax(ax)
    loglam = np.log(lambdas)
    for row in coef[keep]:
        ax.plot(loglam, row, lw=1)
    ax.set_xlabel(r"$\log(\lambda)$")
    ax.set_ylabel("Coefficients")
    ax.set_title("Solution path")
    return ax


def plot_path(result, xvar: str = "norm", label: bool = False, ax=None,
              X=None, y=None, family="gaussian", weights=None):
    """glmnet's ``plot.glmnet``: coefficient profiles against the chosen
    horizontal axis, with the nonzero count (Df) on a top axis.

    ``xvar``: 'norm' (the L1 norm of the coefficients, glmnet's default),
    'lambda' (log lambda) or 'dev' (the fraction of null deviance
    explained; pass the training ``X``/``y`` and ``family``/``weights``).
    ``label=True`` writes each curve's variable index at its right end.
    ``result`` is any vector-coefficient path result (gaussian, GLM, Cox).
    """
    coef = _np(result.coef)
    if coef.ndim != 2:
        raise ValueError("plot_path needs a vector-coefficient path "
                         "(matrix families: plot per response/class)")
    lambdas = _np(result.lambdas)
    if xvar == "norm":
        xs = np.abs(coef).sum(axis=1)
        xlabel = "L1 Norm"
    elif xvar == "lambda":
        xs = np.log(lambdas)
        xlabel = r"$\log(\lambda)$"
    elif xvar == "dev":
        if X is None or y is None:
            raise ValueError("xvar='dev' needs X= and y= (the training "
                             "data) to compute the deviance column")
        from .summary import path_table

        xs = _np(path_table(result, X, y, family=family,
                            weights=weights).dev_ratio)
        xlabel = "Fraction Deviance Explained"
    else:
        raise ValueError("xvar must be 'norm', 'lambda' or 'dev'")
    ax = _get_ax(ax)
    for j in np.flatnonzero(np.any(coef != 0, axis=0)):
        ax.plot(xs, coef[:, j], lw=1)
        if label:
            ax.annotate(str(j), (xs[-1], coef[-1, j]), fontsize=8,
                        xytext=(3, 0), textcoords="offset points")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Coefficients")
    # glmnet's top axis: Df at a handful of x positions.
    df = (coef != 0).sum(axis=1)
    top = ax.secondary_xaxis("top")
    ticks = np.linspace(0, xs.size - 1, min(6, xs.size)).astype(int)
    order = np.argsort(xs[ticks])
    top.set_xticks(xs[ticks][order])
    top.set_xticklabels(df[ticks][order].astype(int))
    top.set_xlabel("Df")
    return ax


def plot_stem(coef, ax=None):
    """Stem plot of Basis-Pursuit coefficients."""
    coef = _np(coef).ravel()
    ax = _get_ax(ax)
    idx = np.arange(coef.size)
    nz = coef != 0
    if nz.any():  # matplotlib's stem refuses empty arrays
        ax.stem(idx[nz], coef[nz])
    ax.axhline(0.0, color="black", lw=0.5)
    ax.set_xlabel("Index")
    ax.set_ylabel("Coefficient")
    ax.set_title("Basis Pursuit solution")
    return ax


def plot_fitted_vs_observed(fitted, observed, ax=None):
    """LAD diagnostic: fitted against observed, with the identity line."""
    fitted, observed = _np(fitted), _np(observed)
    ax = _get_ax(ax)
    ax.scatter(observed, fitted, s=8, alpha=0.6)
    lo = min(np.min(observed), np.min(fitted))
    hi = max(np.max(observed), np.max(fitted))
    ax.plot([lo, hi], [lo, hi], color="red", lw=1)
    ax.set_xlabel("Observed")
    ax.set_ylabel("Fitted")
    ax.set_title("LAD fit")
    return ax


def plot_cv_curve(cv, ax=None):
    """glmnet's ``plot.cv.glmnet``: the mean CV loss with one-standard-
    error bars against log(lambda), dashed lines at ``lambda_min`` and
    ``lambda_1se``, and the nonzero count of the full-data fit on a top
    axis.  ``cv`` is any :class:`~admm_tpu_torch.models.cv.CVResult`."""
    ax = _get_ax(ax)
    loglam = np.log(_np(cv.lambdas))
    ax.errorbar(loglam, _np(cv.cvm), yerr=_np(cv.cvsd), fmt="o", ms=3,
                color="red", ecolor="grey", elinewidth=1, capsize=2)
    ax.axvline(np.log(float(cv.lambda_min)), ls="--", lw=1, color="black")
    ax.axvline(np.log(float(cv.lambda_1se)), ls="--", lw=1, color="black")
    ax.set_xlabel(r"$\log(\lambda)$")
    ax.set_ylabel("CV loss")
    ax.set_title("Cross-validation curve")
    if getattr(cv, "fit", None) is not None:
        nz = np.count_nonzero(_np(cv.fit.coef), axis=-1)
        top = ax.secondary_xaxis("top")
        step = max(1, loglam.size // 8)
        top.set_xticks(loglam[::step])
        top.set_xticklabels([str(int(k)) for k in nz[::step]])
    return ax


def plot_survfit(sf, ax=None, max_curves: int = 50):
    """Step plot of the survival curves of
    :func:`admm_tpu_torch.survfit_cox` (glmnet's ``plot(survfit(...))``):
    one step line per column of ``sf.surv`` (at most ``max_curves``,
    evenly subsampled).  Takes one ``SurvFit`` or the dict of a
    stratified fit (one group of lines per stratum)."""
    ax = _get_ax(ax)
    items = sf.items() if isinstance(sf, dict) else [(None, sf)]
    for label, f in items:
        t = _np(f.time)
        S = _np(f.surv)
        cols = np.linspace(0, S.shape[1] - 1,
                           min(max_curves, S.shape[1])).astype(int)
        for j, c in enumerate(np.unique(cols)):
            ax.step(t, S[:, c], where="post", alpha=0.6,
                    label=(f"stratum {label}" if label is not None
                           and j == 0 else None))
    ax.set_xlabel("time")
    ax.set_ylabel("S(t | x)")
    ax.set_ylim(0.0, 1.02)
    if isinstance(sf, dict):
        ax.legend()
    return ax


__all__ = ["plot_solution_path", "plot_path", "plot_stem",
           "plot_fitted_vs_observed", "plot_cv_curve", "plot_survfit"]
