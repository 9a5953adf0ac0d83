"""Relaxed Lasso, glmnet's ``relax = TRUE`` (counterpart of
``admm_tpu/models/relaxed.py``).

The lasso's shrinkage biases the coefficients it selects; the RELAXED
lasso (Meinshausen 2007; glmnet's formulation) blends each path point with
the UNPENALIZED least-squares refit on that point's support::

    b_relaxed(lambda, gamma) = gamma * b_lasso(lambda)
                               + (1 - gamma) * b_refit(support(lambda))

``gamma = 1`` is the lasso; ``gamma = 0`` the pure refit.  The lasso path
is :func:`admm_tpu_torch.models.lasso.lasso_path` itself, so in float32
the tall scan path is one launch of the tall scan kernel.  The refits of
all L path points are the masked normal equations::

    (M X'X M + (I - M)) b = M X'y,   M = diag(support mask)

(off-support rows reduce to b_j = 0, so every system has the same shape)
with a relative jitter, which the port factors as ONE batched
``torch.linalg.cholesky_ex`` over the (L, p, p) stack.  The blend is
affine, as is coefficient recovery, so blending on the original scale
equals blending the standardized solves.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.standardize import recover, standardize
from ..interop import to_numpy
from ..linalg import gram
from .lasso import PathResult, _as_tensor, _not_ported, lasso_path


class RelaxedPathResult(NamedTuple):
    """Relaxed-lasso result: a (gamma, lambda) grid of solutions."""
    lambdas: torch.Tensor      # (L,)
    gammas: torch.Tensor       # (G,)
    beta0: torch.Tensor        # (G, L)
    coef: torch.Tensor         # (G, L, p)
    fit: PathResult            # the underlying lasso path (gamma = 1)
    refit_beta0: torch.Tensor  # (L,) unpenalized refit intercepts
    refit_coef: torch.Tensor   # (L, p) unpenalized refits (gamma = 0)


def _masked_refits(X, y, masks, weights=None, *, standardize_x, intercept):
    """(L, p) unpenalized least-squares refits restricted to each row of
    ``masks``, on the original scale: ``(beta0 (L,), coef (L, p))``.
    ``weights`` make the refit the weighted least squares of the weighted
    lasso it de-biases.  The L systems are one batched Cholesky in X's
    dtype, with the JAX package's relative jitter ``1e-6 mean(diag X'X)``
    on the support (exact LS when the support is well-posed, a ridge when
    |S| > n makes it singular)."""
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    XtX = gram(Xs)
    Xty = Xs.mT @ ys
    jit = 1e-6 * torch.mean(torch.diagonal(XtX))
    A = XtX * (masks[:, :, None] * masks[:, None, :])
    A = A + torch.diag_embed(1.0 - masks + jit * masks)
    L, _ = torch.linalg.cholesky_ex(A)
    refits = torch.cholesky_solve((masks * Xty)[:, :, None], L)[:, :, 0]
    return recover(stats, refits * masks, standardize_x=standardize_x,
                   intercept=intercept)


def relaxed_lasso_path(X, y, *, gammas=(0.0, 0.25, 0.5, 0.75, 1.0),
                       standardize: bool = True, intercept: bool = True,
                       dtype=torch.float32, device="cuda",
                       **lasso_kw) -> RelaxedPathResult:
    """Fit the relaxed-lasso (lambda, gamma) grid (module docstring).

    Same arguments and defaults as ``admm_tpu.relaxed_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  ``lasso_kw`` goes to ``lasso_path`` (lambdas/nlambda,
    eps, rho, path_mode, weights, ...).  Returns the (G, L) solution grid,
    the lasso path and the pure refits; ``gamma = 1`` reproduces the lasso
    exactly.  Coefficient limits are refused (the support refit would need
    constrained least squares).
    """
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    gam = torch.sort(_as_tensor(gammas, dtype, X.device).reshape(-1)).values
    if (lasso_kw.get("lower_limits") is not None
            or lasso_kw.get("upper_limits") is not None):
        raise NotImplementedError(
            "relaxed_lasso_path does not support coefficient limits "
            "(the support refit would need constrained least squares)")
    res = lasso_path(X, y, standardize=standardize, intercept=intercept,
                     dtype=dtype, device=X.device, **lasso_kw)
    masks = (torch.abs(res.coef) > 0).to(dtype)            # (L, p)
    w = lasso_kw.get("weights")
    w = None if w is None else _as_tensor(w, dtype, X.device).reshape(-1)
    refit_beta0, refit_coef = _masked_refits(
        X, y, masks, w, standardize_x=standardize, intercept=intercept)
    return _blend(gam, res, refit_beta0, refit_coef)


def _blend(gam, res, refit_beta0, refit_coef) -> RelaxedPathResult:
    """The affine (gamma, lambda) grid of the lasso path ``res`` and its
    support refits."""
    g = gam[:, None, None]
    coef = g * res.coef[None] + (1.0 - g) * refit_coef[None]
    beta0 = (gam[:, None] * res.beta0[None]
             + (1.0 - gam[:, None]) * refit_beta0[None])
    return RelaxedPathResult(lambdas=res.lambdas, gammas=gam, beta0=beta0,
                             coef=coef, fit=res, refit_beta0=refit_beta0,
                             refit_coef=refit_coef)


def cv_relaxed_lasso_path(X, y, *, nfolds: int = 10,
                          gammas=(0.0, 0.25, 0.5, 0.75, 1.0),
                          nlambda: int = 100, seed: int = 0, foldid=None,
                          standardize: bool = True, intercept: bool = True,
                          cv_mode: str = "auto", fold_mesh=None,
                          device="cuda", **lasso_kw):
    """Cross-validate the (lambda, gamma) grid jointly (glmnet's
    ``cv.glmnet(..., relax = TRUE)``).

    Same arguments and defaults as ``admm_tpu.cv_relaxed_lasso_path``, plus
    ``device``.  Each fold's lasso path and support refits are computed
    once and every gamma is scored by blending the two linear predictors.
    ``cv_mode``: "onepass" (the default through "auto" for the plain
    argument surface) runs fold f as the weighted batch path with weight 0
    on its rows, fold after fold on the device (in float32 one launch of
    the tall or wide batch kernel each), with the weighted refits; "loop"
    fits each training subset (the fallback when other lasso arguments
    are given).  Returns a dict with the (G, L) ``cvm``/``cvsd``, the
    selected ``lambda_min``/``gamma_min``, the full-data
    :class:`RelaxedPathResult` and the foldid.  ``fold_mesh`` is not
    ported yet and raises ``NotImplementedError``.
    """
    from .cv import _cv_foldid, _fold_sweep
    from .lasso import _path_user

    _not_ported(fold_mesh=fold_mesh)
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    dtype = lasso_kw.get("dtype") or torch.float32
    y_np = np.asarray(to_numpy(y), np.float64).ravel()
    gam_np = np.sort(np.asarray(gammas, np.float64).ravel())
    Xt = _as_tensor(X, dtype, device)
    n = Xt.shape[0]
    yt = torch.as_tensor(y_np, dtype=dtype, device=Xt.device)
    full = relaxed_lasso_path(Xt, yt, gammas=gam_np, standardize=standardize,
                              intercept=intercept, nlambda=nlambda,
                              device=Xt.device, **lasso_kw)
    lams = to_numpy(full.lambdas).astype(np.float64)
    lasso_kw.pop("lambdas", None)   # the folds get the shared grid
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)

    simple = not (set(lasso_kw)
                  - {"alpha", "weights", "rho", "maxit", "eps_abs",
                     "eps_rel", "lambda_min_ratio", "dtype",
                     "_enet_scale"})
    onepass = cv_mode != "loop" and simple
    if cv_mode == "onepass" and not simple:
        raise ValueError("cv_mode='onepass' supports the plain relaxed "
                         "argument surface (alpha/weights/rho/maxit/"
                         "eps); drop the extra arguments or use "
                         "cv_mode='loop'")
    G, L = gam_np.shape[0], lams.shape[0]
    if onepass:
        w = lasso_kw.get("weights")
        masks = (foldid[None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        if w is not None:
            masks = masks * np.asarray(to_numpy(w), np.float64).ravel()[None]
        masks_t = torch.as_tensor(masks, dtype=dtype, device=Xt.device)
        lams_t = torch.as_tensor(lams, dtype=dtype, device=Xt.device)
        gam_t = torch.as_tensor(gam_np, dtype=dtype, device=Xt.device)

        def solve_fold(mask):
            """One fold's lasso path (lanes ``0..L-1``) and its refits
            (``L..2L-1``) as one path-shaped result, so the fold sweep forms
            both linear predictors."""
            res = _path_user(
                Xt, yt, lams_t, lasso_kw.get("rho", -1.0),
                lasso_kw.get("maxit", 10000), lasso_kw.get("eps_abs", 1e-5),
                lasso_kw.get("eps_rel", 1e-5), lasso_kw.get("alpha", 1.0),
                mask, standardize_x=standardize, intercept=intercept,
                enet_scale=bool(lasso_kw.get("_enet_scale", False)),
                path_mode="batch")
            supp = (torch.abs(res.coef) > 0).to(dtype)
            rb0, rcoef = _masked_refits(Xt, yt, supp, mask,
                                        standardize_x=standardize,
                                        intercept=intercept)
            return PathResult(lambdas=None,
                              beta0=torch.cat([res.beta0, rb0]),
                              coef=torch.cat([res.coef, rcoef]), niter=None)

        eta = _fold_sweep(Xt, masks_t, np.clip(foldid, 0, None), solve_fold)
        eta_l, eta_r = eta[:, :L], eta[:, L:]                # (n, L) each
        g = gam_t[None, :, None]
        eta_all = g * eta_l[:, None, :] + (1.0 - g) * eta_r[:, None, :]
        err = (to_numpy(eta_all).astype(np.float64)
               - y_np[:, None, None]) ** 2                     # (n, G, L)
    else:
        X_np = np.asarray(to_numpy(X), np.float64)
        err = np.full((n, G, L), np.nan)
        for f in range(nfolds):
            tr = foldid != f
            va = foldid == f
            kw_f = dict(lasso_kw)
            if kw_f.get("weights") is not None:
                kw_f["weights"] = np.asarray(
                    to_numpy(kw_f["weights"]), np.float64).ravel()[tr]
            rf = relaxed_lasso_path(X_np[tr], y_np[tr], gammas=gam_np,
                                    standardize=standardize,
                                    intercept=intercept, lambdas=lams,
                                    device=Xt.device, **kw_f)
            pred = (to_numpy(rf.beta0).astype(np.float64)[:, :, None]
                    + np.einsum("vp,glp->glv", X_np[va],
                                to_numpy(rf.coef).astype(np.float64)))
            err[va] = ((pred - y_np[va][None, None, :]) ** 2
                       ).transpose(2, 0, 1)

    scored = foldid >= 0
    n_sc = int(scored.sum())
    w_all = lasso_kw.get("weights")
    if w_all is None:
        cvm = err[scored].mean(axis=0)               # (G, L)
        cvsd = np.sqrt(((err[scored] - cvm) ** 2).mean(axis=0)
                       / (n_sc - 1))
    else:
        # glmnet's weighted cvm/cvsd (cv.py::_cv_curve convention).
        ws = np.asarray(to_numpy(w_all), np.float64).ravel()[scored]
        cvm = ((ws[:, None, None] * err[scored]).sum(axis=0) / ws.sum())
        cvsd = np.sqrt((ws[:, None, None] * (err[scored] - cvm) ** 2)
                       .sum(axis=0) / ws.sum() / (n_sc - 1))
    gi, li = np.unravel_index(int(np.argmin(cvm)), cvm.shape)
    return dict(lambdas=lams, gammas=gam_np, cvm=cvm, cvsd=cvsd,
                lambda_min=float(lams[li]), gamma_min=float(gam_np[gi]),
                fit=full, foldid=foldid)
