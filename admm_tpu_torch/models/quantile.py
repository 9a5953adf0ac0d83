"""l1-penalized QUANTILE regression paths (counterpart of
``admm_tpu/models/quantile.py``; an extension beyond the reference)::

    minimize_b0,b  (1/n) sum_i w_i rho_tau(y_i - b0 - x_i'b) + lam ||b||_1,
    rho_tau(r) = tau max(r, 0) + (1 - tau) max(-r, 0)

the lambda-path completion of :func:`admm_tpu_torch.lad.quantile_fit`.
The splitting is the sqrt-lasso's stacked form
(:func:`admm_tpu_torch.models.sqrtlasso._stacked_ops`): one cached
``(X'X + I)^{-1}`` product per x-update, the weighted asymmetric soft
threshold (the check-loss prox, ``lad._asym_soft_threshold``) on the
residual block, and a soft threshold with factor 0 on the free intercept
column, so the intercept is optimized under the check loss.  FADMM at a
fixed rho, 10 by default (the JAX package's DESIGN.md "quantile rho",
measured on the TPU: rho >= 30 lets the check loss's flat pieces pass the
Boyd test far from the optimum).

A tau grid and a lambda grid batch together as (T x L) lanes of one
engine loop; each lane's tau is a per-lane column of the r-prox (the JAX
package carries it in ``state.aux``).  No kernel: every path runs on the
engines.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ADMMState, col, make_batched_solver,
                           make_fadmm_solver, make_state, make_traced_solve,
                           warm_start)
from ..core.prox import soft_threshold
from ..data.standardize import _guard
from ..interop import to_numpy
from ..linalg import chol_inverse, gram
from .lad import _asym_soft_threshold
from .lasso import _as_tensor, _linspace
from .sqrtlasso import _stacked_ops


class QuantilePathResult(NamedTuple):
    """tau x lambda grid of penalized quantile fits."""
    taus: torch.Tensor      # (T,)
    lambdas: torch.Tensor   # (T, L) per-tau grids, decreasing in L
    beta0: torch.Tensor     # (T, L)
    coef: torch.Tensor      # (T, L, p)
    niter: torch.Tensor     # (T, L) int32
    # (T, L, trace_len, 5) per-iteration residual buffers when tracing was
    # requested (admm_tpu_torch.diag.trace conventions).
    trace: Optional[torch.Tensor] = None


def _quantile_prepare(X, y, weights, *, standardize_x, intercept):
    """Weighted centering and scaling WITHOUT sqrt(w) row scaling: the
    check loss is 1-homogeneous, so the weights enter the r-prox
    thresholds instead.  Returns ``(Xs, ys, w, sd_x, sd_y, mean_x,
    mean_y)``."""
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    w = torch.ones((n,), dtype=dtype, device=dev)
    if weights is not None:
        w = weights.reshape(-1).to(dtype)
        w = w * (n / torch.sum(w))

    def wmean(v, axis=None):
        ww = w if v.dim() == 1 else w[:, None]
        return torch.sum(ww * v, dim=axis) / n

    mean_x = torch.zeros((p,), dtype=dtype, device=dev)
    mean_y = torch.zeros((), dtype=dtype, device=dev)
    sd_x = torch.ones((p,), dtype=dtype, device=dev)
    sd_y = torch.ones((), dtype=dtype, device=dev)
    Xs, ys = X, y
    if intercept:
        mean_x = wmean(X, axis=0)
        mean_y = wmean(y)
        Xs = X - mean_x[None, :]
        ys = y - mean_y
    if standardize_x:
        cm = wmean(X, axis=0)
        cx = X - cm[None, :]
        sd_x = _guard(torch.sqrt(torch.sum(w[:, None] * cx * cx, dim=0) / n),
                      cm)
        Xs = Xs / sd_x[None, :]
        my = wmean(y)
        cy = y - my
        sd_y = _guard(torch.sqrt(torch.sum(w * cy * cy) / n), my)
        ys = ys / sd_y
    return Xs, ys, w, sd_x, sd_y, mean_x, mean_y


def _quantile_ops(Xa, ys, Minv, w, pf, n, q, tau):
    """Stacked ops with the weighted check-loss r-prox at level ``tau``
    (a scalar, or a per-lane column for a batch of (tau, lambda) lanes)."""
    def prox_r(st, vr):
        rho = col(st.rho)
        return _asym_soft_threshold(vr, w * tau / rho,
                                    w * (1.0 - tau) / rho)

    def prox_w(st, vw):
        return soft_threshold(vw, col(st.lam / st.rho) * pf)

    return _stacked_ops(Xa, ys, Minv, n, q, prox_r, prox_w)


def _quantile_setup(Xs, intercept, rho0):
    """The free-intercept design, its penalty factors, the cached inverse
    and rho (10 unless given: the module docstring)."""
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    if intercept:
        Xa = torch.cat([torch.ones((n, 1), dtype=dtype, device=dev), Xs],
                       dim=1)
        pf = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                        torch.ones((p,), dtype=dtype, device=dev)])
    else:
        Xa = Xs
        pf = torch.ones((p,), dtype=dtype, device=dev)
    q = Xa.shape[1]
    Minv = chol_inverse(gram(Xa) + torch.eye(q, dtype=dtype, device=dev),
                        jitter=1e-7 if dtype == torch.float32 else 0.0)
    rho = torch.tensor(rho0 if rho0 > 0 else 10.0, dtype=dtype, device=dev)
    return Xa, pf, q, Minv, rho


def _quantile_lam0(Xs, ys, w, tau, n, intercept):
    """The null threshold, exact up to ties: with b = 0 the optimal free
    intercept is the weighted tau-quantile a (0 without an intercept), and
    b = 0 stays optimal iff ilam >= max_j |sum_i x_ij g_i| with g the
    check-loss subgradient; rows at the quantile add their largest
    subgradient, so ties give a safe upper bound.  The quantile is the
    sorted-cumulative-weight rule; the sort is stable, so ties in y take
    the JAX package's order."""
    if intercept:
        order = torch.argsort(ys, stable=True)
        cw = torch.cumsum(w[order], dim=0)
        k = torch.searchsorted(cw, (tau * cw[-1]).reshape(1))
        a = ys[order][torch.clamp(k, max=n - 1)][0]
    else:
        a = torch.zeros((), dtype=ys.dtype, device=ys.device)
    r = ys - a
    zero = torch.zeros_like(r)
    g = w * torch.where(r > 0, tau + zero, torch.where(r < 0, -(1.0 - tau)
                                                       + zero, zero))
    tie = w * (r == 0) * torch.maximum(tau, 1.0 - tau)
    return torch.max(torch.abs(g @ Xs) + tie @ torch.abs(Xs))


def _cold_lanes(k, q, n, rho, ilams):
    dtype, dev = ilams.dtype, ilams.device
    zeros = torch.zeros((k, q), dtype=dtype, device=dev)
    znq = torch.zeros((k, n + q), dtype=dtype, device=dev)
    ones = torch.ones((k,), dtype=dtype, device=dev)
    return ADMMState(
        x=zeros, z=znq, y=znq, adj_z=znq, adj_y=znq,
        aux=torch.zeros((k, n), dtype=dtype, device=dev),
        adj_a=ones, adj_c=9999.0 * ones, rho=rho * ones, lam=ilams.clone(),
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        it=torch.zeros((k,), dtype=torch.int32, device=dev),
        done=torch.zeros((k,), dtype=torch.bool, device=dev))


def _quantile_path_dev(X, y, taus, nlambda, lambda_min_ratio, user_lams,
                       rho0, maxit, eps_abs, eps_rel, weights=None, *,
                       standardize_x, intercept, path_mode, trace_len=None):
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    Xs, ys, w, sd_x, sd_y, mean_x, mean_y = _quantile_prepare(
        X, y, weights, standardize_x=standardize_x, intercept=intercept)
    Xa, pf, q, Minv, rho = _quantile_setup(Xs, intercept, rho0)
    T = taus.shape[0]
    if user_lams is None:
        # Per-tau grids from each tau's own null threshold.
        lam0s = torch.stack([_quantile_lam0(Xs, ys, w, t, n, intercept)
                             for t in taus]) * sd_y / n * (1.0 + 1e-4)
        lams = torch.exp(torch.stack([
            _linspace(torch.log(l0), torch.log(lambda_min_ratio * l0),
                      nlambda) for l0 in lam0s]))
    elif user_lams.dim() == 2:
        lams = user_lams          # per-tau grids (the CV fold sweep)
    else:
        lams = torch.broadcast_to(user_lams[None, :], (T,) + user_lams.shape)
    L = lams.shape[1]
    ilams = lams * n / sd_y
    traces = None
    if path_mode == "batch":
        tau_l = col(taus.repeat_interleave(L))
        solve = make_batched_solver(make_fadmm_solver(
            _quantile_ops(Xa, ys, Minv, w, pf, n, q, tau_l),
            adapt_rho=False))
        st = solve(_cold_lanes(T * L, q, n, rho, ilams.reshape(-1)), maxit,
                   eps_abs, eps_rel)
        coefs = st.z[:, n:].reshape(T, L, q)
        niter = st.it.reshape(T, L)
    else:
        rows, its, bufs = [], [], []
        znq = torch.zeros((n + q,), dtype=dtype, device=dev)
        for tau, ilam_row in zip(taus, ilams):
            solve = make_fadmm_solver(
                _quantile_ops(Xa, ys, Minv, w, pf, n, q, tau),
                adapt_rho=False)
            solve_t = (None if trace_len is None
                       else make_traced_solve(solve, trace_len))
            st = make_state(torch.zeros((q,), dtype=dtype, device=dev), znq,
                            znq, rho, ilam_row[0],
                            aux=torch.zeros((n,), dtype=dtype, device=dev))
            for il in ilam_row:
                st = warm_start(st, il)
                if solve_t is None:
                    st = solve(st, maxit, eps_abs, eps_rel)
                else:
                    st, buf = solve_t(st, maxit, eps_abs, eps_rel)
                    bufs.append(buf)
                rows.append(st.z[n:])
                its.append(st.it)
        coefs = torch.stack(rows).reshape(T, L, q)
        niter = torch.stack(its).reshape(T, L)
        if bufs:
            traces = torch.stack(bufs).reshape(T, L, trace_len, 5)
    beta0, coef = _quantile_recover(coefs, intercept, sd_x, sd_y, mean_x,
                                    mean_y)
    return QuantilePathResult(taus=taus, lambdas=lams, beta0=beta0,
                              coef=coef, niter=niter, trace=traces)


def _quantile_recover(coefs, intercept, sd_x, sd_y, mean_x, mean_y):
    """``(beta0, coef)`` on the original scale of ``(..., q)`` solver
    coefficients (the free intercept first when fitted)."""
    if intercept:
        a, slopes = coefs[..., 0], coefs[..., 1:]
        coef = slopes / sd_x * sd_y
        return mean_y + sd_y * a - torch.sum(coef * mean_x, dim=-1), coef
    coef = coefs / sd_x * sd_y
    return torch.zeros(coef.shape[:-1], dtype=coef.dtype,
                       device=coef.device), coef


def quantile_lasso_path(X, y, *, tau=0.5, lambdas=None, nlambda: int = 30,
                        lambda_min_ratio: float = 1e-2,
                        standardize: bool = True, intercept: bool = True,
                        weights=None, maxit: int = 20000,
                        eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                        rho: float = -1.0, path_mode: str = "batch",
                        trace_len: Optional[int] = None,
                        dtype=torch.float32,
                        device="cuda") -> QuantilePathResult:
    """Solve l1-penalized quantile-regression paths.

    Same arguments and defaults as ``admm_tpu.quantile_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  ``tau``: a scalar or a 1-D grid of levels in (0, 1);
    every (tau, lambda) pair is a lane of one engine loop
    (``path_mode="batch"``) or a warm-started per-tau scan (``"scan"``).
    The auto lambda grid is per tau; explicit ``lambdas`` are shared.
    Results carry a leading (T,) tau axis.  ``weights`` enter the check
    loss directly (weight-0 rows drop out exactly)."""
    taus_np = np.atleast_1d(np.asarray(to_numpy(tau), np.float64))
    if np.any(taus_np <= 0) or np.any(taus_np >= 1):
        raise ValueError("tau values must be in (0, 1)")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode, trace_len = "scan", int(trace_len)
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    taus = torch.as_tensor(taus_np, dtype=dtype, device=X.device)
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                            descending=True).values)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    return _quantile_path_dev(X, y, taus, int(nlambda), lambda_min_ratio,
                              lams, rho, maxit, eps_abs, eps_rel, w,
                              standardize_x=standardize, intercept=intercept,
                              path_mode=path_mode, trace_len=trace_len)


def pinball_loss(eta, y, tau):
    """Per-observation check loss at level tau (the CV criterion)."""
    r = y - eta
    return np.where(r > 0, tau * r, (tau - 1.0) * r)


def _quantile_fold_etas(X, y, taus, lams, masks, fid, rho, maxit, eps_abs,
                        eps_rel, *, standardize_x, intercept):
    """The one-pass fold sweep (``cv._fold_sweep``): fold f is the weighted
    path with weight 0 on its held-out rows, all T x L lanes at once, and
    each row keeps the (T, L) linear predictors of the fold that held it
    out.  Returns (n, T, L) on X's device."""
    from .cv import _fold_sweep

    return _fold_sweep(X, masks, fid, lambda mask: _quantile_path_dev(
        X, y, taus, 2, 1e-2, lams, rho, maxit, eps_abs, eps_rel, mask,
        standardize_x=standardize_x, intercept=intercept,
        path_mode="batch"), lambda res, X_rows: (
            res.beta0[..., None] + res.coef @ X_rows.mT).permute(2, 0, 1))


def cv_quantile_lasso_path(X, y, *, tau=0.5, nfolds: int = 10,
                           nlambda: int = 30, seed: int = 0,
                           foldid: Optional[np.ndarray] = None,
                           lambdas=None, standardize: bool = True,
                           intercept: bool = True, weights=None,
                           cv_mode: str = "onepass", maxit: int = 20000,
                           eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                           rho: float = -1.0, dtype=torch.float32,
                           device="cuda"):
    """K-fold CV of the penalized quantile path, scored by the pinball
    loss at each tau.  Same arguments and defaults as
    ``admm_tpu.cv_quantile_lasso_path``, plus ``device``.
    ``cv_mode="onepass"`` fits fold f as the weighted path with weight 0 on
    its rows, all T x L lanes at once, fold after fold on the device;
    "loop" fits each training subset, tau by tau.  Returns a dict with
    per-tau ``cvm``/``cvsd`` (T, L), ``lambda_min``/``lambda_1se`` (T,)
    and the full-data fit."""
    from .cv import _cv_foldid

    if cv_mode not in ("onepass", "loop"):
        raise ValueError("cv_mode must be 'onepass' or 'loop'")
    X = _as_tensor(X, dtype, device)
    y_np = np.asarray(to_numpy(y), np.float64).ravel()
    y_t = torch.as_tensor(y_np, dtype=dtype, device=X.device)
    n = X.shape[0]
    taus_np = np.atleast_1d(np.asarray(to_numpy(tau), np.float64))
    kw = dict(standardize=standardize, intercept=intercept, maxit=maxit,
              eps_abs=eps_abs, eps_rel=eps_rel, rho=rho, dtype=dtype,
              device=X.device)
    full = quantile_lasso_path(X, y_t, tau=taus_np, nlambda=nlambda,
                               lambdas=lambdas, weights=weights, **kw)
    # Fold fits share the full fit's per-tau grids (glmnet convention).
    lams_all = to_numpy(full.lambdas).astype(np.float64)     # (T, L)
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)
    masks = (foldid[None, :] != np.arange(nfolds)[:, None]).astype(np.float64)
    w_np = (None if weights is None
            else np.asarray(to_numpy(weights), np.float64).ravel())
    if w_np is not None:
        masks = masks * w_np[None, :]
    T, L = lams_all.shape
    if cv_mode == "onepass":
        eta = to_numpy(_quantile_fold_etas(
            X, y_t, full.taus, full.lambdas,
            torch.as_tensor(masks, dtype=dtype, device=X.device),
            np.clip(foldid, 0, None), rho, maxit, eps_abs, eps_rel,
            standardize_x=standardize, intercept=intercept)).astype(
                np.float64)
    else:
        X_np = to_numpy(X).astype(np.float64)
        eta = np.empty((n, T, L))
        for f in range(nfolds):
            tr = torch.as_tensor(np.flatnonzero(foldid != f),
                                 device=X.device)
            va = foldid == f
            wf = None if w_np is None else w_np[foldid != f]
            for t in range(T):
                rf = quantile_lasso_path(X[tr], y_t[tr], tau=taus_np[t],
                                         lambdas=lams_all[t], weights=wf,
                                         **kw)
                eta[va, t] = (to_numpy(rf.beta0)[0][None, :]
                              + X_np[va] @ to_numpy(rf.coef)[0].T)
    scored = foldid >= 0
    ws = (np.ones(n) if w_np is None else w_np)[scored]
    err = np.stack([pinball_loss(eta[scored, t], y_np[scored, None],
                                 taus_np[t]) for t in range(T)], axis=1)
    cvm = (ws[:, None, None] * err).sum(axis=0) / ws.sum()   # (T, L)
    cvsd = np.sqrt((ws[:, None, None] * (err - cvm) ** 2).sum(axis=0)
                   / ws.sum() / (scored.sum() - 1))
    i_min = np.argmin(cvm, axis=1)
    lam_min = lams_all[np.arange(T), i_min]
    lam_1se = np.empty(T)
    for t in range(T):
        ok = cvm[t] <= cvm[t, i_min[t]] + cvsd[t, i_min[t]]
        lam_1se[t] = lams_all[t, np.flatnonzero(ok)[0]]
    return dict(taus=taus_np, lambdas=lams_all, cvm=cvm, cvsd=cvsd,
                lambda_min=lam_min, lambda_1se=lam_1se, fit=full,
                foldid=foldid)
