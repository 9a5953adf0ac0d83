"""Equality-constrained Lasso: ``min 1/(2n)||y - Xb||^2 + lam ||b||_1
s.t. C b = d`` (counterpart of ``admm_tpu/models/conlasso.py``; an
extension beyond the reference).

The constrained lasso (Gaines, Kim & Zhou 2018; James et al. 2020), whose
flagship case is the ZERO-SUM lasso (``sum_j b_j = 0``) for compositional
data.  The splitting is the tall Lasso's (b - z = 0, ``f`` the quadratic
plus the affine indicator, ``g = lam ||z||_1``), and the x-update solves
the KKT system by block elimination::

    [X'X + rho I  C'] [b ]   [X'y + rho(z - u)]
    [C            0 ] [nu] = [d               ]

with two cached SPD inverses, ``M = (X'X + rho I)^{-1}`` and the m x m
Schur complement ``(C M C')^{-1}`` (the tall Lasso's one-time inverse,
reference: src/ADMMLassoTall.h:70-80); FADMM with fixed rho, on the
engines ("batch", the default, or "scan").

Constraints live in ORIGINAL coordinates, so there is no ``standardize``
option; ``intercept=True`` mean-centers X and y.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, col, make_batched_solver,
                           make_fadmm_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import chol_inverse, gram, spectral_radius_sym
from .genlasso import _jittered_solve, center_weight
from .lasso import (PathResult, _as_tensor, _batched_cold_states, _linspace,
                    _scan_path)


def _conlasso_ops(Minv, Xty, C, Sinv, d, p):
    """x-update by block elimination: ``b = M r - M C' nu`` with ``nu =
    Sinv (C M r - d)``, ``r = X'y + rho(z - u)``."""
    MCt = Minv @ C.mT          # (p, m) cached

    def next_x(st):
        r = Xty + col(st.rho) * st.adj_z - st.adj_y
        Mr = r @ Minv.mT
        nu = (Mr @ C.mT - d) @ Sinv.mT
        return Mr - nu @ MCt.mT

    def next_z(st, x_new):
        v = x_new + st.adj_y / col(st.rho)
        return soft_threshold(v, col(st.lam / st.rho)), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=p,
    )


def _conlasso_setup(Xs, ys, C, d, lam_first, rho0):
    dtype, dev = Xs.dtype, Xs.device
    p = Xs.shape[1]
    Xty = Xs.mT @ ys
    XtX = gram(Xs)
    # The tall Lasso's auto-rho power law (reference:
    # src/ADMMLassoTall.h:194-202).
    if rho0 > 0:
        rho = torch.tensor(rho0, dtype=dtype, device=dev)
    else:
        rho = spectral_radius_sym(XtX).pow(1.0 / 3.0) * lam_first ** (2.0 / 3.0)
    jit = 1e-6 if dtype == torch.float32 else 0.0
    Minv = chol_inverse(XtX + rho * torch.eye(p, dtype=dtype, device=dev),
                        jitter=jit)
    # The dual Schur complement C M C' (SPD when C has full row rank).
    Sinv = chol_inverse(C @ Minv @ C.mT, jitter=jit)
    return Minv, Sinv, Xty, rho


def _conlasso_engine(Xs, ys, C, d, lam_first, rho0):
    """(cold state, solver, report :func:`_support_values`)."""
    p = Xs.shape[1]
    Minv, Sinv, Xty, rho = _conlasso_setup(Xs, ys, C, d, lam_first, rho0)
    solve = make_fadmm_solver(_conlasso_ops(Minv, Xty, C, Sinv, d, p),
                              adapt_rho=False)
    zp = torch.zeros((p,), dtype=Xs.dtype, device=Xs.device)
    return make_state(zp, zp, zp, rho, lam_first), solve, _support_values


def _support_values(st):
    """The SUPPORT of z (exact zeros, the package-wide sparsity contract)
    with the VALUES of x (the constraint-feasible iterate): ``C b = d``
    holds to solver tolerance."""
    return torch.where(st.z != 0, st.x, torch.zeros_like(st.x))


def _conlasso_path_dev(X, y, C, d, nlambda, lambda_min_ratio, user_lams,
                       rho0, maxit, eps_abs, eps_rel, weights=None, *,
                       intercept, path_mode, trace_len=None):
    n, p = X.shape
    Xs, ys, mean_x, mean_y = center_weight(X, y, weights, intercept)
    if user_lams is None:
        # Grid top: b = 0 is optimal (when d = 0 makes it feasible) iff
        # some nu has ||X'y/n - C'nu||_inf <= lam; the least-squares nu
        # gives a feasible certificate, so an upper bound.
        g = Xs.mT @ ys
        nu_ls, ok = _jittered_solve(gram(C.mT), C @ g)
        lam0 = torch.max(torch.abs(g - nu_ls @ C)) / n
        lam0 = torch.where(ok & torch.isfinite(lam0) & (lam0 > 0), lam0,
                           torch.max(torch.abs(g)) / n)
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    ilams = lams * n
    st0, solve, report = _conlasso_engine(Xs, ys, C, d, ilams[0], rho0)
    if path_mode == "batch":
        st = _batched_cold_states(ilams.shape[0], p, st0.rho, ilams)
        st = make_batched_solver(solve)(st, maxit, eps_abs, eps_rel)
        coefs, niter, traces = report(st), st.it, None
    else:
        _, coefs, niter, traces = _scan_path(st0, solve, report, ilams,
                                             maxit, eps_abs, eps_rel,
                                             trace_len)
    beta0 = mean_y - coefs @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs, niter=niter,
                      trace=traces)


def constrained_lasso_path(X, y, C, d=None, *, lambdas=None,
                           nlambda: int = 50,
                           lambda_min_ratio: float = 1e-3,
                           intercept: bool = True, maxit: int = 10000,
                           eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                           rho: float = -1.0, path_mode: str = "batch",
                           trace_len: Optional[int] = None, weights=None,
                           dtype=torch.float32,
                           device="cuda") -> PathResult:
    """Solve the equality-constrained Lasso path.

    Same arguments and defaults as ``admm_tpu.constrained_lasso_path``,
    plus ``device``: tensors stay on their own device, anything else goes
    to ``device``.  ``C`` is the (m, p) constraint matrix (full row rank,
    m < p), ``d`` the (m,) right-hand side (default 0).  The coefficients
    carry exact zeros with the constraint-feasible values on the support,
    so ``C b = d`` holds to solver tolerance.  ``weights``, ``path_mode``
    and ``trace_len`` (which implies "scan") as in
    :func:`admm_tpu_torch.models.genlasso.gen_lasso_path`.
    """
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    C = torch.atleast_2d(_as_tensor(C, dtype, X.device))
    if C.shape[1] != X.shape[1]:
        raise ValueError("C must be (m, ncol(x))")
    if C.shape[0] >= X.shape[1]:
        raise ValueError("need fewer constraints than coefficients")
    d = (torch.zeros((C.shape[0],), dtype=dtype, device=X.device)
         if d is None else _as_tensor(d, dtype, X.device).reshape(-1))
    if d.shape != (C.shape[0],):
        raise ValueError("d must have one entry per constraint row")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                            descending=True).values)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    return _conlasso_path_dev(X, y, C, d, int(nlambda), lambda_min_ratio,
                              lams, rho, maxit, eps_abs, eps_rel, w,
                              intercept=intercept, path_mode=path_mode,
                              trace_len=trace_len)


def zerosum_lasso_path(X, y, **kw) -> PathResult:
    """The ZERO-SUM lasso (``sum_j b_j = 0``): the constrained lasso for
    compositional / log-ratio designs."""
    p = X.shape[1] if hasattr(X, "shape") else np.shape(X)[1]
    return constrained_lasso_path(X, y, np.ones((1, p)), **kw)


def _conlasso_fold_etas(X, y, C, d, lams, masks, fid, rho, maxit, eps_abs,
                        eps_rel, *, intercept):
    """The constrained lasso's one-pass fold sweep: fold f is the weighted
    batch path with weight 0 on its rows (``masks[f]``); returns the
    (n, nlambda) own-fold linear predictors (``fid``, numpy, the clipped
    foldid)."""
    from .cv import _fold_sweep

    return _fold_sweep(X, masks, fid, lambda mask: _conlasso_path_dev(
        X, y, C, d, 2, 1e-3, lams, rho, maxit, eps_abs, eps_rel, mask,
        intercept=intercept, path_mode="batch"))
