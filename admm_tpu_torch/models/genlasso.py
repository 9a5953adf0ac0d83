"""Generalized Lasso: ``minimize 1/(2n)||y - X b||^2 + lambda ||D b||_1``
(counterpart of ``admm_tpu/models/genlasso.py``; an extension beyond the
reference, which penalizes only ``||b||_1``).

An arbitrary penalty matrix ``D`` covers the fused lasso (D = first
differences), trend filtering (higher-order differences), the sparse
fused lasso (stacked [I; D]) and graph penalties (Boyd et al. 2011
section 6.4, Tibshirani & Taylor 2011).  ADMM splitting ``D b - z = 0``:

* x-update: the cached SPD inverse of ``X'X + rho D'D`` against
  ``X'y - D'adj_y + rho D'adj_z`` (the tall Lasso's one-time inverse,
  reference: src/ADMMLassoTall.h:70-80);
* z-update: ``soft_threshold(D b + adj_y/rho, lambda/rho)``;
* FADMM with fixed rho (the factorization depends on it, reference:
  src/ADMMLassoTall.h:96-97).

"batch" (the default) solves all lambdas at once as lanes, "scan"
warm-starts them in sequence; both run on the engines (no kernel takes a
penalty matrix).

``D`` encodes structure in the ORIGINAL coordinates, so there is no
``standardize`` option: ``intercept=True`` mean-centers X and y and
reconstructs ``b0 = mean(y) - sum(b mean(x))``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, col, make_batched_solver,
                           make_fadmm_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import chol_inverse, gram, spectral_radius_sym
from .lasso import (PathResult, _as_tensor, _batched_cold_states, _linspace,
                    _not_ported, _scan_path)


def difference_matrix(p: int, order: int = 1) -> np.ndarray:
    """The (p - order, p) discrete difference operator of the given order:
    order 1 = fused lasso (penalizes |b_{i+1} - b_i|), order 2 = linear
    trend filtering, etc."""
    D = np.eye(p)
    for _ in range(order):
        D = D[1:] - D[:-1]
    return D


def difference_matrix_2d(shape) -> np.ndarray:
    """The anisotropic 2-D total-variation operator for a grid of ``shape =
    (rows, cols)`` variables (row-major flattened): every horizontal and
    vertical first difference, stacked."""
    r, c = shape
    eye = np.eye(r * c)
    rows = []
    for i in range(r):
        for j in range(c - 1):
            rows.append(eye[i * c + j + 1] - eye[i * c + j])
    for i in range(r - 1):
        for j in range(c):
            rows.append(eye[(i + 1) * c + j] - eye[i * c + j])
    return np.asarray(rows)


def center_weight(X, y, weights, intercept):
    """Weighted mean-centering and sqrt(w) row scaling for the
    original-coordinate families (generalized and constrained Lasso): the
    columns are centered (which keeps D's or C's meaning) but never
    rescaled.  Returns ``(Xs, ys, mean_x, mean_y)``; the weights are
    normalized to sum n (glmnet) and folded into the rows."""
    n, p = X.shape
    w = None
    if weights is not None:
        w = weights.reshape(-1)
        w = w * (n / torch.sum(w))
    if intercept:
        if w is None:
            mean_x, mean_y = torch.mean(X, dim=0), torch.mean(y)
        else:
            mean_x, mean_y = (w @ X) / n, torch.sum(w * y) / n
        Xs = X - mean_x[None, :]
        ys = y - mean_y
    else:
        Xs, ys = X, y
        mean_x = torch.zeros((p,), dtype=X.dtype, device=X.device)
        mean_y = torch.zeros((), dtype=X.dtype, device=X.device)
    if w is not None:
        sw = torch.sqrt(w)
        Xs = Xs * sw[:, None]
        ys = ys * sw
    return Xs, ys, mean_x, mean_y


def _genlasso_ops(D, Minv, Xty):
    m, p = D.shape

    def next_x(st):
        rhs = Xty + (col(st.rho) * st.adj_z - st.adj_y) @ D
        return rhs @ Minv.mT

    def next_z(st, x_new):
        Dx = x_new @ D.mT
        v = Dx + st.adj_y / col(st.rho)
        return soft_threshold(v, col(st.lam / st.rho)), Dx

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        # aux carries the cached D x of the fresh iterate.
        primal_residual=lambda st, x, z, aux: aux - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.aux),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y @ D),
        dual_residual=lambda st, z_new: st.rho * l2norm((z_new - st.z) @ D),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=m,
    )


def _genlasso_setup(Xs, ys, D, lam_first, rho0):
    """``(X'X + rho D'D)^-1``, X'y and rho (the tall Lasso's power law on
    X'X, reference analog: src/ADMMLassoTall.h:194-202)."""
    dtype = Xs.dtype
    Xty = Xs.mT @ ys
    XtX = gram(Xs)
    if rho0 > 0:
        rho = torch.tensor(rho0, dtype=dtype, device=Xs.device)
    else:
        rho = spectral_radius_sym(XtX).pow(1.0 / 3.0) * lam_first ** (2.0 / 3.0)
    # Jitter guards rank deficiency of X'X + rho D'D (X with p > n and D
    # with a null space).
    Minv = chol_inverse(XtX + rho * gram(D),
                        jitter=1e-6 if dtype == torch.float32 else 0.0)
    return Minv, Xty, rho


def _genlasso_engine(Xs, ys, D, lam_first, rho0):
    """(cold state, solver, reported iterate x) of the scan path."""
    p, m = Xs.shape[1], D.shape[0]
    Minv, Xty, rho = _genlasso_setup(Xs, ys, D, lam_first, rho0)
    solve = make_fadmm_solver(_genlasso_ops(D, Minv, Xty), adapt_rho=False)
    zp = torch.zeros((p,), dtype=Xs.dtype, device=Xs.device)
    zm = torch.zeros((m,), dtype=Xs.dtype, device=Xs.device)
    st0 = make_state(zp, zm, zm, rho, lam_first, aux=zm)
    return st0, solve, (lambda st: st.x)


def _solve_genlasso_scan(Xs, ys, D, ilams, rho0, maxit, eps_abs, eps_rel,
                         trace_len=None):
    st0, solve, report = _genlasso_engine(Xs, ys, D, ilams[0], rho0)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return coefs, niter, traces


def _solve_genlasso_batch(Xs, ys, D, ilams, rho0, maxit, eps_abs, eps_rel):
    p, m = Xs.shape[1], D.shape[0]
    k = ilams.shape[0]
    Minv, Xty, rho = _genlasso_setup(Xs, ys, D, ilams[0], rho0)
    solve = make_batched_solver(make_fadmm_solver(
        _genlasso_ops(D, Minv, Xty), adapt_rho=False))
    zm = torch.zeros((k, m), dtype=Xs.dtype, device=Xs.device)
    st = _batched_cold_states(k, p, rho, ilams, aux_dim=m)._replace(
        z=zm, y=zm, adj_z=zm, adj_y=zm)
    st = solve(st, maxit, eps_abs, eps_rel)
    return st.x, st.it, None


def _jittered_solve(S, b):
    """``(S + jitter mean(diag S) I)^-1 b`` for a PSD ``S`` that may be
    singular, with the JAX package's relative jitter (1e-6 in float32,
    1e-12 in float64), and whether the factorization held.  Where the
    JAX package's Cholesky gives NaN, ``torch.linalg.cholesky`` raises;
    ``cholesky_ex`` reports it on the device instead, so the caller falls
    back without a host read."""
    jitter = 1e-6 if S.dtype == torch.float32 else 1e-12
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(
        S + jitter * torch.mean(torch.diagonal(S)) * eye)
    return torch.cholesky_solve(b.reshape(-1, 1), L).reshape(-1), info == 0


def _gen_path(X, y, D, nlambda, lambda_min_ratio, user_lams, rho, maxit,
              eps_abs, eps_rel, weights=None, *, intercept, path_mode,
              trace_len=None):
    n = X.shape[0]
    Xs, ys, mean_x, mean_y = center_weight(X, y, weights, intercept)
    if user_lams is None:
        # Grid top: beta = 0 is optimal iff X'y = D'v for some
        # ||v||_inf <= lambda; the least-squares v is a certificate (exact
        # for D = I).  DD' is singular when D has dependent rows, so the
        # solve always carries a relative jitter, and a non-finite or zero
        # lam0 falls back to the D = I bound max|X'y|/n.
        Xty = Xs.mT @ ys
        v_ls, ok = _jittered_solve(gram(D.mT), D @ Xty)
        lam0 = torch.max(torch.abs(v_ls)) / n
        lam0_fb = torch.max(torch.abs(Xty)) / n
        lam0 = torch.where(ok & torch.isfinite(lam0) & (lam0 > 0), lam0,
                           lam0_fb)
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    ilams = lams * n
    if path_mode == "batch":
        coefs, niter, traces = _solve_genlasso_batch(
            Xs, ys, D, ilams, rho, maxit, eps_abs, eps_rel)
    else:
        coefs, niter, traces = _solve_genlasso_scan(
            Xs, ys, D, ilams, rho, maxit, eps_abs, eps_rel, trace_len)
    beta0 = mean_y - coefs @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs, niter=niter,
                      trace=traces)


def gen_lasso_path(X, y, D, *, lambdas=None, nlambda: int = 50,
                   lambda_min_ratio: float = 1e-3, intercept: bool = True,
                   maxit: int = 10000, eps_abs: float = 1e-5,
                   eps_rel: float = 1e-5, rho: float = -1.0,
                   path_mode: str = "batch",
                   trace_len: Optional[int] = None, weights=None,
                   data_mesh=None, dtype=torch.float32,
                   device="cuda") -> PathResult:
    """Solve the generalized-Lasso lambda path.

    Same arguments and defaults as ``admm_tpu.gen_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  ``D`` is the (m, p) penalty matrix
    (:func:`difference_matrix` builds the fused-lasso and trend-filtering
    operators); ``D = I`` is ``lasso_path`` with ``standardize=False``.
    ``weights`` are observation weights on the quadratic loss.
    ``path_mode`` "batch" or "scan"; ``trace_len`` records each lambda's
    residual trace and implies "scan".  ``data_mesh`` is not ported yet
    and raises ``NotImplementedError``.
    """
    _not_ported(data_mesh=data_mesh)
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    D = _as_tensor(D, dtype, X.device)
    if D.dim() != 2 or D.shape[1] != X.shape[1]:
        raise ValueError("D must be (m, ncol(x))")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                            descending=True).values)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    return _gen_path(X, y, D, int(nlambda), lambda_min_ratio, lams, rho,
                     maxit, eps_abs, eps_rel, w, intercept=intercept,
                     path_mode=path_mode, trace_len=trace_len)


def fused_lasso_path(X, y, *, order: int = 1, **kw) -> PathResult:
    """Fused lasso / trend filtering: the generalized Lasso with the
    discrete difference operator of the given order."""
    p = X.shape[1] if hasattr(X, "shape") else np.shape(X)[1]
    return gen_lasso_path(X, y, difference_matrix(p, order), **kw)
