"""Dantzig selector lambda-path solver (counterpart of
``admm_tpu/models/dantzig.py``).

Model: ``minimize ||beta||_1  s.t.  ||X'(X beta - y)||_inf <= lambda``.

Linearized ADMM with ``A = X'X``, ``c = X'y``
(reference: src/TODO/ADMMDantzig.h:9-21)::

    minimize f(x) + g(z)   s.t.  A x + z = c
    f = ||.||_1,  g = indicator{||z||_inf <= lambda}

x-update (prox-gradient on the augmented term, step ``1/(rho*sprad)``
with ``sprad = eigmax(X'X)^2``; reference: src/TODO/ADMMDantzig.h:125-137)::

    v = x - A'(Ax + z + y/rho - c)/sprad
    x = soft_threshold(v, 1/(rho*sprad))

z-update is the box projection ``z = -clip(Ax + y/rho - c, -lambda, lambda)``
(reference: src/TODO/ADMMDantzig.h:164-181).  Auto-rho ``1/sqrt(sprad)``
(reference: src/TODO/ADMMDantzig.h:257-260), held fixed: on this doubly
ill-conditioned splitting (the operator is (X'X)^2) the adaptive ladder
drives rho away from that balance point and convergence collapses, as the
JAX package measured.

The Gram matrix X'X is cached when it is smaller than X itself (n > p);
otherwise the operator is applied matrix-free as X'(X v).  No kernel: both
path modes run the generic engine of :mod:`admm_tpu_torch.core.engine`.

Lambda-path protocol identical to the Lasso path's: internal penalty
``lambda * n / scale_y``, log-linear auto grid from
``lambda0 = ||X'y||_inf``, warm starts in "scan" mode
(reference: src/TODO/Dantzig.cpp:60-91).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.engine import (ProblemOps, col, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import box_clamp_neg, l2norm, soft_threshold
from ..data.standardize import recover, standardize
from ..linalg import (dot, gram, spectral_radius_gram, spectral_radius_sym,
                      tgram)
from ..parallel.mesh import is_sharded
from .lasso import (PathResult, _as_data, _as_tensor, _auto_lambdas,
                    _batched_cold_states, _scan_path)


def _dantzig_ops(apply_A, Xty, Xty_norm, sprad, lambda0, p) -> ProblemOps:
    sqrt_sprad = torch.sqrt(sprad)

    def next_x(st):
        rhs = (st.aux + st.z + st.y / col(st.rho) - Xty) / (-sprad)
        v = st.x + apply_A(rhs)
        x_new = soft_threshold(v, col(1.0 / (st.rho * sprad)))
        # Relative early-exit slack (see models/lasso.py::_wide_ops).
        return torch.where(col(st.lam > lambda0 * (1.0 - 1e-5)),
                           torch.zeros_like(x_new), x_new)

    def next_z(st, x_new):
        cache_Ax = apply_A(x_new)
        v = cache_Ax + st.y / col(st.rho) - Xty
        return box_clamp_neg(v, col(st.lam)), cache_Ax

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: aux + z - Xty,
        eps_primal_scale=lambda st: torch.maximum(
            torch.maximum(l2norm(st.aux), l2norm(st.z)), Xty_norm),
        eps_dual_scale=lambda st: sqrt_sprad * l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * sqrt_sprad
        * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=p, dim_dual=p,
    )


def _dantzig_setup(Xs, ys, rho0):
    """The model's ops and rho.  ``apply_A`` takes one iterate (p,) or a
    block of lanes (k, p); A is symmetric, so lanes multiply from the
    left."""
    n, p = Xs.shape
    Xty = dot(Xs.mT, ys)
    Xty_norm = l2norm(Xty)
    lambda0 = torch.max(torch.abs(Xty))

    if n > p:
        XtX = gram(Xs)
        apply_A = lambda v: dot(v, XtX)
        sprad_g = spectral_radius_sym(XtX)
    else:
        apply_A = lambda v: dot(dot(v, Xs.mT), Xs)
        # A row-sharded X has no replicated XX': the matrix-free power
        # iteration on it (same start vector, same operator).
        sprad_g = (spectral_radius_gram(Xs) if is_sharded(Xs)
                   else spectral_radius_sym(tgram(Xs)))
    sprad = sprad_g * sprad_g  # eigmax(X'X X'X) = eigmax(X'X)^2

    if rho0 > 0:
        rho = torch.tensor(rho0, dtype=Xs.dtype, device=Xs.device)
    else:
        rho = 1.0 / torch.sqrt(sprad)
    ops = _dantzig_ops(apply_A, Xty, Xty_norm, sprad, lambda0, p)
    return ops, rho


def _dantzig_engine(Xs, ys, lam_first, rho0):
    """Cold state, solver and reported iterate for the Dantzig path."""
    p = Xs.shape[1]
    ops, rho = _dantzig_setup(Xs, ys, rho0)
    solve = make_admm_solver(ops, adapt_rho=False)
    zeros = torch.zeros((p,), dtype=Xs.dtype, device=Xs.device)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first, aux=zeros)
    return st0, solve, (lambda st: st.x)


def _solve_path_dantzig(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel,
                        trace_len=None):
    st0, solve, report = _dantzig_engine(Xs, ys, ilams[0], rho0)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return coefs, niter, traces


def _solve_path_dantzig_batch(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel):
    """All lambdas at once: the single-lambda engine body on a block of
    lanes (the batched protocol of the Lasso, ``make_batched_solver``);
    the x-update's product becomes (k, p) x (p, p)."""
    p = Xs.shape[1]
    ops, rho = _dantzig_setup(Xs, ys, rho0)
    solve = make_batched_solver(make_admm_solver(ops, adapt_rho=False))
    st = _batched_cold_states(ilams.shape[0], p, rho, ilams, aux_dim=p)
    st = solve(st, maxit, eps_abs, eps_rel)
    return st.x, st.it, None


def _dpath_auto(X, y, nlambda, lambda_min_ratio, rho, maxit, eps_abs,
                eps_rel, weights=None, *, standardize_x, intercept,
                path_mode, trace_len=None):
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    lams = _auto_lambdas(Xs, ys, stats, nlambda, lambda_min_ratio, 1.0,
                         False)
    return _dpath_from(Xs, ys, stats, lams, rho, maxit, eps_abs, eps_rel,
                       standardize_x, intercept, path_mode, trace_len)


def _dpath_user(X, y, lams, rho, maxit, eps_abs, eps_rel, weights=None, *,
                standardize_x, intercept, path_mode, trace_len=None):
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    return _dpath_from(Xs, ys, stats, lams, rho, maxit, eps_abs, eps_rel,
                       standardize_x, intercept, path_mode, trace_len)


def _dpath_from(Xs, ys, stats, lams, rho, maxit, eps_abs, eps_rel,
                standardize_x, intercept, path_mode="scan", trace_len=None):
    n = Xs.shape[0]
    ilams = lams * n / stats.scale_y
    if path_mode == "batch":
        coefs, niter, traces = _solve_path_dantzig_batch(
            Xs, ys, ilams, rho, maxit, eps_abs, eps_rel)
    else:
        coefs, niter, traces = _solve_path_dantzig(
            Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, trace_len)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def dantzig_path(X, y, *, lambdas=None, nlambda: int = 100,
                 lambda_min_ratio: Optional[float] = None,
                 standardize: bool = True, intercept: bool = True,
                 maxit: int = 10000, eps_abs: float = 1e-5,
                 eps_rel: float = 1e-5, rho: float = -1.0,
                 path_mode: str = "scan", trace_len: Optional[int] = None,
                 weights=None, data_mesh=None, dtype=torch.float32,
                 device="cuda") -> PathResult:
    """Solve the Dantzig-selector lambda path.

    Same arguments and defaults as ``admm_tpu.dantzig_path`` (the API
    mirrors the Lasso path; the reference's R class extends ADMM_Lasso
    unchanged, reference: R/50_admm_dantzig.R:2), plus ``device``:
    tensors stay on their own device, anything else goes to ``device``.
    ``path_mode``: "scan" warm-starts the lambdas in sequence, "batch"
    solves them all at once as lanes.

    ``weights`` (the weighted Dantzig selector): the residual-correlation
    constraint becomes ``||X' W (y - X b)||_inf <= lambda`` through the
    shared sqrt(w) row scaling (``data/standardize.py``), so an integer
    weight k equals repeating the row k times.

    ``trace_len`` records the per-iteration residual trace of each lambda
    (implies "scan").  ``data_mesh`` shards X's rows over a mesh as in
    :func:`admm_tpu_torch.lasso_path`: the moments, X'X and X'y (and the
    wide operator's products) are sums over the mesh, the state is
    replicated.
    """
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    X = _as_data(X, dtype, device, data_mesh)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    n, p = X.shape
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4
    w = (None if weights is None
         else _as_tensor(weights, dtype, X.device).reshape(-1))
    kw = dict(standardize_x=standardize, intercept=intercept,
              path_mode=path_mode, trace_len=trace_len)
    if lambdas is not None:
        lams = torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                          descending=True).values
        return _dpath_user(X, y, lams, rho, maxit, eps_abs, eps_rel, w, **kw)
    return _dpath_auto(X, y, int(nlambda), lambda_min_ratio, rho, maxit,
                       eps_abs, eps_rel, w, **kw)
