"""Multi-task (multi-response) Lasso: joint row sparsity across tasks
(counterpart of ``admm_tpu/models/multitask.py``; an extension beyond the
reference)::

    minimize  1/(2n) ||Y - X B||_F^2 + lambda * sum_j ||B_j.||_2

with ``Y`` (n, K), ``B`` (p, K) and the l2/l1 norm over coefficient rows
(sklearn's ``MultiTaskLasso``), or the trace norm ``lambda ||B||_*``
(``penalty="nuclear"``, reduced-rank regression, whose prox is the
singular-value thresholding of :func:`admm_tpu_torch.models.rpca.svt`).
The engines are the Lasso's: tall = FADMM against the cached ridge
inverse, the x-update one ``(p, p) x (p, K)`` product; wide = the
linearized engine with matrix iterates (reference:
src/ADMMLassoTall.h:70-80, src/ADMMLassoWide.h:129-165).

Matrix state: the JAX package vmaps the single-lane engine, whose norms
reduce over every axis, so a lane's residual norm is Frobenius.  The
port's engine reduces over the last axis only, so each lane's (p, K)
block travels FLATTENED as ``(..., p * K)`` between the engine and the ops
(:func:`_flat`), and the ops view it as ``(..., p, K)`` (:func:`_mat`):
the engine's norms, its ``rho * r`` dual step and its momentum then act
on the whole matrix, as in the JAX package.  No kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ADMMState, ProblemOps, make_admm_solver,
                           make_batched_solver, make_fadmm_solver, make_state)
from ..core.prox import l2norm, sqnorm
from ..data.standardize import _guard, wcolsum
from ..linalg import gram, ridge_inverse, spectral_radius_gram
from ..linalg import spectral_radius_sym
from .lasso import (_as_data, _as_tensor, _linspace, _scan_path,
                    validate_pf_limits)
from .rpca import svt


class MTPathResult(NamedTuple):
    """Multi-task lambda-path result (original data scale)."""
    lambdas: torch.Tensor  # (nlambda,)
    beta0: torch.Tensor    # (nlambda, K) per-task intercepts
    coef: torch.Tensor     # (nlambda, p, K)
    niter: torch.Tensor    # (nlambda,) int32
    # (nlambda, trace_len, 5) per-iteration residual trace when requested.
    trace: Optional[torch.Tensor] = None


def _flat(M):
    """``(..., r, K)`` matrices as the engine's ``(..., r * K)`` lanes."""
    return M.reshape(M.shape[:-2] + (-1,))


def _mat(v, K: int):
    """The engine's ``(..., r * K)`` lanes as ``(..., r, K)`` matrices."""
    return v.reshape(v.shape[:-1] + (-1, K))


def _lane(s):
    """A per-lane scalar ``(...)`` against ``(..., r, K)`` matrices."""
    return s[..., None, None]


def _row_prox(v, t):
    """Row-wise group soft-threshold: z_j = (1 - t/||v_j||)_+ v_j."""
    rn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v * torch.clamp(1.0 - t / torch.clamp(rn, min=1e-30), min=0.0)


def _mt_coef_prox(v, t, pf, keep, alpha, penalty):
    """The coefficient prox of ``(..., p, K)`` matrices at per-lane step
    ``t`` (``(...)``): the row group/enet shrinkage (glmnet's mgaussian
    penalty ``alpha ||B_j||_2 + (1-alpha)/2 ||B_j||_2^2``, group
    soft-threshold then the ridge shrink, exact since both are row
    separable; ``pf`` per-row factors, ``keep`` excluded rows zeroed), or
    singular-value thresholding for ``penalty="nuclear"``."""
    if penalty == "nuclear":
        return svt(v, t[..., None])
    tc = _lane(t)
    z = _row_prox(v, alpha * (tc * pf[:, None] if pf is not None else tc))
    z = z / (1.0 + (tc * pf[:, None] if pf is not None else tc)
             * (1.0 - alpha))
    if keep is not None:
        z = z * keep[:, None]
    return z


def _mt_tall_ops(Minv, XtY, p, K, pf=None, keep=None, alpha=1.0,
                 penalty="rows") -> ProblemOps:
    def next_x(st):
        rhs = XtY - _mat(st.adj_y, K) + _lane(st.rho) * _mat(st.adj_z, K)
        return _flat(Minv @ rhs)

    def next_z(st, x_new):
        v = _mat(x_new + st.adj_y / st.rho[..., None], K)
        return _flat(_mt_coef_prox(v, st.lam / st.rho, pf, keep, alpha,
                                   penalty)), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p * K, dim_dual=p * K,
    )


def _mt_wide_ops(Xs, Ys, sprad, lambda0, n, p, K, pf=None, keep=None,
                 alpha=1.0, penalty="rows") -> ProblemOps:
    sqrt_sprad = torch.sqrt(sprad)

    def next_x(st):
        rho = st.rho[..., None]
        tmp = _mat(st.aux + st.z + st.y / rho, K)
        v = _mat(st.x, K) - (Xs.mT @ tmp) / sprad
        x_new = _mt_coef_prox(v, st.lam / (st.rho * sprad), pf, keep, alpha,
                              penalty)
        return _flat(torch.where(_lane(st.lam > lambda0 * (1.0 - 1e-5)),
                                 torch.zeros_like(x_new), x_new))

    def next_z(st, x_new):
        rho = st.rho[..., None]
        cache_Ax = _flat(Xs @ _mat(x_new, K))
        return -(_flat(Ys) + st.y + rho * cache_Ax) / (1.0 + rho), cache_Ax

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: aux + z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.aux),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: sqrt_sprad * l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * sqrt_sprad
        * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=p * K, dim_dual=n * K,
    )


def _mt_lambda0(Xs, Ys, pf=None, keep=None, alpha=1.0, penalty="rows"):
    """The B = 0 KKT boundary.  Rows: ``max_j ||X_j'Y||_2 / alpha`` (with
    glmnet's max(alpha, 1e-3) cap; factor-aware over penalized,
    non-excluded rows); nuclear: the spectral norm ``||X'Y||_2``, the
    trace norm's dual."""
    XtY = Xs.mT @ Ys
    if penalty == "nuclear":
        return torch.linalg.svdvals(XtY)[0]
    rn = torch.sqrt(torch.sum(XtY * XtY, dim=1))
    if keep is not None:
        rn = rn * keep
    if pf is not None:
        rn = torch.where(pf > 0, rn / torch.clamp(pf, min=1e-12),
                         torch.zeros_like(rn))
    return torch.max(rn) / max(alpha, 1e-3)


def _mt_engine(Xs, Ys, ilam_first, rho0, pf=None, keep=None, alpha=1.0,
               penalty="rows"):
    """(cold state, solver, reported iterate) of the tall or wide engine;
    the state's iterates are flattened matrices."""
    n, p = Xs.shape
    K = Ys.shape[1]
    dtype, dev = Xs.dtype, Xs.device
    if n > p:
        XtX = gram(Xs)
        rho = (torch.tensor(rho0, dtype=dtype, device=dev) if rho0 > 0
               else spectral_radius_sym(XtX).pow(1.0 / 3.0)
               * ilam_first ** (2.0 / 3.0))
        ops = _mt_tall_ops(ridge_inverse(XtX, rho), Xs.mT @ Ys, p, K, pf,
                           keep, alpha, penalty)
        solve = make_fadmm_solver(ops, adapt_rho=False)
        zeros = torch.zeros((p * K,), dtype=dtype, device=dev)
        return (make_state(zeros, zeros, zeros, rho, ilam_first), solve,
                (lambda st: _mat(st.z, K)))
    sprad = spectral_radius_gram(Xs)
    rho = (torch.tensor(rho0, dtype=dtype, device=dev) if rho0 > 0
           else (ilam_first / sprad).pow(1.0 / 3.0))
    # The all-zero gate: the factor-aware boundary when every row is
    # penalized, +inf (off) when a row is not (B is then never zero).
    lambda0 = _mt_lambda0(Xs, Ys, pf, keep, alpha, penalty)
    if pf is not None:
        lambda0 = torch.where(torch.all(pf > 0), lambda0,
                              torch.full_like(lambda0, float("inf")))
    ops = _mt_wide_ops(Xs, Ys, sprad, lambda0, n, p, K, pf, keep, alpha,
                       penalty)
    solve = make_admm_solver(ops, adapt_rho=True)
    zn = torch.zeros((n * K,), dtype=dtype, device=dev)
    st0 = make_state(torch.zeros((p * K,), dtype=dtype, device=dev), zn, zn,
                     rho, ilam_first, aux=zn)
    return st0, solve, (lambda st: _mat(st.x, K))


def mt_standardize(X, Y, *, standardize_x, intercept, weights=None,
                   standardize_y=False):
    """Weighted centering and scaling of the multi-task design: X follows
    the glmnet modes, Y's columns are centered with an intercept and scaled
    only with ``standardize_y``.  Returns ``(Xs, Ys, sd_x, sd_y, mean_x,
    mean_y, w)`` with the weights normalized to sum n and folded into the
    rows (sqrt(w) scaling)."""
    n, p = X.shape
    K = Y.shape[1]
    dtype, dev = X.dtype, X.device
    w = None
    if weights is not None:
        w = weights.reshape(-1).to(dtype)
        w = w * (n / torch.sum(w))      # glmnet: weights sum to n
    wcol = torch.ones((n,), dtype=dtype, device=dev) if w is None else w

    def wmean(v):
        return wcolsum(v, wcol) / n

    mean_x = torch.zeros((p,), dtype=dtype, device=dev)
    sd_x = torch.ones((p,), dtype=dtype, device=dev)
    mean_y = torch.zeros((K,), dtype=dtype, device=dev)
    col_mean = wmean(X)
    Xs, Ys = X, Y
    if intercept:
        mean_y = wmean(Y)
        Xs = X - col_mean[None, :]
        Ys = Y - mean_y[None, :]
        mean_x = col_mean
    if standardize_x:
        c = X - col_mean[None, :]
        sd_x = _guard(torch.sqrt(wcolsum(c, wcol, squared=True) / n),
                      col_mean)
        Xs = Xs / sd_x[None, :]
    sd_y = torch.ones((K,), dtype=dtype, device=dev)
    if standardize_y:
        cmy = wmean(Y)
        cy = Y - cmy[None, :]
        sd_y = _guard(torch.sqrt(torch.sum(wcol[:, None] * cy * cy, dim=0)
                                 / n), cmy)
        Ys = Ys / sd_y[None, :]
    if w is not None:
        sw = torch.sqrt(w)
        Xs = Xs * sw[:, None]
        Ys = Ys * sw[:, None]
    return Xs, Ys, sd_x, sd_y, mean_x, mean_y, w


def mt_recover(coefs, sd_x, sd_y, mean_x, mean_y):
    """Original-scale (L, p, K) coefficients and per-task intercepts."""
    coef = coefs / sd_x[None, :, None] * sd_y[None, None, :]
    beta0 = mean_y[None, :] - torch.einsum("kpt,p->kt", coef, mean_x)
    return beta0, coef


def _mt_path(X, Y, nlambda, lambda_min_ratio, user_lams, rho0, maxit,
             eps_abs, eps_rel, weights=None, pf=None, keep=None, alpha=1.0,
             *, standardize_x, intercept, path_mode, trace_len=None,
             standardize_y=False, penalty="rows"):
    n = X.shape[0]
    Xs, Ys, sd_x, sd_y, mean_x, mean_y, _ = mt_standardize(
        X, Y, standardize_x=standardize_x, intercept=intercept,
        weights=weights, standardize_y=standardize_y)
    if user_lams is None:
        lam0 = _mt_lambda0(Xs, Ys, pf, keep, alpha, penalty) / n
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    ilams = lams * n
    st0, solve, report = _mt_engine(Xs, Ys, ilams[0], rho0, pf, keep, alpha,
                                    penalty)
    traces = None
    if path_mode == "batch":
        st = make_batched_solver(solve)(_broadcast_lanes(st0, ilams), maxit,
                                        eps_abs, eps_rel)
        coefs, niter = report(st), st.it
    else:
        _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                             eps_abs, eps_rel, trace_len)
    beta0, coef = mt_recover(coefs, sd_x, sd_y, mean_x, mean_y)
    return MTPathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                        trace=traces)


def _broadcast_lanes(st0, ilams) -> ADMMState:
    """k copies of a cold state, one lane per lambda."""
    k = ilams.shape[0]
    dtype, dev = ilams.dtype, ilams.device
    bc = lambda a: None if a is None else a.expand((k,) + a.shape).clone()
    ones = torch.ones((k,), dtype=dtype, device=dev)
    return ADMMState(
        x=bc(st0.x), z=bc(st0.z), y=bc(st0.y), adj_z=bc(st0.adj_z),
        adj_y=bc(st0.adj_y), aux=bc(st0.aux), adj_a=ones,
        adj_c=9999.0 * ones, rho=st0.rho * ones, lam=ilams.clone(),
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        it=torch.zeros((k,), dtype=torch.int32, device=dev),
        done=torch.zeros((k,), dtype=torch.bool, device=dev))


def _keep_mask(exclude, p, dtype, device):
    """(p,) 0/1 mask from glmnet's ``exclude`` indices (None without
    exclusions): the row-group analog of the lower = upper = 0 box."""
    if exclude is None:
        return None
    idx = np.asarray(exclude, np.int64).ravel()
    if idx.size and (idx.min() < 0 or idx.max() >= p):
        raise ValueError("exclude indices must be in [0, p)")
    keep = np.ones(p)
    keep[idx] = 0.0
    return torch.as_tensor(keep, dtype=dtype, device=device)


def multitask_lasso_path(X, Y, *, lambdas=None, nlambda: int = 50,
                         lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
                         standardize: bool = True, intercept: bool = True,
                         standardize_response: bool = False,
                         maxit: int = 10000, eps_abs: float = 1e-5,
                         eps_rel: float = 1e-5, rho: float = -1.0,
                         path_mode: str = "batch",
                         trace_len: Optional[int] = None, data_mesh=None,
                         weights=None, penalty_factor=None, exclude=None,
                         offset=None, penalty: str = "rows",
                         dtype=torch.float32, device="cuda") -> MTPathResult:
    """Solve the multi-task Lasso lambda path.

    Same arguments and defaults as ``admm_tpu.multitask_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  ``Y`` is (n, K); coefficient rows are penalized jointly.
    ``path_mode``: "batch" (lambdas as lanes) or "scan".
    ``penalty_factor``/``exclude`` are glmnet's per-row options,
    ``standardize_response`` glmnet's ``standardize.response``, ``offset``
    an (n, K) response shift, ``alpha`` the row elastic net, and
    ``penalty="nuclear"`` the trace norm (see
    :func:`multitask_nuclear_path`).  ``data_mesh`` shards X's rows over a
    mesh (Y stays replicated): the moments, X'X and X'Y are sums over the
    mesh, ``X B`` is gathered.
    """
    if penalty not in ("rows", "nuclear"):
        raise ValueError("penalty must be 'rows' or 'nuclear'")
    if penalty == "nuclear" and (penalty_factor is not None
                                 or exclude is not None or alpha != 1.0):
        raise ValueError("penalty_factor/exclude/alpha are "
                         "row-separable concepts; the nuclear penalty "
                         "does not support them")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    X = _as_data(X, dtype, device, data_mesh)
    Y = _as_tensor(Y, dtype, X.device)
    if Y.dim() != 2:
        raise ValueError("Y must be (n, K) — use lasso_path for a "
                         "single response")
    if offset is not None:
        off = _as_tensor(offset, dtype, X.device)
        if off.shape != Y.shape:
            raise ValueError("offset must match Y's (n, K) shape")
        Y = Y - off
    if X.shape[0] != Y.shape[0]:
        raise ValueError("nrow(x) should be equal to nrow(y)")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode, trace_len = "scan", int(trace_len)
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                            descending=True).values)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    p = X.shape[1]
    pf, _ = validate_pf_limits(penalty_factor, None, None, None, p, dtype,
                               X.device)
    keep = _keep_mask(exclude, p, dtype, X.device)
    return _mt_path(X, Y, int(nlambda), lambda_min_ratio, lams, rho, maxit,
                    eps_abs, eps_rel, w, pf, keep, float(alpha),
                    standardize_x=standardize, intercept=intercept,
                    path_mode=path_mode, trace_len=trace_len,
                    standardize_y=bool(standardize_response),
                    penalty=penalty)


def multitask_nuclear_path(X, Y, **kw) -> MTPathResult:
    """Reduced-rank (trace-norm) multi-task regression path::

        minimize  1/(2n) ||Y - X B||_F^2 + lambda ||B||_*

    :func:`multitask_lasso_path` with ``penalty="nuclear"``: the SVT prox
    on the same engines, the grid topped by the spectral norm of X'Y."""
    return multitask_lasso_path(X, Y, penalty="nuclear", **kw)
