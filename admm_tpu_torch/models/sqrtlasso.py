"""Square-root LASSO, ``min ||y - X b||_2 / sqrt(n) + lam ||b||_1``
(counterpart of ``admm_tpu/models/sqrtlasso.py``; an extension beyond
the reference).

The pivotal lasso of Belloni, Chernozhukov & Wang (2011): the square
root of the loss makes the optimal lam independent of the noise level, so
one grid tunes every noise regime.  Two solvers, both on the engines of
:mod:`admm_tpu_torch.core.engine`:

* **concomitant** (default): the scaled-lasso alternation of Sun & Zhang
  (2012).  Alternate a WARM-STARTED lasso solve at penalty ``lam * sigma``
  (the Lasso's tall or wide engine, regime-dispatched as the Lasso is,
  reference: src/Lasso.cpp:73-76) with the closed form ``sigma = ||y - X
  b|| / sqrt(n)``.  The fixed point is the sqrt-lasso KKT system.  The
  JAX package's two nested ``lax.while_loop``s are host loops here: the
  outer one reads whether every lane's sigma has converged, once per
  sigma step, the inner one is the engine's.
* **stacked** (``algorithm="stacked"``; also the traced path): one FADMM
  on ``A = [-X; I]``, ``z = [r; w]``, ``c = [-y; 0]`` with block shrinkage
  on the residual block and soft threshold on the coefficients, against a
  cached ``(X'X + I)^{-1}``.

No kernel: the inner solves are the engine's (the kernels carry no sigma
step), so no path here launches one.  The grid tops at the exact null
threshold ``lam0 = ||X'y||_inf / (sqrt(n) ||y||)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.engine import (ProblemOps, col, make_admm_solver,
                           make_batched_solver, make_fadmm_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..data.standardize import _guard
from ..linalg import chol_inverse, gram
from .lasso import (PathResult, _as_tensor, _batched_cold_states, _linspace,
                    _not_ported, _scan_path, _tall_ops, _tall_setup,
                    _wide_ops, _wide_setup)


def l2_prox(v, tau):
    """Prox of ``tau * ||.||_2`` over the last axis (block shrinkage):
    shrink the norm by tau, zero inside the ball.  ``tau`` is a scalar or
    a per-lane column."""
    nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    scale = torch.clamp(1.0 - tau / torch.clamp(nv, min=1e-30), min=0.0)
    return scale * v


def _stacked_ops(Xs, ys, Minv, n, p, prox_r, prox_w) -> ProblemOps:
    """Stacked-splitting ops, ``A = [-X; I]``, ``z = [r; w]``, ``c = [-y;
    0]``, ``f(b) = 0``, ``g(z) = loss(r) + penalty(w)``, shared by the
    sqrt-lasso (l2-norm loss) and the penalized quantile regression
    (:mod:`admm_tpu_torch.models.quantile`).  z and the dual are ``(...,
    n + p)``: the residual block ``[..., :n]`` and the coefficient block
    ``[..., n:]``; ``aux`` caches ``X x``.  ``prox_r(st, vr)`` and
    ``prox_w(st, vw)`` are the block proxes at ``st.rho``."""

    def next_x(st):
        # (X'X + I) b = X'(y - z_r + u_r/rho) + z_w - u_w/rho.
        rho = col(st.rho)
        zr, zw = st.adj_z[..., :n], st.adj_z[..., n:]
        ur, uw = st.adj_y[..., :n], st.adj_y[..., n:]
        rhs = (ys - zr + ur / rho) @ Xs + zw - uw / rho
        return rhs @ Minv.mT

    def next_z(st, x_new):
        rho = col(st.rho)
        Ax = x_new @ Xs.mT
        ur, uw = st.adj_y[..., :n], st.adj_y[..., n:]
        vr = ys - Ax + ur / rho
        vw = x_new + uw / rho
        return torch.cat([prox_r(st, vr), prox_w(st, vw)], dim=-1), Ax

    def primal_residual(st, x, z, aux):
        return torch.cat([ys - aux - z[..., :n], x - z[..., n:]], dim=-1)

    def eps_primal_scale(st):
        ax = torch.sqrt(sqnorm(st.aux) + sqnorm(st.x))
        return torch.maximum(torch.maximum(ax, l2norm(st.z)), l2norm(ys))

    def eps_dual_scale(st):
        # A'y = -X'u_r + u_w (the blocks add).
        return l2norm(st.y[..., n:] - st.y[..., :n] @ Xs)

    def dual_residual(st, z_new):
        dz = z_new - st.z
        return st.rho * l2norm(dz[..., :n] @ Xs - dz[..., n:])

    return ProblemOps(
        next_x=next_x, next_z=next_z,
        primal_residual=primal_residual,
        eps_primal_scale=eps_primal_scale,
        eps_dual_scale=eps_dual_scale,
        dual_residual=dual_residual,
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=n + p,
    )


def _sqrt_ops(Xs, ys, Minv, n, p) -> ProblemOps:
    """The sqrt-lasso's stacked ops: block shrinkage on the residual, soft
    threshold on the coefficients."""
    return _stacked_ops(
        Xs, ys, Minv, n, p,
        prox_r=lambda st, vr: l2_prox(vr, 1.0 / col(st.rho)),
        prox_w=lambda st, vw: soft_threshold(vw, col(st.lam / st.rho)))


def _sqrt_auto_rho(ys, n):
    """Auto-rho ``sqrt(n)/||ys||`` = 1/sigma_hat(y): the iterate path is
    then equivariant under y-scaling (the JAX package's DESIGN.md
    "sqrt-lasso rho", measured on the TPU)."""
    return math.sqrt(n) / torch.clamp(l2norm(ys), min=1e-30)


def _stacked_setup(Xs, ys, rho0):
    """rho and the cached ``(X'X + I)^{-1}`` of the stacked splitting."""
    p = Xs.shape[1]
    rho = (torch.tensor(rho0, dtype=Xs.dtype, device=Xs.device) if rho0 > 0
           else _sqrt_auto_rho(ys, Xs.shape[0]))
    eye = torch.eye(p, dtype=Xs.dtype, device=Xs.device)
    Minv = chol_inverse(gram(Xs) + eye,
                        jitter=1e-7 if Xs.dtype == torch.float32 else 0.0)
    return rho, Minv


def _sqrt_engine(Xs, ys, lam_first, rho0):
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    rho, Minv = _stacked_setup(Xs, ys, rho0)
    solve = make_fadmm_solver(_sqrt_ops(Xs, ys, Minv, n, p), adapt_rho=False)
    znp = torch.zeros((n + p,), dtype=dtype, device=dev)
    st0 = make_state(torch.zeros((p,), dtype=dtype, device=dev), znp, znp,
                     rho, lam_first,
                     aux=torch.zeros((n,), dtype=dtype, device=dev))
    # Report the soft-thresholded w block (exact zeros).
    return st0, solve, (lambda st: st.z[..., n:])


# ---------------------------------------------------------------------------
# Concomitant (scaled-lasso) alternation: the default solver
# ---------------------------------------------------------------------------

_OUTER_MAXIT = 100  # sigma alternation cap (typical convergence: 3-8)


def _rearm(st, ilams, done):
    """Re-arm the lane(s) for the next sigma step: keep the iterates, rho
    and the ACCUMULATED iteration counter (maxit budgets a lane's total
    inner iterations); resync the momentum (``engine.warm_start``'s
    restart fix) and reset the sentinels.  ``done`` keeps sigma-converged
    lanes frozen."""
    ones = torch.ones_like(st.rho)
    return st._replace(
        lam=ilams.to(st.rho.dtype) * ones, adj_z=st.z, adj_y=st.y,
        adj_a=ones, adj_c=9999.0 * ones,
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones, done=done)


def _sqrt_inner_engine(Xs, ys, ilam0, rho0):
    """The alternation's inner lasso engine, regime-dispatched as the
    Lasso (reference: src/Lasso.cpp:73-76): tall = cached-ridge FADMM at
    fixed rho (report z), wide = linearized ADMM with the adaptive ladder
    and the all-zero early exit (report x), which is exact for the sqrt
    problem too.  Returns ``(solve, st0_maker, report, rho)``;
    ``st0_maker(k, ilams)`` builds one cold state (k None) or k lanes."""
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    if n > p:
        Minv, Xty, rho = _tall_setup(Xs, ys, ilam0, rho0)
        solve = make_fadmm_solver(_tall_ops(Minv, Xty, 1.0, p),
                                  adapt_rho=False)

        def st0_maker(k, ilams):
            if k is None:
                zp = torch.zeros((p,), dtype=dtype, device=dev)
                return make_state(zp, zp, zp, rho, ilams)
            return _batched_cold_states(k, p, rho, ilams)

        return solve, st0_maker, (lambda st: st.z), rho
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilam0, rho0, 1.0, False)
    solve = make_admm_solver(_wide_ops(Xs, ys, sprad, lambda0, 1.0, n, p),
                             adapt_rho=True)

    def st0_maker(k, ilams):
        if k is None:
            zn = torch.zeros((n,), dtype=dtype, device=dev)
            return make_state(torch.zeros((p,), dtype=dtype, device=dev), zn,
                              zn, rho, ilams, aux=zn)
        st = _batched_cold_states(k, p, 1.0, ilams, aux_dim=n)
        zn = torch.zeros((k, n), dtype=dtype, device=dev)
        return st._replace(rho=torch.broadcast_to(rho, (k,)).to(dtype),
                           z=zn, y=zn, adj_z=zn, adj_y=zn)

    return solve, st0_maker, (lambda st: st.x), rho


def _sigma_of(Xs, ys, b, sqrt_n, sig_floor):
    """The closed-form sigma step, per lane: ``||y - X b|| / sqrt(n)``
    floored (sigma -> 0 would drive the penalty to 0 when the path
    interpolates)."""
    R = ys - b @ Xs.mT
    return torch.clamp(l2norm(R) / sqrt_n, min=sig_floor)


def _sqrt_concomitant_batch(Xs, ys, lams, rho0, maxit, eps_abs, eps_rel):
    """All lambdas as cold-start lanes, each alternating warm inner lasso
    solves with its own sigma update, until every lane's sigma is a fixed
    point; sigma-converged lanes freeze as ``make_batched_solver``'s
    converged lanes do."""
    n = Xs.shape[0]
    dtype, dev = Xs.dtype, Xs.device
    k = lams.shape[0]
    sqrt_n = math.sqrt(n)
    sigma0 = l2norm(ys) / sqrt_n
    inner, st0_maker, report, _ = _sqrt_inner_engine(
        Xs, ys, n * lams[0] * sigma0, rho0)
    solve = make_batched_solver(inner)
    st = st0_maker(k, n * lams * sigma0)
    sigma = sigma0 * torch.ones((k,), dtype=dtype, device=dev)
    sig_floor = 1e-10 * sigma0
    odone = torch.zeros((k,), dtype=torch.bool, device=dev)
    for _ in range(_OUTER_MAXIT):
        if not bool(torch.any(~odone)):
            break
        st = _rearm(st, n * lams * sigma, odone)
        st = solve(st, maxit, eps_abs, eps_rel)
        sig_new = _sigma_of(Xs, ys, report(st), sqrt_n, sig_floor)
        # sigma fixed point <=> the sqrt-lasso KKT system holds.
        conv = ((torch.abs(sig_new - sigma) <= eps_rel * sig_new + eps_abs)
                | (st.it >= maxit))
        sigma = torch.where(odone, sigma, sig_new)
        odone = odone | conv
    return report(st), st.it


def _sqrt_concomitant_scan_setup(Xs, ys, lam_top, rho0):
    """The warm-started path's start and its advance: ``(carry0,
    advance)`` with ``carry = (state, sigma)`` and ``advance(carry, lams,
    maxit, eps_abs, eps_rel) -> (carry, coefs, niter)`` over a run of
    the grid (the one-shot scan and the checkpointed driver's chunks)."""
    n = Xs.shape[0]
    sqrt_n = math.sqrt(n)
    sigma0 = l2norm(ys) / sqrt_n
    sig_floor = 1e-10 * sigma0
    solve, st0_maker, report, _ = _sqrt_inner_engine(
        Xs, ys, n * lam_top * sigma0, rho0)
    not_done = torch.zeros((), dtype=torch.bool, device=Xs.device)

    def advance(carry, lams, maxit, eps_abs, eps_rel):
        st, sigma = carry
        coefs, niter = [], []
        for lam in lams:
            st = st._replace(it=torch.zeros_like(st.it))
            for _ in range(_OUTER_MAXIT):
                st = _rearm(st, n * lam * sigma, not_done)
                st = solve(st, maxit, eps_abs, eps_rel)
                sn = _sigma_of(Xs, ys, report(st), sqrt_n, sig_floor)
                conv = ((torch.abs(sn - sigma) <= eps_rel * sn + eps_abs)
                        | (st.it >= maxit))
                sigma = sn
                if bool(conv):
                    break
            coefs.append(report(st))
            niter.append(st.it)
        return (st, sigma), torch.stack(coefs), torch.stack(niter)

    return (st0_maker(None, n * lam_top * sigma0), sigma0), advance


def _sqrt_concomitant_scan(Xs, ys, lams, rho0, maxit, eps_abs, eps_rel):
    """The warm-started path: sigma AND the solver state carry across
    lambdas (the reference's path protocol, reference:
    src/Lasso.cpp:97-124); a lambda's niter is its total of inner
    iterations over its sigma steps."""
    carry0, advance = _sqrt_concomitant_scan_setup(Xs, ys, lams[0], rho0)
    return advance(carry0, lams, maxit, eps_abs, eps_rel)[1:]


def _sqrt_prepare(X, y, weights, *, standardize_x, intercept):
    """Standardize and weight for the sqrt-lasso objective: weighted
    moments, sd scaling, then sqrt(w) row scaling (the l2-norm loss
    becomes the weighted norm ``||diag(sqrt w)(y - X b)||``).  Returns
    ``(Xs, ys, sd_x, mean_x, mean_y)``."""
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    w = None
    if weights is not None:
        w = weights.reshape(-1).to(dtype)
        w = w * (n / torch.sum(w))      # glmnet: weights sum to n
    wcol = torch.ones((n,), dtype=dtype, device=dev) if w is None else w

    def wmean(v, axis=None):
        ww = wcol if v.dim() == 1 else wcol[:, None]
        return torch.sum(ww * v, dim=axis) / n

    mean_x = torch.zeros((p,), dtype=dtype, device=dev)
    mean_y = torch.zeros((), dtype=dtype, device=dev)
    sd_x = torch.ones((p,), dtype=dtype, device=dev)
    Xs, ys = X, y
    if intercept:
        mean_x = wmean(X, axis=0)
        mean_y = wmean(y)
        Xs = X - mean_x[None, :]
        ys = y - mean_y
    if standardize_x:
        cm = wmean(X, axis=0)
        c = X - cm[None, :]
        sd_x = _guard(torch.sqrt(torch.sum(wcol[:, None] * c * c, dim=0) / n),
                      cm)
        Xs = Xs / sd_x[None, :]
    if w is not None:
        sw = torch.sqrt(w)
        Xs = Xs * sw[:, None]
        ys = ys * sw
    return Xs, ys, sd_x, mean_x, mean_y


def _sqrt_path_dev(X, y, nlambda, lambda_min_ratio, user_lams, rho0, maxit,
                   eps_abs, eps_rel, weights=None, *, standardize_x,
                   intercept, path_mode, trace_len=None,
                   algorithm="concomitant"):
    n, p = X.shape
    Xs, ys, sd_x, mean_x, mean_y = _sqrt_prepare(
        X, y, weights, standardize_x=standardize_x, intercept=intercept)
    if user_lams is None:
        # Exact null threshold, nudged 1e-4 above the boundary (where one
        # coefficient sits at machine scale and the cold solve crawls).
        lam0 = (torch.max(torch.abs(ys @ Xs))
                / (math.sqrt(n) * l2norm(ys)) * (1.0 + 1e-4))
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    traces = None
    if algorithm == "concomitant" and trace_len is None:
        run = (_sqrt_concomitant_batch if path_mode == "batch"
               else _sqrt_concomitant_scan)
        coefs, niter = run(Xs, ys, lams, rho0, maxit, eps_abs, eps_rel)
    else:
        # Internal objective = user's * sqrt(n): lam_int = lam sqrt(n).
        ilams = lams * math.sqrt(n)
        if path_mode == "batch":
            rho, Minv = _stacked_setup(Xs, ys, rho0)
            solve = make_batched_solver(make_fadmm_solver(
                _sqrt_ops(Xs, ys, Minv, n, p), adapt_rho=False))
            k = ilams.shape[0]
            st = _batched_cold_states(k, p, rho, ilams, aux_dim=n)
            Znp = torch.zeros((k, n + p), dtype=X.dtype, device=X.device)
            st = st._replace(z=Znp, y=Znp, adj_z=Znp, adj_y=Znp)
            st = solve(st, maxit, eps_abs, eps_rel)
            coefs, niter = st.z[:, n:], st.it
        else:
            st0, solve, report = _sqrt_engine(Xs, ys, ilams[0], rho0)
            _, coefs, niter, traces = _scan_path(st0, solve, report, ilams,
                                                 maxit, eps_abs, eps_rel,
                                                 trace_len)
    coef = coefs / sd_x[None, :]
    beta0 = mean_y - coef @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def sqrt_lasso_path(X, y, *, lambdas=None, nlambda: int = 30,
                    lambda_min_ratio: float = 1e-2, standardize: bool = True,
                    intercept: bool = True, maxit: int = 10000,
                    eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                    rho: float = -1.0, path_mode: str = "batch",
                    algorithm: str = "concomitant", data_mesh=None,
                    trace_len: Optional[int] = None, weights=None,
                    dtype=torch.float32, device="cuda") -> PathResult:
    """Solve the square-root-lasso path.

    Same arguments and defaults as ``admm_tpu.sqrt_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  The penalty scale is pivotal (it does not depend on the
    noise level); the auto grid tops at the exact null threshold.
    ``algorithm``: "concomitant" (default, the scaled-lasso alternation
    on the Lasso's tall or wide engine) or "stacked" (one FADMM on the
    stacked splitting, the solver a ``trace_len`` request traces).
    ``weights`` are observation weights.  ``data_mesh`` is not ported yet
    and raises ``NotImplementedError``.
    """
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if algorithm not in ("concomitant", "stacked"):
        raise ValueError("algorithm must be 'concomitant' or 'stacked'")
    if trace_len is not None:
        path_mode, algorithm, trace_len = "scan", "stacked", int(trace_len)
    _not_ported(data_mesh=data_mesh)
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                            descending=True).values)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    return _sqrt_path_dev(X, y, int(nlambda), lambda_min_ratio, lams, rho,
                          maxit, eps_abs, eps_rel, w,
                          standardize_x=standardize, intercept=intercept,
                          path_mode=path_mode, trace_len=trace_len,
                          algorithm=algorithm)
