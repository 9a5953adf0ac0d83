"""Sparse inverse covariance, the GRAPHICAL LASSO, by ADMM (counterpart
of ``admm_tpu/models/glasso.py``; an extension beyond the reference)::

    minimize_{Theta > 0}  tr(S Theta) - logdet(Theta)
                          + lambda * ||P . Theta||_1

with ``S`` the empirical covariance and ``P`` the penalty mask
(off-diagonals by default, as sklearn's ``graphical_lasso``;
``penalize_diagonal=True`` penalizes everything, as R's ``glasso``).
Boyd et al. (2011) section 6.5: ``Theta - Z = 0``,

* x-update: the logdet prox, ``rho Theta - Theta^{-1} = G`` with
  ``G = rho z - y - S``, solved as ``Theta = (G + sqrt(G^2 + 4 rho I)) /
  (2 rho)`` with the square root by a coupled NEWTON-SCHULZ iteration
  (``xupdate="newton"``, the default: three (p, p) products per step), or
  by the eigendecomposition ``Theta = Q diag(f(w)) Q'`` (``"eigh"``);
* z-update: the masked soft threshold of ``Theta + y/rho``.

Nothing is factorized and cached, so the plain-ADMM ADAPTIVE rho ladder
runs (reference: src/ADMMBase.h:85-109).

The Newton-Schulz loop of the JAX package is a ``lax.while_loop`` that
exits once ``||Z Y - I||_F <= tol`` (14-22 steps, capped at 60).  Here it
stays on the device: steps run in chunks of ``_NS_CHUNK``, each lane (a
path lane, or a fold's) frozen with ``torch.where`` from the step at which
it met the exit rule, and one flag is read on the host per chunk.  The
result is the JAX exit rule's.

Matrix state: each lane's (p, p) iterate travels flattened, ``(...,
p * p)``, so the engine's last-axis norms are the JAX package's Frobenius
norms (as in :mod:`admm_tpu_torch.models.multitask`).  No kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, make_admm_solver, make_batched_solver,
                           make_state)
from ..core.prox import l2norm, soft_threshold
from ..parallel.mesh import all_sum, blockwise
from .lasso import (_as_data, _as_tensor, _batched_cold_states, _linspace,
                    _scan_path)
from .multitask import _flat, _lane, _mat

# Newton-Schulz steps between two host reads of the "any lane still
# iterating" flag; the JAX package's loop exits after 14-22 steps.
_NS_CHUNK = 8


class GlassoResult(NamedTuple):
    """Graphical-lasso path result."""
    lambdas: torch.Tensor    # (nlambda,) penalty grid
    precision: torch.Tensor  # (nlambda, p, p) sparse precision matrices (Z)
    cov: torch.Tensor        # (p, p) the empirical covariance S solved on
    niter: torch.Tensor      # (nlambda,) int32 ADMM iteration counts
    # (nlambda, trace_len, 5) per-iteration residual trace (scan mode)
    trace: Optional[torch.Tensor] = None


def empirical_covariance(X, weights=None, *, assume_centered=False,
                         dtype=torch.float32, device="cuda"):
    """Weighted MLE covariance ``sum_i w_i (x_i - mu)(x_i - mu)' / sum w``
    (the 1/n convention of sklearn's ``empirical_covariance``); an integer
    weight k is exactly row repetition."""
    X = _as_tensor(X, dtype, device)
    n = X.shape[0]
    w = (torch.ones((n,), dtype=dtype, device=X.device) if weights is None
         else _as_tensor(weights, dtype, X.device).reshape(-1))
    return _weighted_cov(X, w, assume_centered)[0]


def _weighted_cov(X, w, assume_centered=False):
    """``(S, mu)``: the weighted covariance and mean, accumulated in
    float64 and rounded once to X's dtype.  A float32 product of the
    centered rows lands further from float64 than the JAX package's
    float32 ``dot`` on the CPU (0.9-4.5 times at n = 150), and the float32
    path follows S (``tests/glasso_f32_gap.py``)."""
    Xd, wd = blockwise(X, lambda b, sl: b.double()), w.double()
    sw = torch.sum(wd)
    mu = (wd @ Xd) / sw
    Xc = Xd if assume_centered else Xd - mu[None, :]
    S = (Xc * wd[:, None]).mT @ Xc / sw
    return S.to(w.dtype), mu.to(w.dtype)


def _logdet_prox_eigh(G, rho):
    """The eigendecomposition form of the logdet prox: solve ``rho Theta -
    Theta^{-1} = G`` through ``G = Q diag(w) Q'`` (``G`` a matrix or a
    batch, ``rho`` a scalar or one per matrix)."""
    w, Q = torch.linalg.eigh(G)
    r = rho[..., None] if isinstance(rho, torch.Tensor) else rho
    theta = (w + torch.sqrt(w * w + 4.0 * r)) / (2.0 * r)
    xn = (Q * theta[..., None, :]) @ Q.mT
    return 0.5 * (xn + xn.mT)


def _logdet_prox_newton(G, rho, max_iters=60):
    """The matmul-only logdet prox: ``Theta = (G + sqrt(M)) / (2 rho)``
    with ``M = G^2 + 4 rho I`` (SPD, spectrum >= 4 rho) and its square
    root by the coupled Newton-Schulz iteration on ``M / ||M||_F``.  A
    matrix's steps stop (``torch.where``) once ``||Z Y - I||_F <= sqrt(p)
    * tol`` (1e-13 in float64, 1e-6 otherwise) or after ``max_iters``, as
    the JAX package's ``while_loop``; the host reads one flag per
    ``_NS_CHUNK`` steps (module docstring)."""
    p = G.shape[-1]
    dtype, dev = G.dtype, G.device
    eye = torch.eye(p, dtype=dtype, device=dev)
    rho_m = _lane(rho) if isinstance(rho, torch.Tensor) else rho
    M = G @ G + (4.0 * rho_m) * eye
    c = torch.sqrt(torch.sum(M * M, dim=(-2, -1)))   # ||M||_F >= lambda_max
    Y = M / _lane(c)
    Z = eye.expand_as(Y)
    tol = float(np.sqrt(p)) * (1e-13 if dtype == torch.float64 else 1e-6)
    active = torch.ones(G.shape[:-2], dtype=torch.bool, device=dev)
    k = 0
    while k < max_iters:
        for _ in range(min(_NS_CHUNK, max_iters - k)):
            W = Z @ Y
            T = 0.5 * (3.0 * eye - W)
            err = torch.sqrt(torch.sum((W - eye) ** 2, dim=(-2, -1)))
            a = _lane(active)
            Y, Z = torch.where(a, Y @ T, Y), torch.where(a, T @ Z, Z)
            active = active & (err > tol)
            k += 1
        if not bool(torch.any(active)):
            break
    xn = (G + _lane(torch.sqrt(c)) * Y) / (2.0 * rho_m)
    return 0.5 * (xn + xn.mT)


def _glasso_ops(S, pen_mask, p, xupdate="newton") -> ProblemOps:
    prox = (_logdet_prox_newton if xupdate == "newton"
            else _logdet_prox_eigh)

    def next_x(st):
        G = _lane(st.rho) * _mat(st.z, p) - _mat(st.y, p) - S
        G = 0.5 * (G + G.mT)
        return _flat(prox(G, st.rho))

    def next_z(st, x_new):
        v = x_new + st.y / st.rho[..., None]
        thr = _flat(_lane(st.lam / st.rho) * pen_mask)
        return soft_threshold(v, thr), None

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=p * p, dim_dual=p * p,
    )


def _start_rho(rho0, dtype, device):
    return torch.tensor(rho0 if rho0 > 0 else 1.0, dtype=dtype, device=device)


def _glasso_engine(S, pen_mask, lam_first, rho0, xupdate="newton"):
    """(cold state, solver, report) of one lane; the report is Z, where
    the exact zeros (the support) live (Theta = x is its PD twin within
    the solver's tolerance)."""
    p = S.shape[-1]
    ops = _glasso_ops(S, pen_mask, p, xupdate)
    solve = make_admm_solver(ops, adapt_rho=True)
    Z = torch.zeros((p * p,), dtype=S.dtype, device=S.device)
    st0 = make_state(Z, Z, Z, _start_rho(rho0, S.dtype, S.device), lam_first)
    return st0, solve, (lambda st: _mat(st.z, p))


def _solve_glasso(S, pen_mask, lams, rho0, maxit, eps_abs, eps_rel,
                  path_mode, trace_len=None, xupdate="newton"):
    p = S.shape[-1]
    if path_mode == "batch":
        ops = _glasso_ops(S, pen_mask, p, xupdate)
        solve = make_batched_solver(make_admm_solver(ops, adapt_rho=True))
        st = _batched_cold_states(lams.shape[0], p * p,
                                  _start_rho(rho0, S.dtype, S.device), lams)
        st = solve(st, maxit, eps_abs, eps_rel)
        return _mat(st.z, p), st.it, None
    st0, solve, report = _glasso_engine(S, pen_mask, lams[0], rho0, xupdate)
    _, precs, niter, traces = _scan_path(st0, solve, report, lams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return precs, niter, traces


def _pen_mask(p, penalize_diagonal, dtype, device):
    eye = torch.eye(p, dtype=dtype, device=device)
    return torch.ones_like(eye) if penalize_diagonal else 1.0 - eye


def _glasso_path_dev(S, nlambda, lambda_min_ratio, user_lams, rho0, maxit,
                     eps_abs, eps_rel, *, penalize_diagonal, path_mode,
                     trace_len=None, xupdate="newton"):
    p = S.shape[-1]
    eye = torch.eye(p, dtype=S.dtype, device=S.device)
    pen_mask = _pen_mask(p, penalize_diagonal, S.dtype, S.device)
    if user_lams is None:
        # Grid top: for lambda >= max|offdiag(S)| a DIAGONAL precision
        # satisfies the KKT system, so the path starts at the empty graph.
        # A diagonal S makes that 0: fall back to the diagonal scale.
        lam0 = torch.max(torch.abs(S * (1.0 - eye)))
        lam0_fb = torch.clamp(torch.max(torch.abs(S)), min=1.0)
        lam0 = torch.where(torch.isfinite(lam0) & (lam0 > 0), lam0, lam0_fb)
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    precs, niter, traces = _solve_glasso(S, pen_mask, lams, rho0, maxit,
                                         eps_abs, eps_rel, path_mode,
                                         trace_len, xupdate)
    return GlassoResult(lambdas=lams, precision=precs, cov=S, niter=niter,
                        trace=traces)


def glasso_path(X=None, *, cov=None, weights=None, lambdas=None,
                nlambda: int = 20, lambda_min_ratio: float = 1e-2,
                penalize_diagonal: bool = False,
                assume_centered: bool = False, maxit: int = 10000,
                eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                rho: float = -1.0, path_mode: str = "scan",
                xupdate: str = "newton", trace_len: Optional[int] = None,
                data_mesh=None, dtype=torch.float32,
                device="cuda") -> GlassoResult:
    """Solve the graphical-lasso lambda path.

    Same arguments and defaults as ``admm_tpu.glasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  Pass the (n, p) data ``X`` (its weighted empirical
    covariance is formed on the device) or a (p, p) covariance ``cov=``
    (``lambdas`` then on sklearn's ``alpha`` scale).  The auto grid runs
    from the empty-graph threshold ``max|offdiag(S)|`` down by
    ``lambda_min_ratio``.  ``path_mode``: "scan" (warm starts, the
    default) or "batch" (lambdas as lanes); ``trace_len`` implies scan.
    ``xupdate``: "newton" (Newton-Schulz square root) or "eigh".
    ``data_mesh`` shards X's rows over a mesh: the weighted mean and
    covariance (in float64, as without a mesh) are sums over the mesh.
    """
    if (X is None) == (cov is None):
        raise ValueError("pass exactly one of X or cov")
    if cov is not None:
        S = _as_tensor(cov, dtype, device)
        if S.dim() != 2 or S.shape[0] != S.shape[1]:
            raise ValueError("cov must be a square (p, p) matrix")
        if weights is not None:
            raise ValueError("weights apply to X, not a precomputed cov")
        if data_mesh is not None:
            raise ValueError("data_mesh shards X's rows; a precomputed "
                             "cov has none")
    else:
        Xd = _as_data(X, dtype, device, data_mesh)
        w = (torch.ones((Xd.shape[0],), dtype=dtype, device=Xd.device)
             if weights is None
             else _as_tensor(weights, dtype, Xd.device).reshape(-1))
        S = _weighted_cov(Xd, w, assume_centered)[0]
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if xupdate not in ("newton", "eigh"):
        raise ValueError("xupdate must be 'newton' or 'eigh'")
    if trace_len is not None:
        path_mode, trace_len = "scan", int(trace_len)
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, S.device).reshape(-1),
                            descending=True).values)
    return _glasso_path_dev(S, int(nlambda), lambda_min_ratio, lams, rho,
                            maxit, eps_abs, eps_rel,
                            penalize_diagonal=bool(penalize_diagonal),
                            path_mode=path_mode, trace_len=trace_len,
                            xupdate=xupdate)


# ---------------------------------------------------------------------------
# Cross-validation: held-out Gaussian log-likelihood, one-pass protocol.
# ---------------------------------------------------------------------------

class CVGlassoResult(NamedTuple):
    lambdas: np.ndarray   # (nlambda,) shared grid
    cvm: np.ndarray       # (nlambda,) mean held-out negative log-lik
    cvsd: np.ndarray      # (nlambda,) its standard error
    lambda_min: float     # grid point minimising cvm
    lambda_1se: float     # largest lambda with cvm <= min + 1 se
    fit: GlassoResult     # full-data path on the same grid
    foldid: np.ndarray    # (n,) fold assignment


def _fold_cov(X, w):
    """Weighted empirical covariance and mean of one fold's training rows
    (weight 0 on the held-out ones)."""
    return _weighted_cov(X, w)


def _cv_glasso_core(X, masks, w, lams, rho0, maxit, eps_abs, eps_rel, *,
                    penalize_diagonal, xupdate="newton", mesh=None):
    """The fold sweep: fold f's path is the scan path on the weighted
    covariance with weight 0 on its held-out rows (the JAX package's
    vmapped lanes, one after another here), scored on the device.

    Returns ``(quad (n, L), logdet (nfolds, L))``: row i's Mahalanobis
    term under the fit of the fold that held it out (centered by that
    fold's training mean) and each fold's log-determinants, the two
    pieces of the per-observation Gaussian negative log-likelihood.  On a
    ``mesh`` (``fold_mesh``) this process solves its own folds
    (``cv._own_folds``); ``quad`` gains only zeros off a fold's rows and
    the log-determinants are zero-filled, so the sums across positions
    are exact."""
    from .cv import _own_folds

    p, nf = X.shape[1], masks.shape[0]
    pen_mask = _pen_mask(p, penalize_diagonal, X.dtype, X.device)
    quad = torch.zeros((lams.shape[0], X.shape[0]), dtype=X.dtype,
                       device=X.device)
    logdets = torch.zeros((nf, lams.shape[0]), dtype=X.dtype,
                          device=X.device)
    for f in (range(nf) if mesh is None
              else _own_folds(nf, mesh, X.device)):
        mask = masks[f]
        S_f, mu_f = _fold_cov(X, w * mask)
        precs, _, _ = _solve_glasso(S_f, pen_mask, lams, rho0, maxit,
                                    eps_abs, eps_rel, "scan",
                                    xupdate=xupdate)
        Xc = X - mu_f[None, :]
        # (L, n) per-row quadratic forms, this fold's held-out rows only.
        q = torch.einsum("np,lpq,nq->ln", Xc, precs, Xc)
        quad = quad + q * (1.0 - mask)[None, :]
        sign, logdet = torch.linalg.slogdet(precs)
        logdets[f] = torch.where(sign > 0, logdet,
                                 torch.full_like(logdet, -float("inf")))
    if mesh is not None:
        quad, logdets = all_sum([quad], mesh), all_sum([logdets], mesh)
    return quad.mT, logdets


def cv_glasso_path(X, *, nfolds: int = 10, foldid=None, weights=None,
                   lambdas=None, nlambda: int = 20,
                   lambda_min_ratio: float = 1e-2,
                   penalize_diagonal: bool = False, maxit: int = 10000,
                   eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                   rho: float = -1.0, xupdate: str = "newton",
                   seed: int = 0, fold_mesh=None, dtype=torch.float32,
                   device="cuda") -> CVGlassoResult:
    """K-fold CV of the graphical lasso (sklearn's ``GraphicalLassoCV``),
    scored by the held-out Gaussian negative log-likelihood ``(x - mu)'
    Theta (x - mu) - logdet Theta`` per observation (test rows centered by
    the TRAINING fold's mean).  Same arguments as
    ``admm_tpu.cv_glasso_path`` plus ``device``; folds from numpy's
    ``default_rng(seed)`` as there.  The grid comes from the full data;
    cvm/cvsd follow glmnet's per-observation aggregation.  ``fold_mesh``
    (a mesh of :mod:`admm_tpu_torch.parallel.mesh`, nfolds a multiple of
    its size) deals the folds over its positions."""
    from .cv import _cv_foldid

    Xd = _as_tensor(X, dtype, device)
    n = Xd.shape[0]
    foldid, nfolds = _cv_foldid(n, int(nfolds), seed, foldid)
    w = (torch.ones((n,), dtype=dtype, device=Xd.device) if weights is None
         else _as_tensor(weights, dtype, Xd.device).reshape(-1))

    fit = glasso_path(Xd, weights=weights, lambdas=lambdas, nlambda=nlambda,
                      lambda_min_ratio=lambda_min_ratio,
                      penalize_diagonal=penalize_diagonal, maxit=maxit,
                      eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                      xupdate=xupdate, dtype=dtype, device=Xd.device)
    lams = fit.lambdas
    masks = torch.as_tensor(foldid[None, :] != np.arange(nfolds)[:, None],
                            dtype=dtype, device=Xd.device)
    quad, logdet = _cv_glasso_core(
        Xd, masks, w, lams, rho, maxit, eps_abs, eps_rel,
        penalize_diagonal=bool(penalize_diagonal), xupdate=xupdate,
        mesh=fold_mesh)
    quad = quad.detach().cpu().numpy()       # (n, L)
    logdet = logdet.detach().cpu().numpy()   # (F, L)

    # Per-observation negative log-likelihood (constants dropped); rows
    # with foldid < 0 are never held out and are not scored.
    scored = foldid >= 0
    cvraw = (quad - logdet[np.clip(foldid, 0, None)])[scored]
    ws = w.detach().cpu().numpy()[scored]
    ws = ws / ws.sum()
    nsc = int(scored.sum())
    cvm = ws @ cvraw
    cvsd = np.sqrt((ws @ (cvraw - cvm) ** 2) / max(nsc - 1, 1))
    imin = int(np.argmin(cvm))
    lam_np = lams.detach().cpu().numpy()
    ok = cvm <= cvm[imin] + cvsd[imin]
    return CVGlassoResult(lambdas=lam_np, cvm=cvm, cvsd=cvsd,
                          lambda_min=float(lam_np[imin]),
                          lambda_1se=float(lam_np[np.flatnonzero(ok)[0]]),
                          fit=fit, foldid=foldid)


def partial_correlations(precision):
    """The partial-correlation matrix of a precision matrix (or a (k, p,
    p) path of them): ``P_ij = -Theta_ij / sqrt(Theta_ii Theta_jj)`` with
    a unit diagonal, the scale-free edge weights of the Gaussian
    graphical model.  A tensor stays on its device; anything else is
    read as a float64 CPU tensor."""
    T = (precision if isinstance(precision, torch.Tensor)
         else torch.as_tensor(np.asarray(precision)))
    d = torch.sqrt(torch.abs(torch.diagonal(T, dim1=-2, dim2=-1)))
    P = -T / (d[..., :, None] * d[..., None, :])
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    return P * (1.0 - eye) + eye
