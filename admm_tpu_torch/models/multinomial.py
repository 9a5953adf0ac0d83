"""Sparse multinomial (softmax) logistic regression paths (counterpart of
``admm_tpu/models/multinomial.py``; an extension beyond the reference),
glmnet's ``family="multinomial"``::

    minimize  1/n sum_i [log sum_c exp(eta_ic) - eta_{i, y_i}]
              + lambda * P(B),      eta = b0 + X B,  B (p, C)

with the ungrouped elastic-net penalty (glmnet's default) or the grouped
row norm (``type.multinomial = "grouped"``).  The fixed-majorizer design
of the GLM paths: the softmax Hessian is dominated by ``1/2 I``, so the
loss Hessian over vec(B) by ``(X'X / (2n)) (x) I_C``, and the x-update is
``newton_steps`` steps against ONE cached (q, q) inverse whatever the
number of classes.  The JAX package's ``fori_loop``s (those steps, the
null intercepts' 100 steps under an offset) are plain ``for`` loops.

Each lane's (q, C) block travels flattened as ``(..., q * C)`` through
the engine, so its norms are Frobenius as in the JAX package
(:mod:`admm_tpu_torch.models.multitask`).  The intercepts are reported
sum-to-zero (the softmax shift gauge, glmnet's convention).  No kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, make_admm_solver, make_batched_solver,
                           make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..interop import to_numpy
from ..linalg import ridge_inverse
from .glm import prep_design
from .lasso import (_as_data, _as_tensor, _linspace, _scan_path,
                    validate_pf_limits)
from .multitask import _broadcast_lanes, _flat, _keep_mask, _lane, _mat


class MNPathResult(NamedTuple):
    """Multinomial path result (original data scale)."""
    lambdas: torch.Tensor  # (nlambda,)
    beta0: torch.Tensor    # (nlambda, C) sum-to-zero intercepts
    coef: torch.Tensor     # (nlambda, p, C)
    niter: torch.Tensor    # (nlambda,) int32
    # (nlambda, trace_len, 5) per-iteration residual trace when requested.
    trace: Optional[torch.Tensor] = None


def _softmax_grad(Xa, B, Yoh, n, obs_w=None, off=None):
    """``(..., q, C)`` gradient of the mean NLL at ``B``: ``Xa'(w o
    (softmax - Y)) / n`` (``obs_w`` normalized observation weights, ``off``
    an (n, C) offset, either None)."""
    eta = Xa @ B
    if off is not None:
        eta = eta + off
    g = torch.softmax(eta, dim=-1) - Yoh
    if obs_w is not None:
        g = obs_w[:, None] * g
    return (Xa.mT @ g) / n


def _mn_ops(Xa, Yoh, n, q, C, pen_mask, alpha, grouped, newton_steps,
            fixed_minv, obs_w=None, keep=None, off=None) -> ProblemOps:
    """``pen_mask`` (q,): 0 on the intercept row, the per-row penalty
    factors on the slopes; ``keep`` (q,) zeroes excluded rows after the
    prox (exact for both penalties, all row separable)."""
    mask = pen_mask[:, None]

    def next_x(st):
        rho = _lane(st.rho)
        v = _mat(st.z - st.y / st.rho[..., None], C)
        B = _mat(st.x, C)
        for _ in range(newton_steps):
            grad = (_softmax_grad(Xa, B, Yoh, n, obs_w, off)
                    + rho * (B - v))
            B = B - fixed_minv @ grad
        return _flat(B)

    def next_z(st, x_new):
        v = _mat(x_new + st.y / st.rho[..., None], C)
        pen = _lane(st.lam / st.rho) * mask
        if grouped:
            rn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
            z = v * torch.clamp(1.0 - pen / torch.clamp(rn, min=1e-30),
                                min=0.0)
        else:
            z = soft_threshold(v, alpha * pen) / (1.0 + pen * (1.0 - alpha))
        if keep is not None:
            z = z * keep[:, None]
        return _flat(z), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=q * C, dim_dual=q * C,
    )


def _mn_engine(Xa, Yoh, lam_first, rho0, pen_mask, alpha, grouped,
               newton_steps, obs_w=None, keep=None, off=None):
    """(cold state, solver, reported iterate).  Fixed majorizer: the
    softmax curvature bound 1/2, shared across classes.  Auto-rho 1/(4C)
    (the JAX package's DESIGN.md "Multinomial rho", measured on the TPU)."""
    n, q = Xa.shape
    C = Yoh.shape[1]
    dtype, dev = Xa.dtype, Xa.device
    rho = torch.tensor(rho0 if rho0 > 0 else 1.0 / (4.0 * C), dtype=dtype,
                       device=dev)
    Xw = Xa if obs_w is None else Xa * torch.sqrt(obs_w)[:, None]
    Minv = ridge_inverse(Xw.mT @ Xw / (2.0 * n), rho)
    ops = _mn_ops(Xa, Yoh, n, q, C, pen_mask, alpha, grouped, newton_steps,
                  Minv, obs_w, keep, off)
    solve = make_admm_solver(ops, adapt_rho=False)
    zeros = torch.zeros((q * C,), dtype=dtype, device=dev)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first)
    return st0, solve, (lambda st: _mat(st.z, C))


def _mn_path(X, y, nlambda, lambda_min_ratio, user_lams, rho0, maxit,
             eps_abs, eps_rel, alpha, weights=None, pf=None, keep_p=None,
             off=None, *, nclass, standardize_x, intercept, path_mode,
             grouped, newton_steps, trace_len=None):
    n, p = X.shape
    C = nclass
    dtype, dev = X.dtype, X.device
    w = None
    if weights is not None:
        w = weights.reshape(-1).to(dtype)
        w = w * (n / torch.sum(w))      # glmnet: weights sum to n
    Yoh = torch.nn.functional.one_hot(y.to(torch.int64), C).to(dtype)
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize_x, intercept,
                                             weights=w)
    Xs = Xa[:, 1:] if intercept else Xa
    keep = None
    one1 = torch.ones((1,), dtype=dtype, device=dev)
    if pf is not None:
        pen_mask = pen_mask * (torch.cat([one1, pf]) if intercept else pf)
    if keep_p is not None:
        keep = torch.cat([one1, keep_p]) if intercept else keep_p

    # glmnet's lambda_max: the (weighted) null model's score.  Null
    # probabilities are the (weighted) class frequencies or uniform; with
    # an offset the null intercepts solve the shifted score by 100
    # majorize-minimize steps (curvature bound 1/2 -> step 2/n).
    if off is None:
        if intercept:
            pi0 = (torch.mean(Yoh, dim=0) if w is None
                   else torch.sum(w[:, None] * Yoh, dim=0) / n)
        else:
            pi0 = torch.full((C,), 1.0 / C, dtype=dtype, device=dev)
        P0 = torch.broadcast_to(pi0[None, :], (n, C))
    elif intercept:
        b0 = torch.zeros((C,), dtype=dtype, device=dev)
        for _ in range(100):
            g = torch.softmax(b0[None, :] + off, dim=1) - Yoh
            if w is not None:
                g = w[:, None] * g
            b0 = b0 - (2.0 / n) * torch.sum(g, dim=0)
        P0 = torch.softmax(b0[None, :] + off, dim=1)
    else:
        P0 = torch.softmax(off, dim=1)
    G0 = P0 - Yoh
    if w is not None:
        G0 = w[:, None] * G0
    G0 = (Xs.mT @ G0) / n                                    # (p, C)
    if grouped:
        scores = torch.sqrt(torch.sum(G0 * G0, dim=1))
    else:
        scores = torch.max(torch.abs(G0), dim=1).values
    if keep_p is not None:
        scores = scores * keep_p
    if pf is not None:
        scores = torch.where(pf > 0, scores / torch.clamp(pf, min=1e-12),
                             torch.zeros_like(scores))
    lam0 = torch.max(scores)
    # 1.001 past the grouped boundary: the l2 group prox reaches exact
    # zero only when the threshold strictly exceeds the row norm.
    lam0 = 1.001 * lam0 if grouped else lam0 / max(alpha, 1e-3)
    if user_lams is None:
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    st0, solve, report = _mn_engine(Xa, Yoh, lams[0], rho0, pen_mask, alpha,
                                    grouped, newton_steps, obs_w=w,
                                    keep=keep, off=off)
    traces = None
    if path_mode == "batch":
        st = make_batched_solver(solve)(_broadcast_lanes(st0, lams), maxit,
                                        eps_abs, eps_rel)
        coefs_a, niter = report(st), st.it
    else:
        _, coefs_a, niter, traces = _scan_path(st0, solve, report, lams,
                                               maxit, eps_abs, eps_rel,
                                               trace_len)
    beta0, coef = mn_recover(coefs_a, sd_x, mean_x, C, intercept)
    return MNPathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                        trace=traces)


def mn_recover(coefs_a, sd_x, mean_x, C, intercept):
    """Original-scale recovery of the (L, q, C) softmax blocks, the
    intercepts sum-to-zero normalized."""
    if intercept:
        b0_std, slopes_std = coefs_a[:, 0, :], coefs_a[:, 1:, :]
    else:
        b0_std = torch.zeros((coefs_a.shape[0], C), dtype=coefs_a.dtype,
                             device=coefs_a.device)
        slopes_std = coefs_a
    coef = slopes_std / sd_x[None, :, None]
    beta0 = b0_std - torch.einsum("kpc,p->kc", coef, mean_x)
    return beta0 - torch.mean(beta0, dim=1, keepdim=True), coef


def multinomial_lasso_path(X, y, *, nclass: Optional[int] = None,
                           lambdas=None, nlambda: int = 50,
                           lambda_min_ratio: float = 1e-2,
                           alpha: float = 1.0, grouped: bool = False,
                           standardize: bool = True, intercept: bool = True,
                           maxit: int = 10000, eps_abs: float = 1e-5,
                           eps_rel: float = 1e-5, rho: float = -1.0,
                           path_mode: str = "batch", newton_steps: int = 2,
                           trace_len: Optional[int] = None, data_mesh=None,
                           weights=None, penalty_factor=None, exclude=None,
                           offset=None, dtype=torch.float32,
                           device="cuda") -> MNPathResult:
    """Solve the sparse multinomial (softmax) regression lambda path.

    Same arguments and defaults as ``admm_tpu.multinomial_lasso_path``,
    plus ``device``: tensors stay on their own device, anything else goes
    to ``device``.  ``y``: integer labels in ``[0, C)``, ``nclass``
    defaulting to ``max(y) + 1``.  ``grouped=True`` is the row-wise group
    penalty; the default penalizes every coefficient with the elastic-net
    mix ``alpha``.  ``weights``, ``penalty_factor``, ``exclude`` and the
    (n, C) ``offset`` are glmnet's.  ``data_mesh`` shards X's rows over a
    mesh (the labels stay replicated): the moments, the majorizer's Gram
    and each step's softmax gradient are sums over the mesh, ``X B``
    gathered."""
    X = _as_data(X, dtype, device, data_mesh)
    y_t = torch.as_tensor(np.asarray(to_numpy(y)).ravel(), device=X.device)
    if nclass is None:
        nclass = int(y_t.max()) + 1
    if nclass < 2:
        raise ValueError("need at least 2 classes")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
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
    keep_p = _keep_mask(exclude, p, dtype, X.device)
    off = None
    if offset is not None:
        off = _as_tensor(offset, dtype, X.device)
        if off.shape != (X.shape[0], int(nclass)):
            raise ValueError("offset must be (n, nclass)")
    return _mn_path(X, y_t, int(nlambda), lambda_min_ratio, lams, rho, maxit,
                    eps_abs, eps_rel, alpha, w, pf, keep_p, off,
                    nclass=int(nclass), standardize_x=standardize,
                    intercept=intercept, path_mode=path_mode,
                    grouped=bool(grouped), newton_steps=int(newton_steps),
                    trace_len=trace_len)
