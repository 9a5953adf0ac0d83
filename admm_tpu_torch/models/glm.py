"""Penalized GLM-style smooth-loss paths by ADMM: the family core
(counterpart of ``admm_tpu/models/glm.py``).

One inexact-Newton ADMM engine serves every model of the form ::

    minimize  1/n sum_i loss(eta_i; y_i)
              + lambda (alpha ||b||_1 + (1-alpha)/2 ||b||_2^2),
    eta = b0 + X b

where ``loss`` is smooth (or semi-smooth) in the linear predictor eta.
A family supplies two per-observation callables, ``grad_eta`` (dloss/
deta) and ``weight_eta`` (d2loss/deta2, the IRLS weight), plus the
null-model gradient used for the glmnet lambda_max rule.  Families:
:func:`binomial` (sparse logistic regression, ``models/logistic.py`` wraps
it), :func:`huber` (robust regression; M -> inf is the gaussian Lasso),
:func:`poisson`, and the family objects :func:`binomial_probit`,
:func:`binomial_cloglog`, :func:`gamma_log`, :func:`negative_binomial`.

ADMM splitting ``b - z = 0`` with f = the smooth loss and g = the
penalty; the x-update is ``newton_steps`` inner steps warm-started from
the previous iterate, the z-update a masked elastic-net prox with the
intercept unpenalized.  The inner step takes one of three forms
(``hessian=``): "fixed", one inverse of a global curvature majorizer per
path; "adaptive", one inverse per lambda with a curvature-ratio damping;
"exact", a Hessian build and Cholesky solve per step.

In float32 the batched fixed-majorizer path of binomial and huber runs
through the hand-written kernel of :mod:`admm_tpu_torch.kernels.glm` (its
plain form on the CPU); float64, the other families, per-observation or
per-coefficient options and shapes past the kernel's shared-memory rule
take the generic engine of :mod:`admm_tpu_torch.core.engine`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, col, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import enet_prox, l2norm, sqnorm
from ..data.standardize import _guard, wcolsum
from ..kernels import glm as glm_kernel
from ..linalg import dot, gram, ridge_inverse
from ..parallel.mesh import blockwise, is_sharded, rowsum
from .lasso import (PathResult, _as_data, _as_tensor, _batched_cold_states,
                    _linspace, _scan_path, _truncate_path,
                    validate_pf_limits)

_NEWTON_STEPS = 2


def _also_numpy(fn):
    """A tensor function that also takes numpy arrays: tensors stay on
    their device; numpy arrays are computed on the host in float64 and
    come back as numpy."""
    def apply(*args):
        if isinstance(args[0], torch.Tensor):
            return fn(*args)
        return fn(*(torch.as_tensor(np.asarray(a, np.float64))
                    for a in args)).numpy()

    return apply


def _poisson_deviance(eta, y):
    """Per-observation Poisson deviance from the linear predictor (the
    y log y term follows xlogy semantics: 0 at y = 0)."""
    mu = torch.exp(torch.clamp(eta, max=30.0))
    ylogy = torch.where(y > 0, y * torch.log(torch.clamp(y, min=1e-12)),
                        torch.zeros_like(y))[None, :]
    return 2.0 * (ylogy - y[None, :] * eta - (y[None, :] - mu))


def _wmean(y, w=None):
    """Weighted mean (plain mean when ``w`` is None)."""
    if w is None:
        return torch.mean(y)
    return torch.sum(w * y) / torch.sum(w)


class GLMFamily(NamedTuple):
    """Per-observation derivatives of the loss in the linear predictor.

    ``grad_eta(eta, y)`` = dloss/deta, ``weight_eta(eta, y)`` =
    d2loss/deta2 (the IRLS weight), ``null_resid(y, intercept, w=None)``
    = the null-model -grad used by the lambda_max rule (``w`` =
    observation weights: the null intercept becomes the WEIGHTED
    location estimate, so the weighted grid top still nulls the
    model).  All three take and return tensors."""
    name: str
    grad_eta: Callable
    weight_eta: Callable
    null_resid: Callable
    # Per-observation CV loss loss(eta (k, n), y (n,)) -> (k, n) on
    # tensors or numpy arrays (``_also_numpy``): the deviance-style
    # measure matching the objective.
    cv_loss: Callable
    # Global upper bound on weight_eta (d2loss/deta2), or None when the
    # curvature is unbounded (poisson).  Bounded-curvature families get
    # the FIXED-MAJORIZER x-update: H_fix = bound * X'WX/n >= H(b) for
    # every b, factorized ONCE per path like the gaussian tall solver's
    # ridge inverse; each inner step is then two thin products instead
    # of an (n, q, q) Hessian build + Cholesky.
    curvature_bound: Optional[float] = None
    # Scalar family parameter (huber's M), exposed so non-closure
    # consumers (the CUDA kernel) can rebuild the gradient.
    param: float = 0.0
    # Inverse link mu(eta), on tensors or numpy arrays like cv_loss.
    # None = identity (gaussian-style location families, e.g. huber).
    mean_eta: Optional[Callable] = None
    # cv_loss on tensors alone, for the CV drivers' scoring on the device
    # (the families whose JAX counterpart has one).
    cv_loss_dev: Optional[Callable] = None


def _binomial_deviance(eta, y):
    return 2.0 * (torch.logaddexp(torch.zeros_like(eta), eta)
                  - y[None, :] * eta)


@lru_cache(maxsize=None)
def binomial() -> GLMFamily:
    """Logistic loss: loss(eta; y) = log(1 + e^eta) - y eta."""
    return GLMFamily(
        name="binomial",
        grad_eta=lambda eta, y: torch.sigmoid(eta) - y,
        weight_eta=lambda eta, y: (lambda p: p * (1.0 - p))(
            torch.sigmoid(eta)),
        null_resid=lambda y, intercept, w=None: y - (
            _wmean(y, w) if intercept else 0.5),
        cv_loss=_also_numpy(_binomial_deviance),
        cv_loss_dev=_binomial_deviance,
        curvature_bound=0.25,  # p(1-p) <= 1/4
        mean_eta=_also_numpy(lambda eta: 1.0 / (1.0 + torch.exp(-eta))),
    )


@lru_cache(maxsize=None)
def huber(M: float = 1.345) -> GLMFamily:
    """Huber loss in the residual r = y - eta: r^2/2 for |r| <= M, else
    M|r| - M^2/2.  Semi-smooth: the IRLS weight is the indicator
    |r| <= M (the rho-regularized Newton Hessian stays PD).  M -> inf
    recovers the gaussian Lasso objective exactly."""

    def null_resid(y, intercept, w=None):
        if not intercept:
            return torch.clamp(y, -M, M)
        # The null intercept is the (weighted) HUBER location M-estimate
        # (the root of sum w clip(y - mu, -M, M) = 0), NOT the mean:
        # with asymmetric contamination the mean-anchored grid top would
        # not null the model.  The score is monotone nonincreasing in mu
        # and changes sign on [min(y), max(y)], so plain BISECTION is
        # globally convergent; 60 halvings of the bracket are past
        # float32 AND float64 resolution.  No host read inside the loop.
        def score(mu):
            r = torch.clamp(y - mu, -M, M)
            return torch.sum(r if w is None else w * r)

        lo, hi = torch.min(y), torch.max(y)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            pos = score(mid) > 0  # root is above mid
            lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
        mu = 0.5 * (lo + hi)
        return torch.clamp(y - mu, -M, M)

    def cv_loss_dev(eta, y):
        r = torch.abs(y[None, :] - eta)
        return torch.where(r <= M, 0.5 * r * r, M * r - 0.5 * M * M)

    return GLMFamily(
        name="huber",
        grad_eta=lambda eta, y: -torch.clamp(y - eta, -M, M),
        weight_eta=lambda eta, y: (torch.abs(y - eta) <= M).to(eta.dtype),
        null_resid=null_resid,
        cv_loss=_also_numpy(cv_loss_dev),
        cv_loss_dev=cv_loss_dev,
        curvature_bound=1.0,  # the inlier indicator is <= 1
        param=float(M),
    )


@lru_cache(maxsize=None)
def poisson() -> GLMFamily:
    """Poisson log-likelihood: loss(eta; y) = e^eta - y eta (eta clipped
    at 30 so a transient Newton overshoot cannot overflow float32)."""
    return GLMFamily(
        name="poisson",
        grad_eta=lambda eta, y: torch.exp(torch.clamp(eta, max=30.0)) - y,
        weight_eta=lambda eta, y: torch.exp(torch.clamp(eta, max=30.0)),
        null_resid=lambda y, intercept, w=None: y - (
            _wmean(y, w) if intercept else 1.0),
        cv_loss=_also_numpy(_poisson_deviance),
        cv_loss_dev=_poisson_deviance,
        mean_eta=_also_numpy(
            lambda eta: torch.exp(torch.clamp(eta, max=30.0))),
    )


_LOG_SQRT_2PI = 0.5 * float(np.log(2.0 * np.pi))


def _mills(eta):
    """Inverse Mills ratio phi(eta)/Phi(eta), stable for any eta via
    the log-cdf (never forms the catastrophic phi/Phi quotient)."""
    logpdf = -0.5 * eta * eta - _LOG_SQRT_2PI
    return torch.exp(logpdf - torch.special.log_ndtr(eta))


@lru_cache(maxsize=None)
def binomial_probit() -> GLMFamily:
    """Binomial with the PROBIT link (glmnet 4.x's
    ``family = binomial(link = "probit")`` family-object path):
    loss(eta; y) = -[y log Phi(eta) + (1-y) log Phi(-eta)].

    With r1 = phi/Phi(eta) and r0 = phi/Phi(-eta) (inverse Mills
    ratios, computed in log space), dloss/deta = (1-y) r0 - y r1 and
    d2loss/deta2 = y r1 (r1 + eta) + (1-y) r0 (r0 - eta); both terms
    lie in (0, 1), so the curvature bound 1 drives the same
    fixed-majorizer protocol as the logit link."""
    def cv_loss(eta, y):
        log_ndtr = torch.special.log_ndtr
        return -2.0 * (y[None, :] * log_ndtr(eta)
                       + (1.0 - y[None, :]) * log_ndtr(-eta))

    def null_resid(y, intercept, w=None):
        pbar = (_wmean(y, w) if intercept
                else torch.tensor(0.5, dtype=y.dtype, device=y.device))
        eta0 = torch.special.ndtri(torch.clamp(pbar, 1e-6, 1.0 - 1e-6))
        r1, r0 = _mills(eta0), _mills(-eta0)
        return y * r1 - (1.0 - y) * r0

    return GLMFamily(
        name="binomial_probit",
        grad_eta=lambda eta, y: ((1.0 - y) * _mills(-eta)
                                 - y * _mills(eta)),
        weight_eta=lambda eta, y: (
            y * (lambda r: r * (r + eta))(_mills(eta))
            + (1.0 - y) * (lambda r: r * (r - eta))(_mills(-eta))),
        null_resid=null_resid,
        cv_loss=_also_numpy(cv_loss),
        curvature_bound=1.0,  # r(r +/- eta) < 1 for every eta
        mean_eta=_also_numpy(torch.special.ndtr),
    )


@lru_cache(maxsize=None)
def binomial_cloglog() -> GLMFamily:
    """Binomial with the COMPLEMENTARY LOG-LOG link (glmnet 4.x's
    ``binomial(link = "cloglog")``): p = 1 - exp(-e^eta),
    loss(eta; y) = -[y log p + (1-y) log(1-p)] with log(1-p) = -e^eta.

    With t = e^eta and s = t e^{-t} / (1 - e^{-t}) (-> 1 as t -> 0),
    dloss/deta = (1-y) t - y s; the y=0 curvature is t itself,
    UNBOUNDED, so the family runs the adaptive per-lambda majorizer
    like poisson."""
    def _s(t):
        # t e^{-t} / (1 - e^{-t}), series-guarded at t -> 0.
        p = -torch.expm1(-t)
        return torch.where(t < 1e-6, 1.0 - 0.5 * t,
                           t * torch.exp(-t) / torch.clamp(p, min=1e-30))

    def grad_eta(eta, y):
        t = torch.exp(torch.clamp(eta, max=30.0))
        return (1.0 - y) * t - y * _s(t)

    def weight_eta(eta, y):
        t = torch.exp(torch.clamp(eta, max=30.0))
        p = torch.clamp(-torch.expm1(-t), min=1e-30)
        # d(-s)/deta = t e^{-t} (t - p) / p^2  (-> t/2 as t -> 0).
        w1 = torch.where(t < 1e-6, 0.5 * t,
                         t * torch.exp(-t) * (t - p) / (p * p))
        return y * w1 + (1.0 - y) * t

    def null_resid(y, intercept, w=None):
        eta0 = torch.zeros((), dtype=y.dtype, device=y.device)
        if intercept:
            pbar = torch.clamp(_wmean(y, w), 1e-6, 1.0 - 1e-6)
            eta0 = torch.log(-torch.log1p(-pbar))
        return -grad_eta(eta0 + torch.zeros_like(y), y)

    def cv_loss(eta, y):
        t = torch.exp(torch.clamp(eta, max=30.0))
        logp = torch.log(torch.clamp(-torch.expm1(-t), min=1e-300))
        return -2.0 * (y[None, :] * logp - (1.0 - y[None, :]) * t)

    return GLMFamily(
        name="binomial_cloglog",
        grad_eta=grad_eta,
        weight_eta=weight_eta,
        null_resid=null_resid,
        cv_loss=_also_numpy(cv_loss),
        mean_eta=_also_numpy(lambda eta: -torch.expm1(
            -torch.exp(torch.clamp(eta, max=30.0)))),
    )


@lru_cache(maxsize=None)
def gamma_log() -> GLMFamily:
    """Gamma regression with the log link (glmnet 4.x's
    ``family = Gamma(link = "log")``), y > 0: the unit-shape negative
    log-likelihood loss(eta; y) = y e^{-eta} + eta (the shape parameter
    scales the objective uniformly, so the path is shape-free, exactly
    as glmnet's IRLS is).  Curvature y e^{-eta} is unbounded -> the
    adaptive per-lambda majorizer (the poisson protocol)."""
    def cv_loss(eta, y):
        # Gamma deviance: 2 [ (y - mu)/mu - log(y/mu) ], mu = e^eta.
        mu = torch.exp(torch.clamp(eta, -30.0, 30.0))
        r = y[None, :] / mu
        return 2.0 * (r - 1.0 - torch.log(torch.clamp(r, min=1e-300)))

    return GLMFamily(
        name="gamma_log",
        grad_eta=lambda eta, y: 1.0 - y * torch.exp(
            torch.clamp(-eta, max=30.0)),
        weight_eta=lambda eta, y: y * torch.exp(torch.clamp(-eta, max=30.0)),
        null_resid=lambda y, intercept, w=None: (
            y / _wmean(y, w) - 1.0 if intercept else y - 1.0),
        cv_loss=_also_numpy(cv_loss),
        mean_eta=_also_numpy(
            lambda eta: torch.exp(torch.clamp(eta, -30.0, 30.0))),
    )


@lru_cache(maxsize=None)
def negative_binomial(theta: float = 1.0) -> GLMFamily:
    """Negative-binomial (NB2) regression with the log link and FIXED
    dispersion ``theta`` (the MASS::glm.nb likelihood at known theta):
    loss(eta; y) = (y + theta) log(theta + e^eta) - y eta.  theta -> inf
    recovers poisson.  Curvature theta (y+theta) mu / (mu+theta)^2 <=
    (y+theta)/4 is data-dependent -> the adaptive per-lambda majorizer."""
    th = float(theta)
    if th <= 0:
        raise ValueError("theta must be positive")

    def grad_eta(eta, y):
        mu = torch.exp(torch.clamp(eta, max=30.0))
        return (y + th) * mu / (mu + th) - y

    def weight_eta(eta, y):
        mu = torch.exp(torch.clamp(eta, max=30.0))
        return th * (y + th) * mu / torch.square(mu + th)

    def cv_loss(eta, y):
        # NB2 deviance at fixed theta: 2 [ y log(y/mu)
        #   - (y+theta) log((y+theta)/(mu+theta)) ], xlogy at y = 0.
        mu = torch.exp(torch.clamp(eta, -30.0, 30.0))
        yb = y[None, :]
        ylogy = torch.where(
            yb > 0, yb * torch.log(torch.clamp(yb, min=1e-300) / mu),
            torch.zeros_like(mu))
        return 2.0 * (ylogy - (yb + th) * torch.log((yb + th) / (mu + th)))

    def null_resid(y, intercept, w=None):
        mu0 = _wmean(y, w) if intercept else 1.0
        return y - (y + th) * mu0 / (mu0 + th)

    return GLMFamily(
        name="negative_binomial",
        grad_eta=grad_eta,
        weight_eta=weight_eta,
        null_resid=null_resid,
        cv_loss=_also_numpy(cv_loss),
        param=th,
        mean_eta=_also_numpy(
            lambda eta: torch.exp(torch.clamp(eta, -30.0, 30.0))),
    )


def prep_design(X, standardize_x: bool, intercept: bool, weights=None):
    """Shared GLM design prep: returns ``(Xa, pen_mask, mean_x, sd_x)``
    with the ones column prepended when an intercept is fitted.

    Flag semantics mirror the gaussian path's modes
    (``data/standardize.py``): standardize WITHOUT intercept scales but
    does NOT center (centering would covertly fit the intercept the caller
    disabled); the near-constant-column guard is the shared relative
    ``_guard``, not a bare sd > 0 check.  ``weights`` (normalized
    observation weights) make the moments WEIGHTED; the rows are NOT
    sqrt(w)-scaled (the smooth loss is not quadratic; the weights enter
    the grad/Hessian terms instead, see :func:`_glm_ops`).
    """
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    mean_x = torch.zeros((p,), dtype=dtype, device=dev)
    sd_x = torch.ones((p,), dtype=dtype, device=dev)
    if standardize_x:
        w = (torch.ones((n,), dtype=dtype, device=dev) if weights is None
             else torch.as_tensor(weights, dtype=dtype, device=dev))
        sw = torch.sum(w)
        col_mean = wcolsum(X, w) / sw
        c = X - col_mean[None, :]
        col_sd = torch.sqrt(wcolsum(c, w, squared=True) / sw)
        sd_x = _guard(col_sd, col_mean)
        if intercept:
            mean_x = col_mean
            X = (X - mean_x[None, :]) / sd_x[None, :]
        else:
            X = X / sd_x[None, :]
    if intercept:
        Xa = blockwise(X, lambda b, sl: torch.cat(
            [torch.ones((b.shape[0], 1), dtype=dtype, device=b.device), b],
            dim=1))
        pen_mask = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                              torch.ones((p,), dtype=dtype, device=dev)])
    else:
        Xa = X
        pen_mask = torch.ones((p,), dtype=dtype, device=dev)
    return Xa, pen_mask, mean_x, sd_x


def recover_glm(coefs_a, mean_x, sd_x, intercept: bool):
    """Map (nlambda, q) standardized-scale GLM coefficients back to the
    original scale; returns ``(beta0, coef)``."""
    if intercept:
        b0_std, slopes_std = coefs_a[:, 0], coefs_a[:, 1:]
    else:
        b0_std = torch.zeros((coefs_a.shape[0],), dtype=coefs_a.dtype,
                             device=coefs_a.device)
        slopes_std = coefs_a
    coef = slopes_std / sd_x[None, :]
    beta0 = b0_std - slopes_std @ (mean_x / sd_x)
    return beta0, coef


def _wgram(Xa, w):
    """``Xa' diag(w) Xa`` for one weight vector (n,) or lanes (K, n); of
    a row-sharded Xa, a sum over the mesh."""
    return rowsum(Xa, lambda b, sl: (b.mT * w[..., sl].unsqueeze(-2)) @ b)


def _glm_ops(Xa, ys, family: GLMFamily, n, q, pen_mask, alpha,
             newton_steps, obs_w=None, fixed_minv=None, offset=None,
             adaptive=False, bounds=None):
    """ProblemOps for the smooth-loss ADMM, for one state ``(q,)`` and for
    lanes ``(K, q)`` alike; ``Xa`` (n, q) includes the ones column when an
    intercept is fitted.  ``obs_w`` (normalized observation weights
    summing to n, or None) multiplies the per-observation gradient and
    IRLS-weight terms: the weighted loss ``1/n sum_i w_i loss(eta_i; y_i)``
    with one extra (n,) multiply.

    ``fixed_minv``: precomputed ``(bound*X'WX/n + rho I)^{-1}`` for
    bounded-curvature families: the FIXED-MAJORIZER inner step
    ``b -= Minv grad`` (a majorize-minimize step: the majorizer dominates
    the true Hessian everywhere, so each step decreases the prox
    subproblem).  It replaces the per-step (n, q, q) Hessian build +
    Cholesky with two thin products, and lets the lanes of the batched
    path share ONE (q, q) matrix.

    ``adaptive``: ``st.aux = (Minv, w_warm)`` rides the state instead, the
    majorizer inverse refreshed once per lambda at the warm start, for
    UNBOUNDED-curvature families (poisson) where no global factorization
    exists.  Poisson's ``w = e^eta`` can GROW without bound mid-segment,
    so the stale inverse alone is not a majorizer; each inner step is
    damped by the pointwise curvature ratio ``r = max_i w_i(eta)/w_warm_i``:
    ``(1/r) Minv grad`` is an exact MM step for the inflated majorizer
    ``r (H_warm + rho I) >= H(eta) + rho I``, so the inner iteration is
    monotone for ANY iterate.  The ratio is a max over n per inner step
    and stays on the device.

    Otherwise the exact Hessian is built and factorized (Cholesky) every
    inner step, lane by lane."""
    eye = torch.eye(q, dtype=Xa.dtype, device=Xa.device)

    def newton(v, rho, b, minv, w_warm):
        for _ in range(newton_steps):
            eta = b @ Xa.mT
            if offset is not None:
                eta = eta + offset
            g = family.grad_eta(eta, ys)
            if obs_w is not None:
                g = obs_w * g
            grad = (g @ Xa) / n + col(rho) * (b - v)
            if minv is not None:
                d = grad @ minv.mT          # Minv @ grad, lane by lane
                if w_warm is None:
                    b = b - d
                    continue
                wc = family.weight_eta(eta, ys)
                r = torch.clamp(torch.amax(
                    wc / torch.clamp(w_warm, min=1e-12), dim=-1), min=1.0)
                b = b - d / col(r)
                continue
            w = family.weight_eta(eta, ys)
            if obs_w is not None:
                w = obs_w * w
            H = _wgram(Xa, w) / n
            H = H + col(col(rho)) * eye
            L = torch.linalg.cholesky(H)
            b = b - torch.cholesky_solve(grad.unsqueeze(-1), L).squeeze(-1)
        return b

    def next_x(st):
        # Plain-ADMM engine: prox center from (z, y), not adj_*.
        v = st.z - st.y / col(st.rho)
        if adaptive:
            minv, w_warm = st.aux
        else:
            minv, w_warm = fixed_minv, None
        return newton(v, st.rho, st.x, minv, w_warm)

    def next_z(st, x_new):
        v = x_new + st.y / col(st.rho)
        pen = col(st.lam / st.rho) * pen_mask
        z = enet_prox(v, pen, alpha)
        if bounds is not None:
            # glmnet's coefficient box: penalty and box are both
            # separable, so clip-after-shrink is the exact prox.
            z = torch.clamp(z, min=bounds[0], max=bounds[1])
        return z, st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x), l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=q, dim_dual=q,
    )


def _null_resid_with_offset(family, y, offset, intercept, w=None):
    """Null-model residual (-grad) when an OFFSET rides the linear
    predictor: the null intercept solves the monotone 1-D score
    ``sum w grad_eta(b0 + offset, y) = 0`` (loss convex in eta, so
    bisection on a widening bracket is globally convergent for every
    family); without an intercept the null predictor is the offset
    itself."""
    if not intercept:
        g = family.grad_eta(offset, y)
        return -(g if w is None else w * g)

    def score(b0):
        g = family.grad_eta(b0 + offset, y)
        return torch.sum(g if w is None else w * g)

    # Bracket: the data range shifted past the offset range covers the
    # root for all shipped families (monotone nondecreasing score).
    lo = torch.min(y) - torch.max(torch.abs(offset)) - 30.0
    hi = torch.max(y) + torch.max(torch.abs(offset)) + 30.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        pos = score(mid) < 0  # score increasing: root above mid
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    b0 = 0.5 * (lo + hi)
    g = family.grad_eta(b0 + offset, y)
    return -(g if w is None else w * g)


def _use_kernel_glm(n: int, q: int, dtype, X=None) -> bool:
    """GLM kernel: float32, the port's dispatch bound ``7q + 2n <= 57600``
    (``kernels/glm.py::fits``), and all of X on one device (a row-sharded
    X takes the engine)."""
    return (dtype == torch.float32 and glm_kernel.fits(n, q)
            and not is_sharded(X))


def _glm_auto_rho(family, rho0) -> float:
    """Auto-rho = the family's curvature bound (1.0 when unbounded):
    after standardization the loss Hessian is ~ bound * I, so rho =
    bound balances it against the prox term (the reference's choice).
    A Python float: no device read where the kernel takes it."""
    rho0 = float(rho0)
    return rho0 if rho0 > 0 else float(family.curvature_bound or 1.0)


def _glm_fixed_minv(Xa, family, rho, obs_w=None):
    """The fixed-majorizer inverse ``(bound * Xa'W Xa/n + rho I)^{-1}``
    (shared by the engine and the kernel route)."""
    n = Xa.shape[0]
    Xw = Xa if obs_w is None else Xa * torch.sqrt(obs_w)[:, None]
    H_fix = (family.curvature_bound / n) * gram(Xw)
    return ridge_inverse(H_fix, rho)


def _glm_engine(Xa, ys, family, lam_first, rho0, pen_mask, alpha,
                newton_steps, obs_w=None, hessian="exact", offset=None,
                bounds=None):
    """Returns (st0, solve, report, refresh): ``refresh`` is None
    except under ``hessian='adaptive'``, where it maps the warm-start
    iterate to the refreshed per-lambda majorizer inverse (rides
    ``st.aux``): e.g. poisson's H = Xa'diag(e^eta)Xa/n factorized ONCE per
    lambda instead of per inner step."""
    n, q = Xa.shape
    rho = _glm_auto_rho(family, rho0)
    fixed_minv = None
    if hessian == "fixed":
        fixed_minv = _glm_fixed_minv(Xa, family, rho, obs_w)
    ops = _glm_ops(Xa, ys, family, n, q, pen_mask, alpha, newton_steps,
                   obs_w, fixed_minv, offset,
                   adaptive=(hessian == "adaptive"), bounds=bounds)
    solve = make_admm_solver(ops, adapt_rho=False)
    zeros = torch.zeros((q,), dtype=Xa.dtype, device=Xa.device)
    refresh = None
    aux = None
    if hessian == "adaptive":
        def refresh(b):
            eta = dot(Xa, b)
            if offset is not None:
                eta = eta + offset
            w_warm = family.weight_eta(eta, ys)
            wm = w_warm if obs_w is None else obs_w * w_warm
            H = _wgram(Xa, wm) / n
            # (Minv, w_warm): the damping ratio compares RAW family
            # curvatures (obs_w scales both sides identically and a
            # zero weight must not poison the max).
            return (ridge_inverse(H, rho), w_warm)

        aux = refresh(zeros)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first, aux=aux)
    return st0, solve, (lambda st: st.z), refresh


def _glm_path(X, y, nlambda, lambda_min_ratio, user_lams, rho, maxit,
              eps_abs, eps_rel, alpha, weights=None, offset=None,
              pf=None, limits=None, *,
              family, standardize_x, intercept, path_mode,
              trace_len=None, newton_steps=_NEWTON_STEPS, hessian="auto"):
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    fam = family() if not isinstance(family, GLMFamily) else family
    w = None
    if weights is not None:
        w = weights.reshape(-1)
        w = w * (n / torch.sum(w))  # glmnet: weights sum to n
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize_x, intercept,
                                             weights=w)
    Xs = Xa[:, 1:] if intercept else Xa
    q = Xa.shape[1]
    if pf is not None:
        # Per-coordinate penalty factors ride the existing mask (the
        # intercept entry is already 0).
        pfq = (torch.cat([torch.ones((1,), dtype=dtype, device=dev), pf])
               if intercept else pf)
        pen_mask = pen_mask * pfq
    bounds = None
    if limits is not None:
        # Original-scale box -> standardized scale: coef_orig =
        # slopes_std / sd_x (recover_glm), so the box maps by sd_x;
        # the intercept coordinate stays unconstrained (glmnet).
        lo, up = limits[0] * sd_x, limits[1] * sd_x
        if intercept:
            inf = torch.full((1,), float("inf"), dtype=dtype, device=dev)
            lo = torch.cat([-inf, lo])
            up = torch.cat([inf, up])
        bounds = (lo, up)

    if user_lams is None:
        # glmnet lambda_max rule: the (weighted) null model's score
        # against X.  With an offset the null intercept solves the
        # offset-shifted score (generic bisection; glmnet's offset
        # semantics).
        if offset is not None:
            r0 = _null_resid_with_offset(fam, y, offset, intercept, w)
        else:
            r0 = fam.null_resid(y, intercept, w)
            if w is not None:
                r0 = w * r0
        scores = torch.abs(dot(Xs.mT, r0)) / n
        if pf is not None:
            # Factor-aware KKT boundary over PENALIZED coordinates
            # (glmnet's rule; zero-factor coordinates never gate the
            # grid top: they are always in the model).
            scores = torch.where(pf > 0,
                                 scores / torch.clamp(pf, min=1e-12),
                                 torch.zeros_like(scores))
        lam0 = torch.max(scores) / max(alpha, 1e-3)
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams

    if hessian == "auto":
        # Bounded curvature -> the one-time-factorized fixed majorizer;
        # unbounded (poisson) -> the per-lambda adaptive majorizer with
        # the curvature-ratio damping safeguard (_glm_ops).
        hessian = ("fixed" if fam.curvature_bound is not None
                   else "adaptive")
    if hessian == "fixed" and fam.curvature_bound is None:
        raise ValueError(
            f"family {fam.name!r} has unbounded curvature; "
            "hessian='fixed' is not available")
    if hessian == "adaptive":
        # The per-lambda refresh anchors on the warm-start iterate;
        # batch lanes hold different iterates, so adaptive is scan-only.
        path_mode = "scan"
    if path_mode == "auto":
        # The reference's choice: with the fixed majorizer the batched
        # lanes share one (q, q) matrix; with exact per-lane Hessians the
        # warm-started scan.
        path_mode = "batch" if hessian == "fixed" else "scan"

    # The kernel route: the whole fixed-majorizer batched path in ONE
    # launch (admm_tpu_torch/kernels/glm.py).  Same math as the engine
    # branch below; the kernel carries scalar lane penalties, so weights,
    # offset, penalty factors and bounds take the engine.
    if (path_mode == "batch" and hessian == "fixed" and w is None
            and offset is None and pf is None and bounds is None
            and fam.name in glm_kernel.FAMILIES
            and _use_kernel_glm(n, q, dtype, Xa)):
        rho_v = _glm_auto_rho(fam, rho)
        Minv = _glm_fixed_minv(Xa, fam, rho_v)
        coefs_a, niter = glm_kernel.glm_batch_path(
            Xa.contiguous(), Minv.contiguous(), y.contiguous(),
            pen_mask.contiguous(), lams.contiguous(), rho_v, eps_abs,
            eps_rel, alpha, maxit, family=fam.name, huber_m=fam.param,
            newton_steps=newton_steps)
        beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
        return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)

    st0, solve, report, refresh = _glm_engine(
        Xa, y, fam, lams[0], rho, pen_mask, alpha, newton_steps,
        obs_w=w, hessian=hessian, offset=offset, bounds=bounds)
    if path_mode == "batch":
        st = _batched_cold_states(lams.shape[0], q, st0.rho, lams)
        st = make_batched_solver(solve)(st, maxit, eps_abs, eps_rel)
        coefs_a, niter, traces = st.z, st.it, None
    else:
        _, coefs_a, niter, traces = _scan_path(
            st0, solve, report, lams, maxit, eps_abs, eps_rel, trace_len,
            refresh=refresh)

    beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def glm_lasso_path(X, y, family, *, lambdas=None, nlambda: int = 50,
                   lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
                   standardize: bool = True, intercept: bool = True,
                   maxit: int = 10000, eps_abs: float = 1e-5,
                   eps_rel: float = 1e-5, rho: float = -1.0,
                   path_mode: str = "auto",
                   trace_len: Optional[int] = None,
                   newton_steps: int = _NEWTON_STEPS, weights=None,
                   offset=None, penalty_factor=None, lower_limits=None,
                   upper_limits=None, exclude=None, hessian: str = "auto",
                   data_mesh=None, dfmax: Optional[int] = None,
                   pmax: Optional[int] = None, dtype=torch.float32,
                   device="cuda") -> PathResult:
    """Solve a penalized smooth-loss path for any :class:`GLMFamily`.

    Same arguments and defaults as ``admm_tpu.glm_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else (numpy
    arrays, lists) goes to ``device``.

    ``family`` is a GLMFamily instance (:func:`binomial`, :func:`huber`,
    :func:`poisson`, ...) or a zero-argument factory.
    ``weights`` (glmnet's ``weights`` for every family): observation
    weights, normalized to sum to n; the loss, the standardization moments
    and the lambda grid all become weighted (an integer weight of k is
    exactly equivalent to repeating the row k times).  ``offset``
    (glmnet's ``offset``): a fixed (n,) term added to the linear predictor,
    ``eta = b0 + X b + offset``, for exposure/rate models (e.g. poisson
    with ``offset = log(exposure)``); the auto grid's null intercept
    solves the offset-shifted score.
    ``penalty_factor`` / ``lower_limits`` / ``upper_limits`` / ``exclude``
    (glmnet's per-coefficient arguments): factors rescale each
    coordinate's penalty (threshold ``lambda * pf_j``, factor-aware grid
    top); limits clip the prox to an original-scale box containing 0
    (nonnegative logistic via ``lower_limits=0``); ``exclude`` forces
    variables out (the lower = upper = 0 box).  All of these take the
    engine (the kernel carries scalar lane penalties).
    ``hessian``: "fixed" uses the one-time-factorized curvature majorizer
    in the x-update (bounded-curvature families: binomial, huber, probit),
    "adaptive" refreshes a local majorizer once per lambda at the warm
    start with a pointwise curvature-ratio damping safeguard (unbounded
    families, e.g. poisson; scan only), "exact" rebuilds the (q, q) Newton
    Hessian every inner step, "auto" (default) picks "fixed" when the
    family has a curvature bound and "adaptive" otherwise: same solutions
    to solver tolerance.  ``path_mode``: "scan" warm-starts the lambdas
    in sequence, "batch" solves them all at once as lanes, "auto"
    (default) is "batch" under "fixed" and "scan" otherwise.
    ``dfmax``/``pmax`` shorten the returned path as glmnet does.
    ``dtype``: ``torch.float32`` (default, also for None) runs the batched
    fixed-majorizer path of binomial and huber through the CUDA kernel;
    ``torch.float64`` takes the engine.

    ``trace_len`` records each lambda's per-iteration residual trace and
    forces ``path_mode="scan"`` (the engine, never the kernel).
    ``data_mesh`` shards X's rows over a mesh: the moments, the
    majorizer's Gram and each Newton step's gradient and Hessian are sums
    over the mesh, ``X b`` is computed per block and gathered; the GLM
    kernel holds all of X, so the engine runs.
    """
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    if dtype is None:
        dtype = torch.float32
    X = _as_data(X, dtype, device, data_mesh)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1] for GLM paths")
    if hessian not in ("auto", "fixed", "exact", "adaptive"):
        raise ValueError(
            "hessian must be 'auto', 'fixed', 'exact' or 'adaptive'")
    if path_mode not in ("auto", "scan", "batch"):
        raise ValueError("path_mode must be 'auto', 'scan' or 'batch'")
    dev = X.device
    lams = None
    if lambdas is not None:
        lams = torch.sort(_as_tensor(lambdas, dtype, dev).reshape(-1),
                          descending=True).values
    w = None if weights is None else _as_tensor(weights, dtype, dev)
    off = (None if offset is None
           else _as_tensor(offset, dtype, dev).reshape(-1))
    if off is not None and off.shape != (X.shape[0],):
        raise ValueError("offset must have one entry per row")
    pf, limits = validate_pf_limits(penalty_factor, exclude, lower_limits,
                                    upper_limits, X.shape[1], dtype, dev)
    res = _glm_path(X, y, int(nlambda), lambda_min_ratio, lams, rho, maxit,
                    eps_abs, eps_rel, alpha, w, off, pf, limits,
                    family=family, standardize_x=standardize,
                    intercept=intercept, path_mode=path_mode,
                    trace_len=trace_len, newton_steps=int(newton_steps),
                    hessian=hessian)
    if dfmax is not None or pmax is not None:
        res = _truncate_path(res, dfmax, pmax)
    return res


def huber_lasso_path(X, y, *, M: float = 1.345, **kw) -> PathResult:
    """Robust (Huber-loss) Lasso/Enet path: the smooth bridge between
    the gaussian Lasso and LAD."""
    return glm_lasso_path(X, y, huber(float(M)), **kw)


def poisson_lasso_path(X, y, **kw) -> PathResult:
    """Sparse log-linear Poisson regression path (y = counts >= 0).

    ``newton_steps`` defaults to 1 here (vs the generic 2), the
    reference's choice for this family."""
    kw.setdefault("newton_steps", 1)
    return glm_lasso_path(X, y, poisson(), **kw)
