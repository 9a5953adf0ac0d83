"""Group Lasso lambda-path solver (counterpart of
``admm_tpu/models/grouplasso.py``; an extension beyond the reference).

Model (Yuan & Lin 2006, glmnet/grpreg conventions)::

    minimize  1/(2n) ||y - X beta||^2 + lambda * sum_g w_g ||beta_g||_2

with feature groups g and weights ``w_g`` defaulting to sqrt(|g|).  It is
a prox swap on the Lasso's engines:

* tall (n > p): FADMM with the cached ridge inverse (as reference:
  src/ADMMLassoTall.h) and the block soft-threshold z-update
  ``z_g = max(0, 1 - t_g/||v_g||) v_g`` with ``t_g = lambda w_g / rho``;
* wide (p >= n): linearized ADMM (as reference: src/ADMMLassoWide.h) with
  the same block prox at step ``lambda w_g/(rho gamma)``.

The all-zero threshold is ``lambda0 = max_g ||X_g'y||_2 / w_g``.  The JAX
package's ``segment_sum`` over the group ids becomes a product with the
(p, G) 0/1 membership matrix (``index_add_`` adds with atomics on the
card, in an order that changes from run to run; a product adds in one
order, so a path has the same bits every run, and a resumed checkpoint
those of its uninterrupted run), and ``segment_max`` a ``scatter_reduce``.
No kernel: the group prox is not the kernels' scalar-lane prox, so every
path runs on the engines, warm-started in sequence as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import col, make_admm_solver, make_fadmm_solver, make_state
from ..core.prox import soft_threshold
from ..data.standardize import recover, standardize
from ..linalg import spectral_radius_gram
from .lasso import (PathResult, _as_tensor, _linspace, _not_ported,
                    _scan_path, _tall_ops, _tall_setup, _wide_ops)


def _membership(groups, G: int, dtype):
    """The (p, G) 0/1 matrix of which group each coordinate is in."""
    return (groups[:, None] == torch.arange(G, device=groups.device)).to(
        dtype)


def _segment_sum(v, member):
    """Per-group sums over the last axis, ``(..., p) -> (..., G)``, as a
    product with the membership matrix (module docstring)."""
    return v @ member


def _group_prox_fn(groups, weights, l1_ratio: float = 0.0):
    """Block soft-threshold: ``prox(v, t)`` applies threshold ``t * w_g`` to
    group g (``t`` a scalar or a per-lane column).

    ``l1_ratio > 0`` gives the SPARSE-GROUP LASSO prox (Simon et al. 2013):
    the compound penalty ``t [l1_ratio ||.||_1 + (1 - l1_ratio) sum_g w_g
    ||.||_2]`` has the exact prox "coordinate soft-threshold, THEN group
    shrink" (the l1 prox keeps each group's direction).
    """
    member = _membership(groups, int(weights.shape[0]), weights.dtype)

    def prox(v, t):
        if l1_ratio > 0.0:
            v = soft_threshold(v, t * l1_ratio)
        t_g = t * (1.0 - l1_ratio)
        gn = torch.sqrt(torch.clamp(_segment_sum(v * v, member), min=1e-30))
        shrink = torch.clamp(1.0 - t_g * weights / gn, min=0.0)  # (..., G)
        return v * shrink[..., groups]

    return prox


def normalize_groups(groups, p, weights, dtype, device="cuda"):
    """Validate and relabel group ids to 0..G-1 and resolve the weights:
    ``(groups (p,) int64, weights (G,))`` on ``device``.

    Weights default to sqrt(group size) (Yuan & Lin); a zero weight means
    "unpenalized"; negative weights are refused."""
    groups_np = np.asarray(groups.detach().cpu() if isinstance(
        groups, torch.Tensor) else groups)
    if groups_np.shape != (p,):
        raise ValueError("groups must have one entry per column of x")
    uniq = np.unique(groups_np)
    if not np.array_equal(uniq, np.arange(uniq.size)):
        groups_np = np.searchsorted(uniq, groups_np)  # relabel to 0..G-1
    groups_np = groups_np.astype(np.int64)
    G = int(groups_np.max()) + 1
    if weights is None:
        sizes = np.bincount(groups_np, minlength=G)
        weights = np.sqrt(sizes.astype(np.float64))
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    weights_np = np.asarray(weights, np.float64)
    if weights_np.shape != (G,):
        raise ValueError(f"weights must have one entry per group ({G})")
    if np.any(weights_np < 0):
        raise ValueError("group weights must be nonnegative")
    return (torch.as_tensor(groups_np, device=device),
            torch.as_tensor(weights_np, dtype=dtype, device=device))


class _GroupProblem(NamedTuple):
    groups: torch.Tensor   # (p,) int64
    weights: torch.Tensor  # (G,)
    l1_ratio: float = 0.0  # sparse-group mix (0 = pure group lasso)


def _gl_lambda0(Xs, ys, groups, weights, l1_ratio: float = 0.0):
    """KKT boundary for beta = 0: the max over PENALIZED groups of
    ``||X_g'y||_2 / w_g`` (zero-weight groups never gate the grid).

    With ``l1_ratio > 0`` the grid top is the per-group minimum of two
    sufficient thresholds, the pure-group ``||c_g|| / ((1-a) w_g)`` and the
    pure-l1 ``||c_g||_inf / a``: a valid, possibly loose, upper bound that
    is exact at a = 0 and a = 1."""
    G = int(weights.shape[0])
    Xty = Xs.mT @ ys
    gn = torch.sqrt(_segment_sum(Xty * Xty, _membership(groups, G,
                                                         Xty.dtype)))
    zeros = torch.zeros_like(gn)
    if l1_ratio <= 0.0:
        return torch.max(torch.where(
            weights > 0, gn / torch.clamp(weights, min=1e-30), zeros))
    ginf = zeros.scatter_reduce(0, groups, torch.abs(Xty), reduce="amax",
                                include_self=False)
    bound_l1 = ginf / l1_ratio
    bound_grp = torch.where(
        (weights > 0) & (l1_ratio < 1.0),
        gn / torch.clamp((1.0 - l1_ratio) * weights, min=1e-30),
        torch.full_like(gn, float("inf")))
    return torch.max(torch.minimum(bound_grp, bound_l1))


def _gl_tall_engine(Xs, ys, lam_first, rho0, gp):
    """(cold state, solver, reported iterate) of the tall group Lasso: the
    Lasso's tall engine with the z-update's prox swapped."""
    p = Xs.shape[1]
    Minv, Xty, rho = _tall_setup(Xs, ys, lam_first, rho0)
    prox = _group_prox_fn(gp.groups, gp.weights, gp.l1_ratio)

    def next_z(st, x_new):
        v = x_new + st.adj_y / col(st.rho)
        return prox(v, col(st.lam / st.rho)), st.aux

    ops = _tall_ops(Minv, Xty, 1.0, p)._replace(next_z=next_z)
    solve = make_fadmm_solver(ops, adapt_rho=False)
    zeros = torch.zeros((p,), dtype=Xs.dtype, device=Xs.device)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first)
    return st0, solve, (lambda st: st.z)


def _gl_wide_engine(Xs, ys, lam_first, rho0, gp):
    """(cold state, solver, reported iterate) of the wide group Lasso: the
    linearized x-update with the block prox, adaptive rho."""
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    sprad = spectral_radius_gram(Xs)
    # Auto-rho (as reference: src/ADMMLassoWide.h:227-228).
    rho = (torch.tensor(rho0, dtype=dtype, device=dev) if rho0 > 0
           else (lam_first / sprad).pow(1.0 / 3.0))
    lambda0 = _gl_lambda0(Xs, ys, gp.groups, gp.weights, gp.l1_ratio)
    prox = _group_prox_fn(gp.groups, gp.weights, gp.l1_ratio)

    def next_x(st):
        tmp = st.aux + st.z + st.y / col(st.rho)
        v = st.x - (tmp @ Xs) / sprad
        x_new = prox(v, col(st.lam / (st.rho * sprad)))
        return torch.where(col(st.lam > lambda0 * (1.0 - 1e-5)),
                           torch.zeros_like(x_new), x_new)

    ops = _wide_ops(Xs, ys, sprad, lambda0, 1.0, n, p)._replace(
        next_x=next_x)
    solve = make_admm_solver(ops, adapt_rho=True)
    zn = torch.zeros((n,), dtype=dtype, device=dev)
    st0 = make_state(torch.zeros((p,), dtype=dtype, device=dev), zn, zn, rho,
                     lam_first, aux=zn)
    return st0, solve, (lambda st: st.x)


def _gl_path(X, y, groups, weights, nlambda, lambda_min_ratio, user_lams,
             rho, maxit, eps_abs, eps_rel, obs_weights=None, *,
             standardize_x, intercept, trace_len=None, l1_ratio=0.0):
    n, p = X.shape
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=obs_weights)
    gp = _GroupProblem(groups=groups, weights=weights, l1_ratio=l1_ratio)
    if user_lams is None:
        lam0 = _gl_lambda0(Xs, ys, groups, weights, l1_ratio)
        lmax = lam0 / n * stats.scale_y
        lams = torch.exp(_linspace(torch.log(lmax),
                                   torch.log(lambda_min_ratio * lmax),
                                   nlambda))
    else:
        lams = user_lams
    ilams = lams * n / stats.scale_y
    engine = _gl_tall_engine if n > p else _gl_wide_engine
    st0, solve, report = engine(Xs, ys, ilams[0], rho, gp)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def group_lasso_path(X, y, groups, *, weights=None, lambdas=None,
                     nlambda: int = 100,
                     lambda_min_ratio: Optional[float] = None,
                     standardize: bool = True, intercept: bool = True,
                     maxit: int = 10000, eps_abs: float = 1e-5,
                     eps_rel: float = 1e-5, rho: float = -1.0,
                     trace_len: Optional[int] = None, obs_weights=None,
                     l1_ratio: float = 0.0, data_mesh=None,
                     dtype=torch.float32, device="cuda") -> PathResult:
    """Solve the group-Lasso lambda path.

    Same arguments and defaults as ``admm_tpu.group_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  ``groups`` is a length-p array of group ids (any labels);
    ``weights`` (one per group) default to sqrt(group size).
    ``l1_ratio`` mixes in a coordinate l1 term (the sparse-group lasso:
    0 is the pure group lasso, 1 the Lasso).  ``obs_weights`` are glmnet's
    observation weights.  ``trace_len`` records each lambda's residual
    trace.  ``data_mesh`` is not ported yet and raises
    ``NotImplementedError``.
    """
    _not_ported(data_mesh=data_mesh)
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    n, p = X.shape
    groups_t, gweights = normalize_groups(groups, p, weights, dtype,
                                          X.device)
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                            descending=True).values)
    if not 0.0 <= l1_ratio <= 1.0:
        raise ValueError("l1_ratio must be in [0, 1]")
    ow = (None if obs_weights is None
          else _as_tensor(obs_weights, dtype, X.device).reshape(-1))
    return _gl_path(X, y, groups_t, gweights, int(nlambda), lambda_min_ratio,
                    lams, rho, maxit, eps_abs, eps_rel, ow,
                    standardize_x=standardize, intercept=intercept,
                    trace_len=None if trace_len is None else int(trace_len),
                    l1_ratio=float(l1_ratio))
