"""SLOPE, Sorted L-One Penalized Estimation (counterpart of
``admm_tpu/models/slope.py``; an extension beyond the reference)::

    minimize  1/(2n) ||y - X b||^2 + t * sum_i lam_i |b|_(i)

with ``lam_1 >= ... >= lam_p >= 0`` applied to the decreasingly sorted
magnitudes (Bogdan et al. 2015).  The solver is the Lasso's tall/wide
engine pair with one swap: the z-prox becomes the sorted-l1 prox, a soft
threshold by the sorted sequence followed by an isotonic projection onto
the nonincreasing cone.  Two projections, as in the JAX package:

* :func:`isotonic_nonincreasing`: the closed-form minimax formula as two
  (p, p) masked cumulative reductions (``torch.cummin``/``torch.cummax``
  where the JAX package has ``lax.cummin``/``lax.cummax``), O(p^2) memory;
* :func:`isotonic_nonincreasing_pava`: parallel pool-adjacent-violators,
  O(p) memory per pass, its ``lax.while_loop`` over passes a host loop
  that reads whether any violation is left once per pass.

The path runs over the scale t of the sequence; the grid tops at the exact
null threshold (the dual sorted-l1 norm of X'y/n).  No kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.engine import (col, make_admm_solver, make_batched_solver,
                           make_fadmm_solver, make_state)
from ..data.standardize import recover, standardize
from ..interop import to_numpy
from .lasso import (PathResult, _as_tensor, _batched_cold_states, _linspace,
                    _scan_path, _tall_ops, _tall_setup, _wide_ops,
                    _wide_setup)


def isotonic_nonincreasing(z):
    """Euclidean projection of ``z`` (over its last axis) onto the
    nonincreasing cone, by the minimax formula on the reversed problem:
    ``w_i = max_{j<=i} min_{k>=i} mean(x_j..x_k)``; dense (p, p)
    cumulative reductions per lane, no data-dependent control flow."""
    x = torch.flip(z, dims=(-1,))
    p = x.shape[-1]
    dtype, dev = x.dtype, x.device
    C = torch.cat([torch.zeros(x.shape[:-1] + (1,), dtype=dtype, device=dev),
                   torch.cumsum(x, dim=-1)], dim=-1)
    j = torch.arange(p, device=dev)[:, None]
    k = torch.arange(p, device=dev)[None, :]
    avg = ((C[..., 1:][..., None, :] - C[..., :-1][..., :, None])
           / (k - j + 1).to(dtype))                  # mean of x_j..x_k
    big = torch.finfo(dtype).max
    # inner_min[j, i] = min_{k >= i} avg(j, k)   (valid for j <= i)
    masked = torch.where(k >= j, avg, torch.full_like(avg, big))
    inner_min = torch.flip(torch.cummin(torch.flip(masked, dims=(-1,)),
                                        dim=-1).values, dims=(-1,))
    # w_i = max_{j <= i} inner_min[j, i]
    w = torch.cummax(torch.where(j <= k, inner_min,
                                 torch.full_like(inner_min, -big)),
                     dim=-2).values
    return torch.flip(torch.diagonal(w, dim1=-2, dim2=-1), dims=(-1,))


def isotonic_nonincreasing_pava(z):
    """Euclidean projection onto the nonincreasing cone (over the last
    axis) by PARALLEL pool-adjacent-violators: each pass merges every
    chain of order-violating adjacent blocks at once (a merge moves the
    pooled mean strictly between the two, so the other violations in the
    chain survive, and PAVA is merge-order independent).  Block bounds and
    means come from cumulative max/min and a prefix-sum table; the passes
    run until no lane has a violation (near-sorted prox inputs take 1-5)."""
    p = z.shape[-1]
    dev = z.device
    idx = torch.arange(p, device=dev)
    C = torch.cat([torch.zeros(z.shape[:-1] + (1,), dtype=z.dtype,
                               device=dev), torch.cumsum(z, dim=-1)], dim=-1)
    last = torch.full(z.shape[:-1] + (1,), p, dtype=idx.dtype, device=dev)

    def compute(head):
        # Block start: the latest head <= i (head[0] is always set); block
        # end: (the first head > i) - 1.
        bstart = torch.cummax(torch.where(head, idx, 0), dim=-1).values
        nxthead = torch.flip(torch.cummin(torch.flip(
            torch.where(head, idx, p), dims=(-1,)), dim=-1).values,
            dims=(-1,))
        bend = torch.cat([nxthead[..., 1:], last], dim=-1) - 1
        mean = ((torch.gather(C, -1, bend + 1) - torch.gather(C, -1, bstart))
                / (bend - bstart + 1).to(z.dtype))
        shifted = torch.cat([mean[..., :1], mean[..., :-1]], dim=-1)
        viol = head & (shifted < mean) & (idx > 0)
        return mean, viol

    head = torch.ones(z.shape, dtype=torch.bool, device=dev)
    mean, viol = compute(head)
    while bool(torch.any(viol)):
        head = head & ~viol
        mean, viol = compute(head)
    return mean


# Dense-minimax / parallel-PAVA crossover.  The JAX package measured 3072
# on the TPU (DESIGN.md "SLOPE isotonic crossover"); kept here until it is
# re-measured on the H100 (ROADMAP.md).
_ISOTONIC_DENSE_MAX_P = 3072


def prox_sorted_l1(v, lam_sorted, method: str = "auto"):
    """Prox of the sorted-l1 norm ``sum_i lam_i |v|_(i)`` over the last
    axis (Bogdan et al. Alg. 4): sort |v| decreasing, subtract the sorted
    penalties, project onto the nonincreasing nonnegative cone, undo the
    sort and the signs.  The sort is stable, so ties keep the JAX
    package's ``argsort(-a)`` order.  ``method``: 'dense', 'pava' or 'auto'
    (dense up to ``_ISOTONIC_DENSE_MAX_P``)."""
    a = torch.abs(v)
    order = torch.argsort(-a, dim=-1, stable=True)
    u = torch.gather(a, -1, order)
    if method == "auto":
        method = "dense" if v.shape[-1] <= _ISOTONIC_DENSE_MAX_P else "pava"
    iso = (isotonic_nonincreasing if method == "dense"
           else isotonic_nonincreasing_pava)
    w = torch.clamp(iso(u - lam_sorted), min=0.0)
    out = torch.zeros_like(v).scatter(-1, order, w)
    return torch.sign(v) * out


def _slope_tall_ops(Minv, Xty, lam_seq, p):
    def next_z(st, x_new):
        v = x_new + st.adj_y / col(st.rho)
        return prox_sorted_l1(v, col(st.lam / st.rho) * lam_seq), None

    return _tall_ops(Minv, Xty, 1.0, p)._replace(next_z=next_z,
                                                  graph_safe=False)


def _slope_wide_ops(Xs, ys, sprad, t0, lam_seq, n, p):
    def next_x(st):
        tmp = st.aux + st.z + st.y / col(st.rho)
        v = st.x - (tmp @ Xs) / sprad
        x_new = prox_sorted_l1(v, col(st.lam / (st.rho * sprad)) * lam_seq)
        return torch.where(col(st.lam > t0 * (1.0 - 1e-5)),
                           torch.zeros_like(x_new), x_new)

    return _wide_ops(Xs, ys, sprad, t0, 1.0, n, p)._replace(
        next_x=next_x, graph_safe=False)


def _slope_t0(Xs, ys, lam_seq):
    """Exact null threshold: b = 0 is optimal iff the dual sorted-l1 norm
    of X'y is <= t, i.e. ``t0 = max_k cumsum(sorted |X'y|)_k /
    cumsum(lam)_k`` (Bogdan et al. sec. 2.2)."""
    g = torch.sort(torch.abs(ys @ Xs), descending=True).values
    return torch.max(torch.cumsum(g, dim=0) / torch.cumsum(lam_seq, dim=0))


def _slope_engine(Xs, ys, lam_seq, t_first, rho0):
    """(cold state, solver, reported iterate): the tall engine reports the
    prox iterate z (exact zeros), the wide one x, as the Lasso's do."""
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    zp = torch.zeros((p,), dtype=dtype, device=dev)
    if n > p:
        Minv, Xty, rho = _tall_setup(Xs, ys, t_first * lam_seq[0], rho0)
        solve = make_fadmm_solver(_slope_tall_ops(Minv, Xty, lam_seq, p),
                                  adapt_rho=False)
        return (make_state(zp, zp, zp, rho, t_first), solve,
                (lambda st: st.z))
    _, sprad, rho = _wide_setup(Xs, ys, t_first * lam_seq[0], rho0, 1.0,
                                False)
    ops = _slope_wide_ops(Xs, ys, sprad, _slope_t0(Xs, ys, lam_seq), lam_seq,
                          n, p)
    solve = make_admm_solver(ops, adapt_rho=True)
    zn = torch.zeros((n,), dtype=dtype, device=dev)
    return (make_state(zp, zn, zn, rho, t_first, aux=zn), solve,
            (lambda st: st.x))


def bh_sequence(p: int, q: float = 0.1) -> np.ndarray:
    """The Benjamini-Hochberg penalty sequence ``lam_i = Phi^{-1}(1 - q i
    / (2 p))`` (Bogdan et al. eq. 1.7), on the host."""
    from scipy.stats import norm

    i = np.arange(1, p + 1)
    return norm.ppf(1.0 - q * i / (2.0 * p))


def _slope_path_dev(X, y, lam_seq, nlambda, lambda_min_ratio, user_ts, rho0,
                    maxit, eps_abs, eps_rel, weights=None, *, standardize_x,
                    intercept, path_mode, trace_len=None):
    n, p = X.shape
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    if user_ts is None:
        # Internal scale ilam = t n / scale_y (reference:
        # src/Lasso.cpp:99); the 1e-4 nudge puts the top strictly above
        # the null threshold, where the dual constraint is tight.
        t0 = _slope_t0(Xs, ys, lam_seq) / n * stats.scale_y * (1.0 + 1e-4)
        ts = torch.exp(_linspace(torch.log(t0),
                                 torch.log(lambda_min_ratio * t0), nlambda))
    else:
        ts = user_ts
    its = ts * n / stats.scale_y
    traces = None
    if path_mode == "batch":
        k = its.shape[0]
        if n > p:
            Minv, Xty, rho = _tall_setup(Xs, ys, its[0] * lam_seq[0], rho0)
            solve = make_batched_solver(make_fadmm_solver(
                _slope_tall_ops(Minv, Xty, lam_seq, p), adapt_rho=False))
            st = _batched_cold_states(k, p, rho, its)
        else:
            _, sprad, rho = _wide_setup(Xs, ys, its[0] * lam_seq[0], rho0,
                                        1.0, False)
            ops = _slope_wide_ops(Xs, ys, sprad, _slope_t0(Xs, ys, lam_seq),
                                  lam_seq, n, p)
            solve = make_batched_solver(make_admm_solver(ops, adapt_rho=True))
            st = _batched_cold_states(k, p, rho, its, aux_dim=n)
            zn = torch.zeros((k, n), dtype=Xs.dtype, device=Xs.device)
            st = st._replace(z=zn, y=zn, adj_z=zn, adj_y=zn)
        st = solve(st, maxit, eps_abs, eps_rel)
        coefs, niter = (st.z if n > p else st.x), st.it
    else:
        st0, solve, report = _slope_engine(Xs, ys, lam_seq, its[0], rho0)
        _, coefs, niter, traces = _scan_path(st0, solve, report, its, maxit,
                                             eps_abs, eps_rel, trace_len)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=ts, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def _check_lam_seq(lam_seq, q, p):
    """The (p,) sequence, BH at level q by default, validated as the JAX
    package validates it."""
    if lam_seq is None:
        lam_seq = bh_sequence(p, q)
    lam_np = np.asarray(to_numpy(lam_seq), np.float64).ravel()
    if lam_np.shape != (p,):
        raise ValueError("lam_seq must have one entry per column of x")
    if np.any(np.diff(lam_np) > 1e-12) or lam_np[-1] < 0:
        raise ValueError("lam_seq must be nonincreasing and >= 0")
    if not lam_np[0] > 0:
        raise ValueError("lam_seq must have a positive largest entry")
    return lam_np


def slope_path(X, y, *, lam_seq=None, q: float = 0.1, lambdas=None,
               nlambda: int = 30, lambda_min_ratio: float = 1e-2,
               standardize: bool = True, intercept: bool = True,
               weights=None, maxit: int = 10000, eps_abs: float = 1e-5,
               eps_rel: float = 1e-5, rho: float = -1.0,
               path_mode: str = "auto", trace_len: Optional[int] = None,
               dtype=torch.float32, device="cuda") -> PathResult:
    """Solve the SLOPE path.

    Same arguments and defaults as ``admm_tpu.slope_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device``.  ``lam_seq`` is the nonincreasing (p,) sequence (default:
    Benjamini-Hochberg at FDR level ``q``); ``lambdas`` are the scale
    values t.  ``path_mode="auto"`` takes "batch" below p = 100 and "scan"
    from there (the JAX package's crossover, measured on the TPU and kept
    until it is re-measured on the H100)."""
    X = _as_tensor(X, dtype, device)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    n, p = X.shape
    lam_np = _check_lam_seq(lam_seq, q, p)
    if path_mode not in ("auto", "batch", "scan"):
        raise ValueError("path_mode must be 'auto', 'batch' or 'scan'")
    if path_mode == "auto":
        path_mode = "batch" if p < 100 else "scan"
    if trace_len is not None:
        path_mode, trace_len = "scan", int(trace_len)
    ts = (None if lambdas is None
          else torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                          descending=True).values)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    return _slope_path_dev(X, y, torch.as_tensor(lam_np, dtype=dtype,
                                                 device=X.device),
                           int(nlambda), lambda_min_ratio, ts, rho, maxit,
                           eps_abs, eps_rel, w, standardize_x=standardize,
                           intercept=intercept, path_mode=path_mode,
                           trace_len=trace_len)
