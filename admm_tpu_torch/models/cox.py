"""L1/elastic-net Cox proportional-hazards paths, glmnet's ``family =
"cox"`` (counterpart of ``admm_tpu/models/cox.py``; an extension beyond
the reference)::

    minimize  1/n [ - sum_{i: d_i = 1} (eta_i - log sum_{j in R_i} e^{eta_j}) ]
              + lambda (alpha ||b||_1 + (1 - alpha)/2 ||b||_2^2),
    eta = X b,   R_i = { j : t_j >= t_i }  (the risk set; Breslow ties)

No intercept: the baseline hazard absorbs it, as in glmnet.

Rows are sorted by time DESCENDING once on the host (numpy, as the JAX
package), after which every risk-set quantity is a cumulative sum on the
device: ``S_i = sum_{t_j >= t_i} e^{eta_j}`` a prefix sum read at each tie
group's end, the gradient's event sum a suffix sum of ``d_k / S_k`` read
at each tie group's start (:func:`_cox_risk_terms`); strata make the sums
segmented, start-stop data subtract a second prefix sum over the rows not
yet entered.  The Hessian in eta is bounded by the softmax curvature, so
the x-update is a few majorized Newton steps against a (p, p) inverse:
refreshed per lambda from the warm start in scan mode (the default), the
global ``(d / 2n) X'X`` bound shared by every lane in batch mode.

In float32 the card's scans add in another order than XLA's on the CPU;
``S`` is floored at the row's own term, as in the JAX package, so the
start-stop difference of two large sums cannot go to zero.  No kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, col, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..data.standardize import _guard
from ..linalg import ridge_inverse
from ..parallel.mesh import all_sum
from .lasso import (_as_tensor, _batched_cold_states, _linspace,
                    _scan_path, validate_pf_limits)


class CoxPathResult(NamedTuple):
    """Cox path result (original data scale; no intercept)."""
    lambdas: torch.Tensor  # (nlambda,)
    coef: torch.Tensor     # (nlambda, p)
    niter: torch.Tensor    # (nlambda,) int32


# ---------------------------------------------------------------------------
# Host preparation (numpy): the sort and the static index arrays
# ---------------------------------------------------------------------------

def _tie_groups(times_sorted_desc: np.ndarray, strata_sorted=None):
    """For each sorted position i, the FIRST and LAST positions of its tie
    group (equal times, and with strata the same stratum: ties never merge
    across a stratum boundary).  Risk-set membership ``t_j >= t_i`` is
    ``pos(j) <= last[i]`` in descending order (within the stratum
    block)."""
    n = times_sorted_desc.shape[0]
    first = np.zeros(n, np.int64)
    last = np.zeros(n, np.int64)
    i = 0
    while i < n:
        j = i
        while (j + 1 < n
               and times_sorted_desc[j + 1] == times_sorted_desc[i]
               and (strata_sorted is None
                    or strata_sorted[j + 1] == strata_sorted[i])):
            j += 1
        first[i:j + 1] = i
        last[i:j + 1] = j
        i = j + 1
    return first, last


def _strata_prep(t_np, strata):
    """The stratified sort (glmnet's ``stratifySurv``): ``(order,
    codes_sorted, seg_first, seg_last)`` with rows STRATUM-MAJOR and time
    DESCENDING within each stratum, and each row's stratum block edges in
    sorted order."""
    s_np = np.asarray(strata).ravel()
    if s_np.shape != t_np.shape:
        raise ValueError("strata must have one entry per row")
    _, codes = np.unique(s_np, return_inverse=True)
    order = np.lexsort((-t_np, codes))
    ss = codes[order]
    n = ss.shape[0]
    seg_first = np.zeros(n, np.int64)
    seg_last = np.zeros(n, np.int64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and ss[j + 1] == ss[i]:
            j += 1
        seg_first[i:j + 1] = i
        seg_last[i:j + 1] = j
        i = j + 1
    return order, ss, seg_first, seg_last


def _startstop_prep(stops_sorted, starts_sorted):
    """The START-STOP index arrays (rows sorted stop-descending):
    ``perm_s`` the start-descending permutation, ``b_idx[i] = #{j: start_j
    >= stop_i}`` (rows not yet entered at t_i) and ``sidx[i]`` the first
    stop-descending position k with ``stop_k <= start_i`` (events at or
    before row i's entry)."""
    n = stops_sorted.shape[0]
    perm_s = np.argsort(-starts_sorted, kind="stable")
    asc = np.sort(starts_sorted)
    b_idx = n - np.searchsorted(asc, stops_sorted, side="left")
    sidx = np.searchsorted(-stops_sorted, -starts_sorted, side="left")
    return (perm_s.astype(np.int64), b_idx.astype(np.int64),
            sidx.astype(np.int64))


def _startstop_prep_strata(stops_sorted, starts_sorted, ss):
    """:func:`_startstop_prep` within each stratum block (rows sorted
    stratum-major, stop-descending; ``ss`` the sorted stratum codes):
    ``perm_s`` stays stratum-major, ``b_idx`` is block-local plus the
    block's offset and ``sidx`` points past the block when no
    within-stratum event is at or before the row's entry."""
    n = stops_sorted.shape[0]
    perm_s = np.empty(n, np.int64)
    b_idx = np.empty(n, np.int64)
    sidx = np.empty(n, np.int64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and ss[j + 1] == ss[i]:
            j += 1
        sl = slice(i, j + 1)
        st_b, sp_b = starts_sorted[sl], stops_sorted[sl]
        perm_s[sl] = i + np.argsort(-st_b, kind="stable")
        asc = np.sort(st_b)
        b_idx[sl] = i + (st_b.size - np.searchsorted(asc, sp_b, side="left"))
        sidx[sl] = i + np.searchsorted(-sp_b, -st_b, side="left")
        i = j + 1
    return perm_s, b_idx, sidx


def _host(a, dtype=np.float64):
    """An array, a tensor on any device or a scalar as a flat numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype).ravel()


def _cox_prep(t_np, strata, st_np, device):
    """The sort and the index arrays of a Cox problem: ``(order, first,
    last, seg, ext)``, the indices as int64 tensors on ``device``."""
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    seg = ext = None
    if strata is None:
        order = np.argsort(-t_np, kind="stable")
        first, last = _tie_groups(t_np[order])
        if st_np is not None:
            ext = _startstop_prep(t_np[order], st_np[order])
    else:
        order, ss, seg_first, seg_last = _strata_prep(t_np, strata)
        first, last = _tie_groups(t_np[order], ss)
        seg = (idx(seg_first), idx(seg_last))
        if st_np is not None:
            ext = _startstop_prep_strata(t_np[order], st_np[order],
                                         np.asarray(ss))
    if ext is not None:
        ext = tuple(idx(a) for a in ext)
    return order, idx(first), idx(last), seg, ext


# ---------------------------------------------------------------------------
# Risk-set terms, the gradient and the majorizer (sorted order, device)
# ---------------------------------------------------------------------------

def _with_zero(a, front=True):
    z = torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    return torch.cat([z, a] if front else [a, z], dim=-1)


def _cox_risk_terms(eta, d, first, last, w=None, seg=None, ext=None):
    """The Breslow risk-set computation behind the gradient and the
    adaptive majorizer: ``(ee, dd, G)`` with ``ee = w e^eta``, ``dd = w
    d`` and ``G_i`` the sum, over the events row i is at risk for, of
    ``dd_k / S_k``; plain, segmented (``seg``, strata) or interval
    (``ext``, start-stop) risk sets.  ``eta`` is ``(..., n)``.

    ``S`` is floored at ``ee`` elementwise: a row with an event is in its
    own risk set, and the floor caps the float32 cancellation of the
    start-stop difference ``A - B``."""
    ee = torch.exp(torch.clamp(eta, max=30.0))
    dd = d
    if w is not None:
        ee = w * ee
        dd = w * d
    cs = torch.cumsum(ee, dim=-1)
    if seg is None:
        S = cs[..., last]                    # risk-set sums, tie-aware
    else:
        cs0 = _with_zero(cs)
        S = cs0[..., last + 1] - cs0[..., seg[0]]
    if ext is not None:
        cs_s0 = _with_zero(torch.cumsum(ee[..., ext[0]], dim=-1))
        B = cs_s0[..., ext[1]]               # rows not yet entered
        if seg is not None:
            # perm_s is stratum-major: subtract the sum at the block start.
            B = B - cs_s0[..., seg[0]]
        S = S - B
    q = torch.where(dd > 0,
                    dd / torch.maximum(S, torch.clamp(ee, min=1e-30)),
                    torch.zeros_like(S))
    rc = torch.flip(torch.cumsum(torch.flip(q, [-1]), dim=-1), [-1])
    rc0 = _with_zero(rc, front=False)
    if ext is not None:
        G = rc0[..., first] - rc0[..., ext[2]]  # events in (start_j, stop_j]
    elif seg is None:
        G = rc[..., first]
    else:
        G = rc0[..., first] - rc0[..., seg[1] + 1]
    return ee, dd, G


def _cox_grad_eta(eta, d, first, last, n, w=None, seg=None, ext=None):
    """The Breslow partial-likelihood gradient in eta (sorted order),
    scaled 1/n: ``(w e^{eta_i} G_i - w_i d_i) / n``.  ``w``: case weights
    (an integer weight k is row repetition); ``seg``: the stratum blocks;
    ``ext``: the start-stop index triple (:func:`_cox_risk_terms`)."""
    ee, dd, G = _cox_risk_terms(eta, d, first, last, w, seg, ext)
    return (ee * G - dd) / n


def _cox_standardize(X, wc, n, standardize_x):
    """The (weighted) centering and 1/n-sd scaling of the Cox design."""
    col_mean = torch.sum(wc[:, None] * X, dim=0) / n
    Xs = X - col_mean[None, :]
    sd_x = torch.ones((X.shape[1],), dtype=X.dtype, device=X.device)
    if standardize_x:
        c = X - col_mean[None, :]
        sd_x = _guard(torch.sqrt(torch.sum(wc[:, None] * c * c, dim=0) / n),
                      col_mean)
        Xs = Xs / sd_x[None, :]
    return Xs, sd_x


def _cox_majorizer_inv(b, Xs, d, first, last, n, rho, w=None, off=None,
                       seg=None, ext=None):
    """The per-lambda ADAPTIVE majorizer: the ridge inverse of the tight
    diagonal bound ``X' diag(e^eta G) X / n`` at the iterate ``b``."""
    eta = Xs @ b
    if off is not None:
        eta = eta + off
    ee, _, G = _cox_risk_terms(eta, d, first, last, w, seg, ext)
    H = (Xs.mT * (ee * G)[None, :]) @ Xs / n
    return ridge_inverse(H, rho)


def _cox_ops(Xs, d, first, last, n, p, alpha, newton_steps, fixed_minv=None,
             pf=None, bounds=None, off=None, w=None, seg=None,
             ext=None) -> ProblemOps:
    """``fixed_minv`` None: the ADAPTIVE majorizer's inverse rides
    ``st.aux``, refreshed once per lambda from the warm start
    (:func:`_cox_path`).  Iterates are ``(p,)`` or ``(k, p)`` lanes."""
    def next_x(st):
        v = st.z - st.y / col(st.rho)
        Minv = fixed_minv if fixed_minv is not None else st.aux
        b = st.x
        for _ in range(newton_steps):
            eta = b @ Xs.mT
            if off is not None:
                eta = eta + off
            g = _cox_grad_eta(eta, d, first, last, n, w, seg, ext)
            grad = g @ Xs + col(st.rho) * (b - v)
            b = b - grad @ Minv.mT
        return b

    def next_z(st, x_new):
        v = x_new + st.y / col(st.rho)
        pen = col(st.lam / st.rho)
        if pf is not None:
            pen = pen * pf
        z = soft_threshold(v, alpha * pen) / (1.0 + pen * (1.0 - alpha))
        if bounds is not None:
            # glmnet's coefficient box: clip-after-shrink is the exact
            # prox of penalty + box (both separable).
            z = torch.clamp(z, bounds[0], bounds[1])
        return z, st.aux

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


def _cox_path(X, d, first, last, nlambda, lambda_min_ratio, user_lams, rho0,
              maxit, eps_abs, eps_rel, alpha, pf=None, limits=None, w=None,
              off=None, seg=None, ext=None, *, standardize_x, path_mode,
              newton_steps):
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    if w is not None:
        w = w * (n / torch.sum(w))   # glmnet: weights sum to n
    wc = torch.ones((n,), dtype=dtype, device=dev) if w is None else w
    d_total = torch.sum(wc * d)
    # Centering is free (the partial likelihood is invariant to column
    # shifts) and conditions the Gram.
    Xs, sd_x = _cox_standardize(X, wc, n, standardize_x)
    bounds = None
    if limits is not None:
        bounds = (limits[0] * sd_x, limits[1] * sd_x)

    # Grid top: the gradient of the null model (eta = offset, or 0).
    eta0 = torch.zeros((n,), dtype=dtype, device=dev) if off is None else off
    g0 = _cox_grad_eta(eta0, d, first, last, n, w, seg, ext)
    if user_lams is None:
        scores = torch.abs(Xs.mT @ g0)
        if pf is not None:
            scores = torch.where(pf > 0, scores / torch.clamp(pf, min=1e-12),
                                 torch.zeros_like(scores))
        lam0 = torch.max(scores) / max(alpha, 1e-3)
        lams = torch.exp(_linspace(torch.log(lam0),
                                   torch.log(lambda_min_ratio * lam0),
                                   nlambda))
    else:
        lams = user_lams
    # Auto-rho = 1/2, the per-event softmax curvature bound.
    rho = torch.tensor(rho0 if rho0 > 0 else 0.5, dtype=dtype, device=dev)

    if path_mode == "batch":
        # The lanes share one GLOBAL-bound factorization.
        Minv = ridge_inverse((d_total / (2.0 * n)) * (Xs.mT @ Xs), rho)
        ops = _cox_ops(Xs, d, first, last, n, p, alpha, newton_steps, Minv,
                       pf, bounds, off, w, seg, ext)
        solve = make_batched_solver(make_admm_solver(ops, adapt_rho=False))
        st = solve(_batched_cold_states(lams.shape[0], p, rho, lams), maxit,
                   eps_abs, eps_rel)
        coefs_s, niter = st.z, st.it
    else:
        # Warm-started scan, the majorizer refreshed at each lambda's warm
        # start (``_scan_path``'s ``refresh``).
        ops = _cox_ops(Xs, d, first, last, n, p, alpha, newton_steps, None,
                       pf, bounds, off, w, seg, ext)
        solve = make_admm_solver(ops, adapt_rho=False)
        zeros = torch.zeros((p,), dtype=dtype, device=dev)
        st0 = make_state(zeros, zeros, zeros, rho, lams[0])

        def refresh(b):
            return _cox_majorizer_inv(b, Xs, d, first, last, n, rho, w, off,
                                      seg, ext)

        _, coefs_s, niter, _ = _scan_path(st0, solve, lambda st: st.z, lams,
                                          maxit, eps_abs, eps_rel,
                                          refresh=refresh)
    return CoxPathResult(lambdas=lams, coef=coefs_s / sd_x[None, :],
                         niter=niter)


def _cox_fold_coefs(X, d, first, last, lams, masks, rho, maxit, eps_abs,
                    eps_rel, alpha, pf=None, limits=None, w=None, off=None,
                    seg=None, ext=None, *, standardize_x, path_mode,
                    newton_steps, mesh=None):
    """The one-pass fold sweep: fold f is the weighted path with weight 0
    on its held-out rows (zero-weight rows drop out of the risk sets and
    the event terms exactly), the folds one after another.  Returns
    (nfolds, L, p) original-scale coefficients.  On a ``mesh``
    (``fold_mesh``) this process solves its own folds
    (``cv._own_folds``) and the zero-filled stacks are summed across the
    positions, an exact assembly."""
    from .cv import _own_folds

    nf = masks.shape[0]
    folds = range(nf) if mesh is None else _own_folds(nf, mesh, X.device)
    out = [None] * nf
    for f in folds:
        mask = masks[f]
        wf = mask if w is None else mask * w
        out[f] = _cox_path(X, d, first, last, 2, 1e-2, lams, rho, maxit,
                           eps_abs, eps_rel, alpha, pf, limits, wf, off,
                           seg, ext, standardize_x=standardize_x,
                           path_mode=path_mode,
                           newton_steps=newton_steps).coef
    if mesh is None:
        return torch.stack(out)
    zero = torch.zeros_like(out[folds[0]])
    return all_sum([torch.stack([zero if c is None else c for c in out])],
                   mesh)


def _check_survival(n, t_np, d_np, start):
    if t_np.shape != (n,) or d_np.shape != (n,):
        raise ValueError("time and event must have one entry per row")
    if not np.all((d_np == 0) | (d_np == 1)):
        raise ValueError("event must be 0/1")
    if d_np.sum() == 0:
        raise ValueError("no events observed — the partial likelihood "
                         "is constant")
    if start is None:
        return None
    st_np = _host(start)
    if st_np.shape != (n,):
        raise ValueError("start must have one entry per row")
    if np.any(st_np >= t_np):
        raise ValueError("start must be < time (the interval "
                         "(start, stop] must be nonempty)")
    return st_np


def cox_lasso_path(X, time, event, *, lambdas=None, nlambda: int = 50,
                   lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
                   standardize: bool = True, maxit: int = 10000,
                   eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                   rho: float = -1.0, path_mode: str = "scan",
                   newton_steps: int = 2, penalty_factor=None,
                   lower_limits=None, upper_limits=None, exclude=None,
                   weights=None, offset=None, strata=None, start=None,
                   dtype=torch.float32, device="cuda") -> CoxPathResult:
    """Solve the L1/elastic-net Cox partial-likelihood path.

    Same arguments and defaults as ``admm_tpu.cox_lasso_path``, plus
    ``device``: tensors stay on their own device, anything else goes to
    ``device`` (``time``, ``event``, ``strata`` and ``start`` are read on
    the host, where the rows are sorted).  ``time``: (n,) times; ``event``:
    (n,) 1 = event, 0 = censored; Breslow ties.  ``path_mode``: "scan"
    (warm starts, the per-lambda adaptive majorizer; the default) or
    "batch" (lanes on the global d/2 bound).  ``penalty_factor``,
    ``lower_limits``/``upper_limits`` and ``exclude`` as in
    :func:`admm_tpu_torch.lasso_path`; ``weights`` case weights (summing
    to n); ``offset`` a fixed (n,) term in eta; ``strata`` stratum labels
    (risk sets within a stratum); ``start`` interval starts (the
    start-stop model, risk set ``{j: start_j < t <= stop_j}``).  Returns
    coefficients on the original scale.
    """
    X = _as_tensor(X, dtype, device)
    t_np, d_np = _host(time), _host(event)
    n, p = X.shape
    st_np = _check_survival(n, t_np, d_np, start)
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    dev = X.device
    order, first, last, seg, ext = _cox_prep(t_np, strata, st_np, dev)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    wj = offj = None
    if weights is not None:
        w_np = _host(weights)
        if w_np.shape != (n,):
            raise ValueError("weights must have one entry per row")
        if np.any(w_np <= 0):
            raise ValueError("cox weights must be positive (a zero "
                             "weight: drop the row)")
        wj = f(w_np[order])
    if offset is not None:
        o_np = _host(offset)
        if o_np.shape != (n,):
            raise ValueError("offset must have one entry per row")
        offj = f(o_np[order])
    lams = (None if lambdas is None
            else torch.sort(_as_tensor(lambdas, dtype, dev).reshape(-1),
                            descending=True).values)
    pf, limits = validate_pf_limits(penalty_factor, exclude, lower_limits,
                                    upper_limits, p, dtype, dev)
    return _cox_path(X[torch.as_tensor(order, device=dev)], f(d_np[order]),
                     first, last, int(nlambda), lambda_min_ratio, lams, rho,
                     maxit, eps_abs, eps_rel, alpha, pf, limits, wj, offj,
                     seg, ext, standardize_x=standardize,
                     path_mode=path_mode, newton_steps=int(newton_steps))


# ---------------------------------------------------------------------------
# Scoring, cross-validation and survival curves (host, float64 numpy)
# ---------------------------------------------------------------------------

def _breslow_pl(X, t, d, coefs, w=None, off=None, strata=None, start=None):
    """The Breslow log partial likelihood per path point ((L,) numpy):
    ``sum_{events i} w_i [eta_i - log sum_{t_j >= t_i} w_j e^{eta_j}]``;
    with ``strata`` the sum of the per-stratum likelihoods, with ``start``
    the interval risk sets (an O(n^2) mask: a host-side scorer, not the
    solver)."""
    X = np.asarray(X, np.float64)
    C = np.asarray(coefs, np.float64)
    if strata is not None:
        s_np = np.asarray(strata).ravel()
        out = 0.0
        for sv in np.unique(s_np):
            m = s_np == sv
            out = out + _breslow_pl(
                X[m], np.asarray(t).ravel()[m], np.asarray(d).ravel()[m], C,
                None if w is None else np.asarray(w).ravel()[m],
                None if off is None else np.asarray(off).ravel()[m],
                start=None if start is None else np.asarray(start).ravel()[m])
        return out
    t = np.asarray(t, np.float64).ravel()
    d = np.asarray(d, np.float64).ravel()
    if start is not None:
        st = np.asarray(start, np.float64).ravel()
        ws = (np.ones_like(d) if w is None
              else np.asarray(w, np.float64).ravel())
        eta = C @ X.T                               # (L, n)
        if off is not None:
            eta = eta + np.asarray(off, np.float64).ravel()[None, :]
        m = eta.max(axis=1, keepdims=True)
        ee = ws[None, :] * np.exp(eta - m)
        ev = d > 0
        # R[i, j]: row j at risk at event time t_i.
        R = (st[None, :] < t[ev][:, None]) & (t[None, :] >= t[ev][:, None])
        logS = np.log(ee @ R.T) + m
        return ((ws * d)[ev][None, :] * (eta[:, ev] - logS)).sum(axis=1)
    order = np.argsort(-t, kind="stable")
    Xs, ts, ds = X[order], t[order], d[order]
    ws = (np.ones_like(ds) if w is None
          else np.asarray(w, np.float64).ravel()[order])
    eta = C @ Xs.T                                  # (L, n)
    if off is not None:
        eta = eta + np.asarray(off, np.float64).ravel()[order][None, :]
    m = eta.max(axis=1, keepdims=True)
    cum = np.cumsum(ws[None, :] * np.exp(eta - m), axis=1)
    _, last = _tie_groups(ts)                       # tie-aware risk sums
    logS = np.log(cum[:, last]) + m
    return ((eta - logS) * (ws * ds)[None, :]).sum(axis=1)


def cv_cox_path(X, time, event, *, nfolds: int = 10, seed: int = 0,
                foldid=None, nlambda: int = 50,
                type_measure: str = "deviance", cv_mode: str = "auto",
                keep: bool = False, **path_kw):
    """Cross-validated Cox path (``admm_tpu.cv_cox_path``), scored by the
    Verweij-van Houwelingen partial-likelihood deviance (per fold k,
    ``PL_full(b_-k) - PL_-k(b_-k)``, per-fold aggregation), or by
    Harrell's C of the held-out rows (``type_measure="C"``, folds weighted
    by their events, ``lambda_min`` maximising it).  ``cv_mode``:
    "onepass" (via "auto": every fold's path is the weighted path with
    weight 0 on its held-out rows, on the device) or "loop" (a refit on
    each training subset); folds from the shared ``_cv_foldid``.  Path
    keywords (``dtype``, ``device``, ``weights``, ``offset``, ``strata``,
    ``start``, ...) pass through to :func:`cox_lasso_path`; ``fold_mesh``
    (a mesh of :mod:`admm_tpu_torch.parallel.mesh`, nfolds a multiple of
    its size) deals the one-pass folds over its positions.
    """
    from .cv import CVResult, _cv_foldid

    if type_measure not in ("deviance", "default", "C"):
        raise ValueError("cox type_measure must be 'deviance' or 'C'")
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    fold_mesh = path_kw.pop("fold_mesh", None)
    X = (X.detach().cpu().numpy() if isinstance(X, torch.Tensor)
         else np.asarray(X)).astype(np.float64)
    t, d = _host(time), _host(event)
    n = X.shape[0]
    w, off, strata, start = (path_kw.pop(k, None) for k in
                             ("weights", "offset", "strata", "start"))
    w = None if w is None else _host(w)
    off = None if off is None else _host(off)
    strata = None if strata is None else np.asarray(strata).ravel()
    start = None if start is None else _host(start)
    if start is not None and type_measure == "C":
        raise ValueError("type_measure='C' is not defined for "
                         "start-stop data; use 'deviance'")

    def sub(v, m):
        return None if v is None else v[m]

    full = cox_lasso_path(X, t, d, nlambda=nlambda, weights=w, offset=off,
                          strata=strata, start=start, **path_kw)
    # The fold refits take the full fit's grid explicitly.
    path_kw.pop("lambdas", None)
    lams = full.lambdas.detach().cpu().numpy().astype(np.float64)
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)

    fold_coefs = None
    if cv_mode != "loop":
        dtype = path_kw.get("dtype", torch.float32)
        dev = full.coef.device
        order, first, last, seg, ext = _cox_prep(t, strata, start, dev)
        pf, limits = validate_pf_limits(
            path_kw.get("penalty_factor"), path_kw.get("exclude"),
            path_kw.get("lower_limits"), path_kw.get("upper_limits"),
            X.shape[1], dtype, dev)
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        masks = f(foldid[order][None, :] != np.arange(nfolds)[:, None])
        fold_coefs = _cox_fold_coefs(
            f(X[order]), f(d[order]), first, last, f(lams), masks,
            path_kw.get("rho", -1.0), path_kw.get("maxit", 10000),
            path_kw.get("eps_abs", 1e-5), path_kw.get("eps_rel", 1e-5),
            path_kw.get("alpha", 1.0), pf, limits,
            None if w is None else f(w[order]),
            None if off is None else f(off[order]), seg, ext,
            standardize_x=path_kw.get("standardize", True),
            path_mode=path_kw.get("path_mode", "scan"),
            newton_steps=int(path_kw.get("newton_steps", 2)),
            mesh=fold_mesh)
        fold_coefs = fold_coefs.detach().cpu().numpy().astype(np.float64)

    cvraw = np.zeros((nfolds, lams.shape[0]))
    fold_w = np.ones(nfolds)
    preval = np.full((n, lams.shape[0]), np.nan) if keep else None
    for fo in range(nfolds):
        tr, va = foldid != fo, foldid == fo
        if fold_coefs is not None:
            C = fold_coefs[fo]
        else:
            C = cox_lasso_path(X[tr], t[tr], d[tr], lambdas=lams,
                               weights=sub(w, tr), offset=sub(off, tr),
                               strata=sub(strata, tr), start=sub(start, tr),
                               **path_kw).coef
            C = C.detach().cpu().numpy().astype(np.float64)
        if preval is not None:
            ev = X[va] @ C.T                              # (n_va, L)
            preval[va] = ev if off is None else ev + off[va][:, None]
        if type_measure == "C":
            from ..assess import c_index

            eta = C @ X[va].T                             # (L, n_va)
            if off is not None:
                eta = eta + off[va][None, :]
            try:
                cvraw[fo] = c_index(eta, t[va], d[va], weights=sub(w, va))
            except ValueError:           # no comparable pair this fold
                fold_w[fo] = 0.0
                continue
            fold_w[fo] = float(d[va].sum() if w is None
                               else (w[va] * d[va]).sum())
        else:
            pl_full = _breslow_pl(X, t, d, C, w, off, strata, start)
            pl_tr = _breslow_pl(X[tr], t[tr], d[tr], C, sub(w, tr),
                                sub(off, tr), sub(strata, tr),
                                sub(start, tr))
            cvraw[fo] = -2.0 * (pl_full - pl_tr)

    if type_measure == "C":
        if fold_w.sum() == 0:
            raise ValueError("the C-index is undefined in every fold "
                             "(no comparable pairs); use fewer folds")
        fw = fold_w / fold_w.sum()
        cvm = fw @ cvraw
        nf_eff = int((fold_w > 0).sum())
        cvsd = np.sqrt((fw @ (cvraw - cvm) ** 2) / max(nf_eff - 1, 1))
        i_min = int(np.argmax(cvm))
        within = cvm >= cvm[i_min] - cvsd[i_min]
    else:
        cvm = cvraw.mean(axis=0)
        cvsd = cvraw.std(axis=0, ddof=1) / np.sqrt(nfolds)
        i_min = int(np.argmin(cvm))
        within = cvm <= cvm[i_min] + cvsd[i_min]
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                    lambda_min=float(lams[i_min]),
                    lambda_1se=float(lams[np.flatnonzero(within)[0]]),
                    fit=full, foldid=foldid, fit_preval=preval)


class SurvFit(NamedTuple):
    """Breslow baseline-hazard survival curves (survfit_cox)."""
    time: np.ndarray     # (T,) unique event times, ascending
    cumhaz: np.ndarray   # (T,) baseline cumulative hazard H0(t)
    surv: np.ndarray     # (T, m) S(t | x_new) = exp(-H0(t) e^eta_new)


def survfit_cox(result, X, time, event, *, Xnew=None, lam=None, weights=None,
                offset=None, newoffset=None, strata=None, newstrata=None,
                start=None):
    """Survival curves from a fitted Cox path (glmnet's ``survfit.coxnet``,
    ``admm_tpu.survfit_cox``): the Breslow baseline cumulative hazard from
    the TRAINING data (with its ``weights``/``offset``/``start``),

        H0(t) = sum_{event times t_k <= t} (weighted events at t_k) / S(t_k),

    and ``S(t | x) = exp(-H0(t) e^{eta_x})`` for each row of ``Xnew``
    (default the training ``X``) at every event time.  ``lam`` picks the
    path point as ``predict`` does (a CV result defaults to lambda.1se);
    a plain path needs it unless it has one point.  With ``strata``: a
    dict stratum label -> SurvFit.  Float64 numpy on the host."""
    from ..interop import to_numpy
    from ..predict import _at_lam, _resolve_cv

    result, lam = _resolve_cv(result, lam)
    if lam is not None:
        result = _at_lam(result, lam)
    elif np.asarray(to_numpy(result.lambdas)).shape[0] != 1:
        raise ValueError("pass lam= to select the path point (or use "
                         "a CV result, which defaults to lambda.1se)")
    beta = np.asarray(to_numpy(result.coef), np.float64)[0]    # (p,)
    X = np.asarray(to_numpy(X), np.float64)

    if strata is not None:
        # One Breslow baseline per stratum; each SurvFit's columns are the
        # Xnew rows of that stratum (np.flatnonzero(newstrata == label)).
        s_np = np.asarray(strata).ravel()
        if Xnew is None:
            ns = s_np
        else:
            if newstrata is None:
                raise ValueError("pass newstrata= with Xnew for a "
                                 "stratified fit")
            ns = np.asarray(newstrata).ravel()

        def subv(v, m):
            return None if v is None else _host(v)[m]

        out = {}
        Xn_all = X if Xnew is None else np.asarray(to_numpy(Xnew), np.float64)
        for sv in np.unique(s_np):
            m, mn = s_np == sv, ns == sv
            if not mn.any():
                continue
            out[sv] = survfit_cox(
                result, X[m], _host(time)[m], _host(event)[m],
                Xnew=Xn_all[mn], weights=subv(weights, m),
                offset=subv(offset, m), start=subv(start, m),
                newoffset=(subv(newoffset, mn) if Xnew is not None
                           else subv(offset, m)))
        return out

    t, d = _host(time), _host(event)
    n = t.shape[0]
    w = np.ones(n) if weights is None else _host(weights)
    eta = X @ beta
    if offset is not None:
        eta = eta + _host(offset)
    Xn = X if Xnew is None else np.asarray(to_numpy(Xnew), np.float64)
    eta_new = Xn @ beta
    if newoffset is not None:
        eta_new = eta_new + _host(newoffset)
    elif Xnew is None and offset is not None:
        eta_new = eta_new + _host(offset)

    if start is not None:
        t_ev, H0 = _survfit_baseline_startstop(t, d, w, eta, _host(start))
    else:
        order = np.argsort(t, kind="stable")             # ASCENDING
        ts, ds, ws = t[order], d[order], w[order]
        ee = ws * np.exp(eta[order])
        # The risk set of t_k is everyone with t_j >= t_k, a suffix sum;
        # ties share their group's first (ascending) position's.
        suffix = np.cumsum(ee[::-1])[::-1]
        uniq, first_idx = np.unique(ts, return_index=True)
        S = suffix[first_idx]
        dsum = np.add.reduceat(ws * ds, first_idx)
        has_event = dsum > 0
        t_ev = uniq[has_event]
        if t_ev.size == 0:
            raise ValueError("no events in the training data")
        H0 = np.cumsum(dsum[has_event] / S[has_event])
    return SurvFit(time=t_ev, cumhaz=H0,
                   surv=np.exp(-np.outer(H0, np.exp(eta_new))))


def _survfit_baseline_startstop(t, d, w, eta, start):
    """The Breslow baseline cumulative hazard under START-STOP risk sets
    ``S(t) = sum_{start_j < t <= stop_j} w_j e^{eta_j}`` (an O(n^2) host
    mask; estimation only)."""
    ee = w * np.exp(eta)
    t_ev = np.unique(t[d > 0])
    if t_ev.size == 0:
        raise ValueError("no events in the training data")
    R = (start[None, :] < t_ev[:, None]) & (t[None, :] >= t_ev[:, None])
    dsum = np.array([(w * d)[t == tk].sum() for tk in t_ev])
    return t_ev, np.cumsum(dsum / (R @ ee))
