"""Lasso / Elastic-Net lambda-path solvers, tall and wide regimes
(counterpart of ``admm_tpu/models/lasso.py``).

Model (glmnet objective; reference: src/Lasso.cpp:52-55)::

    minimize  1/(2n) ||y - X beta||^2
              + lambda * (alpha ||beta||_1 + (1-alpha)/2 ||beta||_2^2)

The solver works on standardized data with the internal penalty
``ilambda = lambda * n / scale_y`` (reference: src/Lasso.cpp:67-99), and
dispatches on shape (reference: src/Lasso.cpp:73-76):

* tall (n > p): FADMM on ``x - z = 0`` against a cached ridge inverse
  ``(X'X + rho I)^-1``, rho fixed at ``eigmax(X'X)^(1/3) lambda^(2/3)``
  (reference: src/ADMMLassoTall.h:9-20, :70-97, :194-202);
* wide (p >= n): plain ADMM with a linearized x-update and the adaptive
  rho ladder (reference: src/ADMMLassoWide.h:13-25, :129-165).

Two path modes in each regime: "scan" warm-starts the lambdas in
sequence (the reference's protocol), "batch" solves them all at once as
lanes; the wide regime's "activeset" mode is the reference's 4^k-1
active-set cadence as a gathered column block, which scan-mode wide paths
take at p >= ``_ACTIVESET_AUTO_P``.  In float32 the path runs through the
hand-written kernels of :mod:`admm_tpu_torch.kernels` (their plain PyTorch
forms on the CPU); float64, glmnet's per-coordinate penalty factors and
coefficient boxes, traced solves and shapes past a kernel's shared-memory
rule take the generic engines of :mod:`admm_tpu_torch.core.engine`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ADMMState, ProblemOps, _adaptive_rho,
                           _count_loop, col, make_admm_solver,
                           make_batched_solver, make_batched_traced_solve,
                           make_fadmm_solver, make_state, make_traced_solve,
                           warm_start)
from ..core.prox import enet_prox, l2norm, sqnorm
from ..data.standardize import StdStats, recover, standardize
from ..diag import profile
from ..kernels import tall_path, wide_path
from ..kernels._common import sm_count
from ..linalg import dot, gram, ridge_inverse, spectral_radius_gram, spectral_radius_sym
from ..parallel.mesh import is_sharded, put_dim_sharded


class PathResult(NamedTuple):
    """Lambda-path result on the original data scale."""
    lambdas: torch.Tensor  # (nlambda,) user-scale penalty grid
    beta0: torch.Tensor    # (nlambda,) intercepts
    coef: torch.Tensor     # (nlambda, p) coefficients
    niter: torch.Tensor    # (nlambda,) int32 ADMM iteration counts
    # (nlambda, trace_len, 5) per-iteration (eps_pri, r_pri, eps_dua,
    # r_dua, rho) when tracing was requested (admm_tpu_torch.diag.trace).
    trace: Optional[torch.Tensor] = None


@profile.spanned("pack")
def _truncate_path(res, dfmax, pmax):
    """glmnet's ``dfmax``/``pmax``: the longest path PREFIX on which every
    point has <= dfmax nonzero coefficients (and the ever-active union
    stays <= pmax); glmnet shortens the returned path rather than
    erroring.  A host-side trim of a finished result."""
    coef = res.coef.detach().cpu().numpy()
    nz = coef != 0 if coef.ndim == 2 else np.any(coef != 0, axis=-1)
    ok = np.ones(nz.shape[0], bool)
    if dfmax is not None:
        ok &= nz.sum(axis=1) <= int(dfmax)
    if pmax is not None:
        ever = np.logical_or.accumulate(nz, axis=0)
        ok &= ever.sum(axis=1) <= int(pmax)
    bad = np.flatnonzero(~ok)
    k = int(bad[0]) if bad.size else ok.size
    if k == 0:
        raise ValueError("dfmax/pmax exclude even the largest-lambda "
                         "model; raise the limit")
    if k == ok.size:
        return res
    upd = {f: getattr(res, f)[:k]
           for f in ("lambdas", "beta0", "coef", "niter")}
    if getattr(res, "trace", None) is not None:
        upd["trace"] = res.trace[:k]
    return res._replace(**upd)


@profile.spanned("validate")
def validate_pf_limits(penalty_factor, exclude, lower_limits, upper_limits,
                       p, dtype, device):
    """Normalize glmnet's ``penalty.factor`` / ``exclude`` /
    ``lower.limits`` / ``upper.limits`` into ``(pf, limits)`` on
    ``device``.

    ``pf``: (p,) factors rescaled to sum p (glmnet convention), or None.
    ``limits``: ((p,) lo, (p,) up) ORIGINAL-scale box (the path function
    maps it to its standardized scale), or None; ``exclude`` indices are
    merged in as the lower = upper = 0 box (exactly equivalent: the prox clips those
    coordinates to 0 every iteration)."""
    pf = None
    if penalty_factor is not None:
        pf = _as_tensor(penalty_factor, dtype, device).reshape(-1).to(device)
        if pf.shape != (p,):
            raise ValueError("penalty_factor must have one entry per "
                             "column of x")
        if bool(torch.any(pf < 0)) or not bool(torch.any(pf > 0)):
            raise ValueError("penalty_factor entries must be >= 0 with "
                             "at least one positive")
        pf = pf * (p / torch.sum(pf))  # glmnet: factors sum to nvars

    def bound(limit, default):
        if isinstance(limit, torch.Tensor):
            limit = limit.detach().cpu().numpy()
        return np.broadcast_to(np.asarray(
            default if limit is None else limit, np.float64), (p,)).copy()

    if exclude is not None:
        idx = np.asarray(exclude, np.int64).ravel()
        if idx.size and (idx.min() < 0 or idx.max() >= p):
            raise ValueError("exclude indices must be in [0, p)")
        lo, up = bound(lower_limits, -np.inf), bound(upper_limits, np.inf)
        lo[idx] = 0.0
        up[idx] = 0.0
        lower_limits, upper_limits = lo, up
    limits = None
    if lower_limits is not None or upper_limits is not None:
        lo, up = bound(lower_limits, -np.inf), bound(upper_limits, np.inf)
        if np.any(lo > 0) or np.any(up < 0):
            raise ValueError("limits must satisfy lower <= 0 <= upper "
                             "(glmnet convention: 0 stays feasible)")
        limits = (torch.as_tensor(lo, dtype=dtype, device=device),
                  torch.as_tensor(up, dtype=dtype, device=device))
    return pf, limits


# Wide scan-mode solves at or past this p auto-dispatch to the gathered
# active-set solver (_solve_path_wide_activeset).  The JAX package chose
# 20000 on the TPU; re-measured on the H100 (PERF.md section 6, PR 8).
_ACTIVESET_AUTO_P = 20000


# ---------------------------------------------------------------------------
# Kernel shape rules
# ---------------------------------------------------------------------------

def _use_kernel_tall(p: int, dtype) -> bool:
    """Tall path kernels: float32, and p no larger than the kernels take
    (``p <= kernels.tall_path.MAX_P``)."""
    return dtype == torch.float32 and tall_path.fits(p)


def _use_kernel_wide_scan(Xs) -> bool:
    """Wide scan kernel: float32 and all of X on one device; on a card
    also a block's slices of X and its copy of the lane in one block's
    shared memory at the card's block count
    (``kernels.wide_path.scan_fits``).  The plain form has no such limit."""
    if Xs.dtype != torch.float32 or is_sharded(Xs):
        return False
    return (Xs.device.type != "cuda"
            or wide_path.scan_fits(*Xs.shape, sm_count(Xs.device)))


def _use_kernel_wide(n: int, p: int, dtype, Xs=None) -> bool:
    """Wide path kernel: float32, ``3p + 5n`` floats of lane state in
    one block's shared memory, and all of X on one device (a row-sharded
    X takes the engine)."""
    return (dtype == torch.float32 and wide_path.fits(n, p)
            and not is_sharded(Xs))


# ---------------------------------------------------------------------------
# Tall regime (n > p): FADMM with cached ridge inverse
# ---------------------------------------------------------------------------

def _penalized_prox(v, pen, alpha, pf, bounds):
    """The z-update's prox with glmnet's per-coordinate options: ``pf``
    (factors summing to p) scales each coordinate's threshold, ``bounds``
    (lo, up) on the standardized scale clips after the shrink (both terms
    are separable and the box holds 0, so the clip is the exact prox)."""
    if pf is not None:
        pen = pen * pf
    z = enet_prox(v, pen, alpha)
    if bounds is not None:
        z = torch.clamp(z, min=bounds[0], max=bounds[1])
    return z


def _tall_ops(Minv, Xty, alpha, p, pf=None, bounds=None) -> ProblemOps:
    """The tall Lasso's hooks.  They read only the replicated ``Minv``
    and ``X'y`` (a row-sharded X's sums are taken at set-up), so they are
    capturable in a CUDA graph (``graph_safe``)."""
    def next_x(st):
        rhs = Xty - st.adj_y + col(st.rho) * st.adj_z
        return rhs @ Minv.mT          # Minv @ rhs, lane by lane

    def next_z(st, x_new):
        v = x_new + st.adj_y / col(st.rho)
        return _penalized_prox(v, col(st.lam / st.rho), alpha, pf,
                               bounds), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x), l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=p, graph_safe=True,
    )


@profile.spanned("setup")
def _tall_setup(Xs, ys, lam_first, rho0):
    """Ridge inverse, X'y and rho.  Auto-rho is the power law
    ``cbrt(sprad) * lambda^(2/3)`` (reference: src/ADMMLassoTall.h:194-202);
    torch has no cbrt, so ``pow(1/3)`` of the positive sprad."""
    XtX = gram(Xs)
    Xty = dot(Xs.mT, ys)
    if rho0 > 0:
        rho = torch.tensor(rho0, dtype=Xs.dtype, device=Xs.device)
    else:
        sprad = spectral_radius_sym(XtX)
        rho = sprad.pow(1.0 / 3.0) * lam_first ** (2.0 / 3.0)
    Minv = ridge_inverse(XtX, rho)
    return Minv, Xty, rho


def _tall_engine(Xs, ys, lam_first, rho0, alpha, pf=None, bounds=None):
    """Tall-regime engine: cold state, solver, reported iterate (z,
    reference: src/Lasso.cpp:108)."""
    p = Xs.shape[1]
    Minv, Xty, rho = _tall_setup(Xs, ys, lam_first, rho0)
    solve = make_fadmm_solver(_tall_ops(Minv, Xty, alpha, p, pf, bounds),
                              adapt_rho=False)
    zeros = torch.zeros((p,), dtype=Xs.dtype, device=Xs.device)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first)
    return st0, solve, (lambda st: st.z)


def _scan_path(st0, solve, report, ilams, maxit, eps_abs, eps_rel,
               trace_len=None, refresh=None):
    """Warm-started loop over the lambda grid (any engine).

    With ``trace_len`` set, each lambda's solve records its per-iteration
    residual trace (``core.engine.make_traced_solve``: the engine's one
    host loop, on the graph route where the solve's hooks allow it) and
    ``traces`` is the (nlambda, trace_len, 5) stack; otherwise it is
    None.  ``refresh`` (optional) maps the warm-start iterate to a new
    ``st.aux`` at each lambda: the per-lambda adaptive-majorizer hook of
    the GLM paths."""
    solve_t = (None if trace_len is None
               else make_traced_solve(solve, trace_len))
    st = st0
    coefs, niter, traces = [], [], []
    for lam in ilams:
        with profile.span("solve", kernel="engine"):
            st = warm_start(st, lam)
            if refresh is not None:
                st = st._replace(aux=refresh(st.x))
            if solve_t is None:
                st = solve(st, maxit, eps_abs, eps_rel)
            else:
                st, buf = solve_t(st, maxit, eps_abs, eps_rel)
                traces.append(buf)
            coefs.append(report(st))
            niter.append(st.it)
    return (st, torch.stack(coefs), torch.stack(niter),
            torch.stack(traces) if traces else None)


def _solve_path_tall(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel, alpha,
                     trace_len=None, pf=None, bounds=None):
    # Penalty factors and boxes take the engine: the kernels carry one
    # scalar penalty per lane.  A traced solve takes the engine too.
    if (trace_len is None and pf is None and bounds is None
            and _use_kernel_tall(Xs.shape[1], Xs.dtype)):
        Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], rho0)
        return (*tall_path.tall_path_scan(
            Minv.contiguous(), Xty.contiguous(), ilams.contiguous(), rho,
            eps_abs, eps_rel, alpha, maxit), None)
    st0, solve, report = _tall_engine(Xs, ys, ilams[0], rho0, alpha, pf,
                                      bounds)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return coefs, niter, traces


def _batched_cold_states(k, dims, rho, ilams, aux_dim=None) -> ADMMState:
    """Stacked cold-start states, one lane per lambda."""
    dtype, dev = ilams.dtype, ilams.device
    zeros = torch.zeros((k, dims), dtype=dtype, device=dev)
    ones = torch.ones((k,), dtype=dtype, device=dev)
    aux = (None if aux_dim is None
           else torch.zeros((k, aux_dim), dtype=dtype, device=dev))
    return ADMMState(
        x=zeros, z=zeros, y=zeros, adj_z=zeros, adj_y=zeros, aux=aux,
        adj_a=ones, adj_c=9999.0 * ones,
        rho=rho * ones, lam=ilams.clone(),
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        it=torch.zeros((k,), dtype=torch.int32, device=dev),
        done=torch.zeros((k,), dtype=torch.bool, device=dev),
    )


@profile.spanned("solve", kernel="engine")
def _run_batched(engine, st, maxit, eps_abs, eps_rel, trace_len):
    """The batched engine on cold lanes, traced per lane when
    ``trace_len`` is set: ``(final states, (k, trace_len, 5) or None)``."""
    if trace_len is None:
        return make_batched_solver(engine)(st, maxit, eps_abs, eps_rel), None
    return make_batched_traced_solve(engine, trace_len)(st, maxit, eps_abs,
                                                        eps_rel)


def _solve_path_tall_batch(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel,
                           alpha, trace_len=None, pf=None, bounds=None):
    """All lambdas at once, one shared rho and ridge inverse (the
    reference's rho is set at the first lambda and never changes,
    reference: src/ADMMLassoTall.h:96-97, :219-230).  ``trace_len``
    records a per-lane trace of the cold-start lanes, on the engine."""
    p = Xs.shape[1]
    Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], rho0)
    if (trace_len is None and pf is None and bounds is None
            and _use_kernel_tall(p, Xs.dtype)):
        return (*tall_path.tall_path_batch(
            Minv.contiguous(), Xty.contiguous(), ilams.contiguous(), rho,
            eps_abs, eps_rel, alpha, maxit), None)
    engine = make_fadmm_solver(_tall_ops(Minv, Xty, alpha, p, pf, bounds),
                               adapt_rho=False)
    st = _batched_cold_states(ilams.shape[0], p, rho, ilams)
    st, buf = _run_batched(engine, st, maxit, eps_abs, eps_rel, trace_len)
    return st.z, st.it, buf


# ---------------------------------------------------------------------------
# Wide regime (p >= n): linearized ADMM, adaptive rho
# ---------------------------------------------------------------------------

@profile.spanned("setup")
def _wide_setup(Xs, ys, rho_lams, rho0, alpha, enet_lambda0_scale):
    """lambda0 (with the Enet inflation, reference: src/ADMMEnet.h:56),
    the matrix-free spectral radius of XX', and auto-rho
    ``cbrt(lambda / sprad)`` (reference: src/ADMMLassoWide.h:227-228) —
    scalar for the scan path, per lane for the batch path."""
    lambda0 = torch.max(torch.abs(dot(Xs.mT, ys)))
    if enet_lambda0_scale:
        lambda0 = lambda0 / (alpha + 1e-4)
    sprad = spectral_radius_gram(Xs)
    if rho0 > 0:
        rho = torch.tensor(rho0, dtype=Xs.dtype, device=Xs.device)
    else:
        rho = (rho_lams / sprad).pow(1.0 / 3.0)
    return lambda0, sprad, rho


def _wide_ops(Xs, ys, sprad, lambda0, alpha, n, p, pf=None,
              bounds=None) -> ProblemOps:
    """The wide Lasso's hooks: capturable in a CUDA graph
    (``graph_safe``) unless X is a row-sharded matrix (``Sharded``), whose
    products sum over positions (``all_sum``; gloo's runs through the
    host)."""
    sqrt_sprad = torch.sqrt(sprad)

    def next_x(st):
        tmp = st.aux + st.z + st.y / col(st.rho)
        v = st.x - (tmp @ Xs) / sprad
        x_new = _penalized_prox(v, col(st.lam / (st.rho * sprad)), alpha,
                                pf, bounds)
        # Early exit: a penalty at or above lambda0 keeps beta = 0, with
        # the JAX package's relative slack (reference:
        # src/ADMMLassoWide.h:131-135 subtracts an absolute one).
        return torch.where(col(st.lam > lambda0 * (1.0 - 1e-5)),
                           torch.zeros_like(x_new), x_new)

    def next_z(st, x_new):
        cache_Ax = x_new @ Xs.mT
        z = -(ys + st.y + col(st.rho) * cache_Ax) / (1.0 + col(st.rho))
        return z, cache_Ax

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
        dim_main=p, dim_dual=n, graph_safe=not is_sharded(Xs),
    )


def _wide_engine(Xs, ys, lam_first, rho0, alpha, enet_lambda0_scale,
                 pf=None, lambda0=None, bounds=None):
    """Wide-regime engine: cold state, solver, reported iterate (x,
    reference: src/Lasso.cpp:119).  ``lambda0`` overrides the all-zero
    threshold (the factor-aware one when penalty factors are in play)."""
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    lambda0_auto, sprad, rho = _wide_setup(Xs, ys, lam_first, rho0, alpha,
                                           enet_lambda0_scale)
    if lambda0 is None:
        lambda0 = lambda0_auto
    solve = make_admm_solver(_wide_ops(Xs, ys, sprad, lambda0, alpha, n, p,
                                       pf, bounds), adapt_rho=True)
    zn = torch.zeros((n,), dtype=dtype, device=dev)
    st0 = make_state(torch.zeros((p,), dtype=dtype, device=dev), zn, zn, rho,
                     lam_first, aux=zn)
    return st0, solve, (lambda st: st.x)


def _solve_path_wide(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel, alpha,
                     enet_lambda0_scale, trace_len=None, pf=None,
                     lambda0_pf=None, bounds=None):
    # As in the tall regime: factors, boxes and traced solves take the
    # engine, and so do shapes past the scan kernel's rule.
    if (trace_len is None and pf is None and bounds is None
            and _use_kernel_wide_scan(Xs)):
        lambda0, sprad, rho = _wide_setup(Xs, ys, ilams[0], rho0, alpha,
                                          enet_lambda0_scale)
        return (*wide_path.wide_path_scan(
            Xs.contiguous(), ys.contiguous(), ilams.contiguous(), rho,
            sprad, lambda0, eps_abs, eps_rel, alpha, maxit), None)
    st0, solve, report = _wide_engine(Xs, ys, ilams[0], rho0, alpha,
                                      enet_lambda0_scale, pf, lambda0_pf,
                                      bounds)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return coefs, niter, traces


def _solve_path_wide_batch(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel,
                           alpha, enet_lambda0_scale, trace_len=None,
                           pf=None, lambda0_pf=None, bounds=None):
    """All lambdas at once; rho is per lane (no factorization depends on
    it, so each lambda keeps its own auto-rho and ladder).  ``trace_len``
    records a per-lane trace, on the engine."""
    n, p = Xs.shape
    k = ilams.shape[0]
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams, rho0, alpha,
                                      enet_lambda0_scale)
    rhos = torch.broadcast_to(rho, (k,)).contiguous()
    if (trace_len is None and pf is None and bounds is None
            and _use_kernel_wide(n, p, Xs.dtype, Xs)):
        return (*wide_path.wide_path_batch(
            Xs.contiguous(), ys.contiguous(), ilams.contiguous(), rhos,
            sprad, lambda0, eps_abs, eps_rel, alpha, maxit), None)
    if lambda0_pf is not None:
        lambda0 = lambda0_pf
    engine = make_admm_solver(_wide_ops(Xs, ys, sprad, lambda0, alpha, n, p,
                                        pf, bounds), adapt_rho=True)
    st = _batched_cold_states(k, p, 1.0, ilams, aux_dim=n)
    zn = torch.zeros((k, n), dtype=Xs.dtype, device=Xs.device)
    st = st._replace(rho=rhos, z=zn, y=zn, adj_z=zn, adj_y=zn)
    st, buf = _run_batched(engine, st, maxit, eps_abs, eps_rel, trace_len)
    return st.x, st.it, buf


def _top_support(x, S: int):
    """The indices of the S largest ``|x|``, ascending.  Ties go to the
    lower index, as ``lax.top_k`` breaks them (``torch.topk`` leaves
    their order undefined): the first S of a stable descending sort."""
    order = torch.sort(torch.abs(x), descending=True, stable=True).indices
    return torch.sort(order[:S]).values


def _solve_path_wide_activeset(Xs, ys, ilams, rho0, maxit, eps_abs,
                               eps_rel, alpha, enet_lambda0_scale,
                               s_max: Optional[int] = None):
    """Wide-regime scan path with the reference's 4^k-1 active-set
    cadence (reference: src/ADMMLassoWide.h:86-127), as the JAX package
    realises it: at each regular iteration (it = 4^k - 1) a FULL
    linearized x-update, after which the top ``S`` coordinates by |x| are
    kept and their columns gathered into a dense (n, S) block ``Xa``; the
    iterations in between update only those coordinates against ``Xa``
    (two (n, S) products instead of two (n, p)).  Residuals, tolerances,
    the adaptive-rho ladder and the Boyd test are the dense engine's
    (:func:`_wide_ops`).  S is ``s_max`` or max(256, p/4) capped at p,
    exact whenever the solution's support fits.

    The loop is the port's own: regular or active is a compare of two
    host integers (``it`` against ``next_reg``), so each iteration reads
    only ``done`` from the device, as the engines do.  Returns (coefs,
    niter, None)."""
    n, p = Xs.shape
    dtype, dev = Xs.dtype, Xs.device
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams[0], rho0, alpha,
                                      enet_lambda0_scale)
    S = int(s_max) if s_max else min(p, max(256, p // 4))
    sqrt_sprad = torch.sqrt(sprad)
    sq_n = torch.tensor(np.sqrt(n), dtype=dtype, device=dev)
    sq_p = torch.tensor(np.sqrt(p), dtype=dtype, device=dev)
    eps_abs = torch.as_tensor(eps_abs, dtype=dtype, device=dev)
    eps_rel = torch.as_tensor(eps_rel, dtype=dtype, device=dev)
    zero_at = lambda0 * (1.0 - 1e-5)

    def shrink(v, pen, lam):
        # Early exit at or above lambda0, as _wide_ops.next_x.
        out = enet_prox(v, pen, alpha)
        return torch.where(lam > zero_at, torch.zeros_like(out), out)

    def refresh(x):
        idx = _top_support(x, S)
        x_cap = torch.zeros_like(x)
        x_cap[idx] = x[idx]
        return x_cap, idx, Xs.index_select(1, idx)

    x = torch.zeros((p,), dtype=dtype, device=dev)
    z = torch.zeros((n,), dtype=dtype, device=dev)
    y, aux = z, z
    x, idx, Xa = refresh(x)
    coefs, niter = [], []
    for lam in ilams:
        it, next_reg, done = 0, 0, False
        while it < maxit and not done:
            eps_pri = (torch.maximum(l2norm(aux), l2norm(z)) * eps_rel
                       + sq_n * eps_abs)
            eps_dua = sqrt_sprad * l2norm(y) * eps_rel + sq_p * eps_abs
            tmp = aux + z + y / rho
            pen = lam / (rho * sprad)
            if it == next_reg:
                x_new = shrink(x - (tmp @ Xs) / sprad, pen, lam)
                x_new, idx, Xa = refresh(x_new)
                ax = Xa @ x_new[idx]
                next_reg = next_reg * 4 + 3
            else:
                xa_new = shrink(x[idx] - (tmp @ Xa) / sprad, pen, lam)
                x_new = torch.zeros_like(x)
                x_new[idx] = xa_new
                ax = Xa @ xa_new
            z_new = -(ys + y + rho * ax) / (1.0 + rho)
            r_dua = rho * sqrt_sprad * l2norm(z_new - z)
            r = ax + z_new
            r_pri = l2norm(r)
            y = y + rho * r
            done_t = (r_pri < eps_pri) & (r_dua < eps_dua)
            if it > 3:
                rho = torch.where(done_t, rho, _adaptive_rho(
                    rho, r_pri, eps_pri, r_dua, eps_dua))
            x, z, aux = x_new, z_new, ax
            it += 1
            done = bool(done_t)
        coefs.append(x)
        niter.append(it)
    # One read of ``done`` an iteration, counted once for the path.
    _count_loop(sum(niter), sum(niter), sum(niter))
    return (torch.stack(coefs),
            torch.tensor(niter, dtype=torch.int32, device=dev), None)


# ---------------------------------------------------------------------------
# Path drivers (standardize -> lambda grid -> solve -> recover)
# ---------------------------------------------------------------------------

def _linspace(start, stop, num: int):
    """``jnp.linspace``'s formula, start*(1-t) + stop*t; XLA's fused
    evaluation of it still differs from this one by up to an ulp."""
    if num == 1:
        return start.reshape(1)
    t = torch.arange(num - 1, dtype=start.dtype, device=start.device) / (num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, stop.reshape(1)])


def _kkt_top(Xty, pf, alpha, enet_scale, Xty_abs=None):
    """The all-zero threshold of the internal penalty: ``max_j |x_j'y|``,
    over penalized coordinates divided by their factors when ``pf`` is
    given (glmnet's rule: a zero-factor coordinate never gates it), with
    the Enet inflation (reference: src/ADMMEnet.h:56)."""
    if Xty_abs is None:
        Xty_abs = torch.abs(Xty)
    if pf is None:
        top = torch.max(Xty_abs)
    else:
        top = torch.max(torch.where(pf > 0,
                                    Xty_abs / torch.clamp(pf, min=1e-12),
                                    torch.zeros_like(Xty_abs)))
    return top / (alpha + 1e-4) if enet_scale else top


@profile.spanned("setup")
def _auto_lambdas(Xs, ys, stats: StdStats, nlambda, lambda_min_ratio,
                  alpha, enet_scale, pf=None, limits=None):
    """Auto lambda grid: log-linear from lambda0 down to ratio*lambda0
    (reference: src/Lasso.cpp:78-89), on the user's scale.  With penalty
    factors the top is the factor-aware KKT boundary; with limits only
    the feasible directions count (a positive move needs ``up_j > 0``, a
    negative one ``lo_j < 0``)."""
    n = Xs.shape[0]
    Xty = dot(Xs.mT, ys)
    Xty_abs = None
    if limits is not None:
        lo, up = _std_bounds(limits, stats)
        ninf = torch.full_like(Xty, -float("inf"))
        dir_pos = torch.where(up > 0, Xty, ninf)
        dir_neg = torch.where(lo < 0, -Xty, ninf)
        Xty_abs = torch.clamp(torch.maximum(dir_pos, dir_neg), min=0.0)
    lam0_int = _kkt_top(Xty, pf, alpha, enet_scale, Xty_abs)
    lmax = lam0_int / n * stats.scale_y
    lmin = lambda_min_ratio * lmax
    return torch.exp(_linspace(torch.log(lmax), torch.log(lmin), nlambda))


def _std_bounds(limits, stats: StdStats):
    """An original-scale coefficient box on the standardized scale:
    coef_orig = coef_std * scale_y / scale_x, so the limits map by the
    inverse factor (0 stays 0)."""
    return (limits[0] * stats.scale_x / stats.scale_y,
            limits[1] * stats.scale_x / stats.scale_y)


def _path_auto(X, y, nlambda, lambda_min_ratio, rho, maxit, eps_abs,
               eps_rel, alpha, weights, pf=None, limits=None, *,
               standardize_x, intercept, enet_scale, path_mode,
               trace_len=None):
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    lams = _auto_lambdas(Xs, ys, stats, nlambda, lambda_min_ratio, alpha,
                         enet_scale, pf, limits)
    return _path_from_lams(Xs, ys, stats, lams, rho, maxit, eps_abs,
                           eps_rel, alpha, standardize_x, intercept,
                           enet_scale, path_mode, pf, limits, trace_len)


def _path_user(X, y, lams, rho, maxit, eps_abs, eps_rel, alpha, weights,
               pf=None, limits=None, *, standardize_x, intercept, enet_scale,
               path_mode, trace_len=None):
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    return _path_from_lams(Xs, ys, stats, lams, rho, maxit, eps_abs,
                           eps_rel, alpha, standardize_x, intercept,
                           enet_scale, path_mode, pf, limits, trace_len)


def _path_from_lams(Xs, ys, stats: StdStats, lams, rho, maxit, eps_abs,
                    eps_rel, alpha, standardize_x, intercept, enet_scale,
                    path_mode="scan", pf=None, limits=None, trace_len=None):
    n, p = Xs.shape
    bounds = None if limits is None else _std_bounds(limits, stats)
    # The wide engines' all-zero early exit with factors: the exact KKT
    # boundary when every factor is positive; +inf (exit off) when a
    # coordinate is unpenalized, since beta is then never all zero.
    lambda0_pf = None
    if pf is not None:
        kkt = _kkt_top(dot(Xs.mT, ys), pf, alpha, enet_scale)
        lambda0_pf = torch.where(torch.all(pf > 0), kkt,
                                 torch.full_like(kkt, float("inf")))
    # Internal penalty scale (reference: src/Lasso.cpp:99).
    ilams = lams * n / stats.scale_y
    args = (Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, alpha)
    if n > p:
        if path_mode == "batch":
            coefs, niter, traces = _solve_path_tall_batch(*args, trace_len,
                                                          pf, bounds)
        else:
            coefs, niter, traces = _solve_path_tall(*args, trace_len, pf,
                                                    bounds)
    elif path_mode == "batch":
        coefs, niter, traces = _solve_path_wide_batch(
            *args, enet_scale, trace_len, pf, lambda0_pf, bounds)
    elif (path_mode == "activeset"
          or (path_mode == "scan" and trace_len is None and pf is None
              and bounds is None and p >= _ACTIVESET_AUTO_P)):
        # The reference's 4^k-1 cadence as a gathered column block
        # (reference: src/ADMMLassoWide.h:86-127).
        coefs, niter, traces = _solve_path_wide_activeset(*args, enet_scale)
    else:
        coefs, niter, traces = _solve_path_wide(
            *args, enet_scale, trace_len, pf, lambda0_pf, bounds)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


@profile.spanned("h2d")
def _as_tensor(a, dtype, device) -> torch.Tensor:
    """A tensor stays on its own device; anything else goes to ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@profile.spanned("h2d")
def _as_data(X, dtype, device, data_mesh=None, dim: int = 0):
    """The data matrix of an entry point: ``_as_tensor``'s, or under
    ``data_mesh`` this process's blocks along ``dim``
    (:func:`~admm_tpu_torch.parallel.mesh.put_dim_sharded`), each on its
    position's device; the replicated inputs then go to the mesh's home
    device (``X.device``)."""
    if data_mesh is None:
        return _as_tensor(X, dtype, device)
    return put_dim_sharded(X, data_mesh, dim, dtype)


@profile.spanned("fit")
def lasso_path(X, y, *, lambdas=None, nlambda: int = 100,
               lambda_min_ratio: Optional[float] = None,
               standardize: bool = True, intercept: bool = True,
               maxit: int = 10000, eps_abs: float = 1e-5,
               eps_rel: float = 1e-5, rho: float = -1.0,
               alpha: float = 1.0, _enet_scale: bool = False,
               path_mode: str = "scan", data_mesh=None,
               trace_len: Optional[int] = None, weights=None,
               penalty_factor=None, lower_limits=None, upper_limits=None,
               exclude=None, offset=None, dfmax: Optional[int] = None,
               pmax: Optional[int] = None, dtype=torch.float32,
               device="cuda") -> PathResult:
    """Solve the full Lasso / Elastic-Net lambda path.

    Same arguments and defaults as ``admm_tpu.lasso_path`` (reference R
    API: R/30_admm_lasso.R:31-49), plus ``device``: tensors stay on their
    own device, anything else (numpy arrays, lists) goes to ``device``.

    ``path_mode``: "scan" (default) warm-starts the lambdas in sequence,
    the reference's protocol; "batch" solves all lambdas at once as lanes.
    ``weights`` are glmnet's observation weights; ``offset`` is glmnet's
    gaussian offset, an exact shift of the response.

    glmnet's per-coordinate options: ``penalty_factor`` (nonnegative
    factors, rescaled to sum p; coordinate j is penalized ``lambda *
    pf_j``, and the auto grid's top is the factor-aware KKT boundary),
    ``lower_limits``/``upper_limits`` (an original-scale box holding 0;
    the prox clips, the grid's top counts only feasible directions),
    ``exclude`` (the lower = upper = 0 box at those indices), and
    ``dfmax``/``pmax`` (the path stops before the first point with more
    than dfmax nonzeros, or an ever-active set past pmax).  A factor or a
    box takes the engine: the kernels carry one scalar penalty per lane.

    ``path_mode="activeset"`` (wide data only, no factors or limits) is
    the reference's 4^k-1 active-set cadence as a gathered column block
    (:func:`_solve_path_wide_activeset`); scan-mode wide paths at p >=
    ``_ACTIVESET_AUTO_P`` take it too.

    ``trace_len``: record the first ``trace_len`` iterations' (eps_primal,
    resid_primal, eps_dual, resid_dual, rho) per lambda in
    ``result.trace``, (nlambda, trace_len, 5) on the result's device.  A
    traced path runs on the engine, never a kernel: "scan" records the
    warm-started sequence, "batch" each cold-start lane's own iterations,
    and "activeset" falls back to the traced scan.

    ``data_mesh`` (operator parallelism; a mesh of
    :mod:`admm_tpu_torch.parallel.mesh`): X is sharded along its rows over
    the mesh, and each process holds only its positions' rows.  The
    standardization moments, the Gram X'X, X'y and the wide path's
    per-iteration ``X'r`` are sums over the mesh and ``X v`` is computed
    per block and gathered; the (p, p) state stays replicated, as in the
    JAX package.  Set up, the tall path needs only the replicated ridge
    inverse and X'y, so it keeps its scan or batch kernel; the wide
    kernel holds all of X, so a sharded wide path runs on the engine.
    Results equal the run without a mesh up to reduction order.
    """
    if path_mode not in ("scan", "batch", "activeset"):
        raise ValueError(
            "path_mode must be 'scan', 'batch' or 'activeset'")
    if trace_len is not None:
        if path_mode != "batch":
            path_mode = "scan"
        trace_len = int(trace_len)
    X = _as_data(X, dtype, device, data_mesh)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    if offset is not None:
        off = _as_tensor(offset, dtype, y.device).reshape(-1)
        if off.shape != y.shape:
            raise ValueError("offset must have one entry per row")
        y = y - off
    n, p = X.shape
    if path_mode == "activeset" and n > p:
        raise ValueError("path_mode='activeset' is the wide-regime "
                         "(p >= n) solver; tall problems use the "
                         "factorized engines")
    if path_mode == "activeset":
        if penalty_factor is not None:
            raise ValueError("penalty_factor is not supported by the "
                             "active-set path (per-coordinate "
                             "thresholds); use 'batch' or 'scan'")
        if (lower_limits is not None or upper_limits is not None
                or exclude is not None):
            raise ValueError("coefficient limits are not supported by "
                             "the active-set path; use 'batch' or "
                             "'scan'")
    pf, limits = validate_pf_limits(penalty_factor, exclude, lower_limits,
                                    upper_limits, p, dtype, X.device)
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    kw = dict(standardize_x=standardize, intercept=intercept,
              enet_scale=_enet_scale, path_mode=path_mode,
              trace_len=trace_len)
    if lambdas is not None:
        lams = torch.sort(_as_tensor(lambdas, dtype, X.device).reshape(-1),
                          descending=True).values
        res = _path_user(X, y, lams, rho, maxit, eps_abs, eps_rel, alpha,
                         w, pf, limits, **kw)
    else:
        res = _path_auto(X, y, int(nlambda), lambda_min_ratio, rho, maxit,
                         eps_abs, eps_rel, alpha, w, pf, limits, **kw)
    if dfmax is not None or pmax is not None:
        res = _truncate_path(res, dfmax, pmax)
    return res


def enet_path(X, y, *, alpha: float = 1.0, **kw) -> PathResult:
    """Elastic-Net path (reference: src/Enet.cpp, R/40_admm_enet.R)."""
    return lasso_path(X, y, alpha=alpha, _enet_scale=True, **kw)


def adaptive_lasso_path(X, y, *, gamma: float = 1.0, init="auto",
                        init_ridge: float = 1e-3, weights=None,
                        **kw) -> PathResult:
    """The adaptive lasso (Zou 2006): a two-stage path whose penalty is
    rescaled per coordinate by ``1/|b_init|^gamma``.

    Stage 1 fits ``b_init``: OLS when n > p, a ridge fit with penalty
    ``init_ridge * max|X'y|/n`` otherwise, or ``init=`` an explicit (p,)
    vector; it runs in float64 where ``X`` lives (``device`` for numpy
    input).  Stage 2 is ``lasso_path(penalty_factor=1/|b_init|^gamma)``;
    every ``lasso_path`` keyword passes through."""
    n, p = X.shape if hasattr(X, "shape") else np.shape(X)
    if isinstance(init, str):
        if init not in ("auto", "ols", "ridge"):
            raise ValueError("init must be 'auto', 'ols', 'ridge' or "
                             "a coefficient vector")
        Xd = _as_tensor(X, torch.float64, kw.get("device", "cuda"))
        yd = _as_tensor(y, torch.float64, Xd.device).reshape(-1)
        wn = (torch.ones(n, dtype=torch.float64, device=Xd.device)
              if weights is None
              else _as_tensor(weights, torch.float64, Xd.device).reshape(-1))
        sw = torch.sqrt(wn * n / wn.sum())
        Xc = Xd - (wn @ Xd) / wn.sum()
        yc = yd - (wn @ yd) / wn.sum()
        Xw, yw = Xc * sw[:, None], yc * sw
        use_ols = init == "ols" or (init == "auto" and n > p)
        if use_ols and n <= p:
            raise ValueError("init='ols' needs n > p; use 'ridge'")
        lam_r = 0.0 if use_ols else (
            init_ridge * float(torch.abs(Xw.mT @ yw).max()) / n)
        eye = torch.eye(p, dtype=torch.float64, device=Xd.device)
        b_init = torch.linalg.solve(Xw.mT @ Xw + n * lam_r * eye,
                                    Xw.mT @ yw).cpu().numpy()
    else:
        b_init = np.asarray(init, np.float64).ravel()
        if b_init.shape != (p,):
            raise ValueError("init must have one entry per column of x")
    # A zero init coordinate gets an (effectively) infinite penalty: a
    # huge finite factor, so the grid stays finite.
    a = np.abs(b_init) ** float(gamma)
    pf = np.where(a > 1e-12, 1.0 / np.maximum(a, 1e-12), 1e12)
    return lasso_path(X, y, penalty_factor=pf, weights=weights, **kw)
