"""LAD (least absolute deviations / median regression) solver
(counterpart of ``admm_tpu/models/lad.py``).

Model: ``minimize ||y - X beta||_1`` with n > p, optionally with an
intercept; data is always standardized (reference: src/LAD.cpp:34-35,
R/20_admm_lad.R:21-31).

ADMM formulation in range space (reference: src/ADMMLAD.h:7-29): with
``xx := X beta`` constrained to Range(X),

    minimize f(xx) + g(z)   s.t.  xx - z = y
    f = indicator{xx in Range(X)},  g = ||.||_1

so the x-update is the orthogonal projection onto Range(X),
``x = X (X'X)^{-1} X' v`` with ``v = y - adj_y/rho + adj_z`` (reference:
src/ADMMLAD.h:62-78), and the z-update is a soft-threshold with penalty
``1/rho`` (reference: src/ADMMLAD.h:94-98).  The accelerated FADMM engine
runs with rho fixed: Nesterov acceleration with the adaptive ladder breaks
the restart analysis's constant-penalty assumption and can cycle.

Two routes.  In float32, for the median (``tau == 0.5``) and n within the
kernel's shared-memory rule, the whole solve is one launch of the LAD
kernel (:mod:`admm_tpu_torch.kernels.lad`; its plain form on the CPU)
against the dense hat matrix, the reference's own n <= 2000 cache
(reference: src/ADMMLAD.h:182-203), built here as one product chain.
Everything else (float64, other quantiles, larger n) takes the generic
engine with the factored projection ``X ((X'X)^{-1} (X' v))``.

The final coefficients are recovered by one least-squares solve
``beta = (X'X)^{-1} X' (y - adj_y/rho + adj_z)``
(reference: src/ADMMLAD.h:220-225) and un-standardized.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.engine import (ProblemOps, col, make_fadmm_solver, make_state,
                           make_traced_solve)
from ..core.prox import l2norm, sqnorm
from ..data.standardize import recover, standardize
from ..diag import profile
from ..kernels import lad as lad_kernel
from ..linalg import chol_inverse, dot, gram
from ..parallel.mesh import blockwise, is_sharded
from .lasso import _as_data, _as_tensor


def _use_kernel_lad(n: int, dtype, tau: float, X=None) -> bool:
    """LAD kernel: float32, the symmetric (median) prox, n no larger than
    the kernel takes (``n <= kernels.lad.MAX_N``), and X on one device:
    the kernel iterates against all of the hat matrix."""
    return (dtype == torch.float32 and tau == 0.5 and lad_kernel.fits(n)
            and not is_sharded(X))


class LADResult(NamedTuple):
    beta0: torch.Tensor  # scalar intercept (0 when intercept=False)
    coef: torch.Tensor   # (p,) coefficients on the original scale
    niter: torch.Tensor  # int32
    # (trace_len, 5) per-iteration (eps_pri, r_pri, eps_dua, r_dua, rho)
    # when tracing was requested (admm_tpu_torch.diag.trace).
    trace: Optional[torch.Tensor] = None


def _asym_soft_threshold(v, t_pos, t_neg):
    """Prox of the asymmetric l1 ``w -> t_pos max(w, 0) + t_neg
    max(-w, 0)`` at unit rho: shifted shrinkage with a one-sided
    threshold per sign (the quantile-loss prox; the ordinary
    soft-threshold when t_pos == t_neg)."""
    return torch.where(v > t_pos, v - t_pos,
                       torch.where(v < -t_neg, v + t_neg,
                                   torch.zeros_like(v)))


def _lad_ops(Xs, ys, Ginv, ynorm, n, p, tau=0.5) -> ProblemOps:
    """``tau`` generalizes the z-prox to the quantile check loss: the
    solver state z is (fitted - y) = -residual, so the loss
    ``2 rho_tau(r) = 2 tau max(r,0) + 2(1-tau) max(-r,0)`` puts weight
    2(1-tau) on z > 0 and 2 tau on z < 0.  The factor 2 makes tau = 0.5
    exactly the reference's LAD (threshold 1/rho on both sides,
    reference: src/ADMMLAD.h:94-98): the same iterates, not just the
    same argmin."""
    def project(v):
        """Orthogonal projection onto Range(X): X (X'X)^-1 X' v."""
        return dot(Xs, dot(Ginv, dot(Xs.mT, v)))

    def next_x(st):
        return project(ys - st.adj_y / col(st.rho) + st.adj_z)

    def next_z(st, x_new):
        v = x_new - ys + st.adj_y / col(st.rho)
        return _asym_soft_threshold(v, col(2.0 * (1.0 - tau) / st.rho),
                                    col(2.0 * tau / st.rho)), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - ys - z,
        eps_primal_scale=lambda st: torch.maximum(
            torch.maximum(l2norm(st.x), l2norm(st.z)), ynorm),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=n, dim_dual=n,
    )


@profile.spanned("setup", part="gram")
def _lad_setup(X, y, intercept):
    """Standardized data with the free intercept column, the inverse Gram
    matrix and ``||ys||``: ``(Xa, ys, stats, Ginv, ynorm)``.

    Deliberate fix over the reference for ``intercept=True``, as in the
    JAX package: the reference mean-centers X and y and reconstructs
    ``beta0 = mean(y) - sum(coef * mean(x))`` (reference: src/LAD.cpp:34,
    src/DataStd.h:157), which forces the mean-based intercept, but the
    L1-optimal intercept is median-like.  Here the intercept is an
    unpenalized ones column inside the range-space projection, so it is
    optimized under the L1 loss itself; X is still centered and scaled for
    conditioning, which the free column absorbs exactly.
    """
    n = X.shape[0]
    # LAD always standardizes X (reference: src/LAD.cpp:34).
    Xs, ys, stats = standardize(X, y, standardize_x=True,
                                intercept=intercept)
    if intercept:
        Xa = blockwise(Xs, lambda b, sl: torch.cat(
            [torch.ones((b.shape[0], 1), dtype=b.dtype, device=b.device), b],
            dim=1))
    else:
        Xa = Xs
    # X'X is unregularised here; jitter guards float32 conditioning (the
    # reference relies on float64).
    jitter = 1e-6 if X.dtype == torch.float32 else 0.0
    Ginv = chol_inverse(gram(Xa), jitter=jitter)
    return Xa, ys, stats, Ginv, l2norm(ys)


@profile.spanned("setup", part="hat")
def _hat_matrix(Xa, Ginv):
    """The dense projection ``Xa (Xa'Xa)^-1 Xa'`` the kernel iterates
    against (reference: src/ADMMLAD.h:182-203)."""
    return dot(Xa, dot(Ginv, Xa.mT)).contiguous()


def _lad_fit(X, y, rho, maxit, eps_abs, eps_rel, *, intercept, tau=0.5,
             trace_len=None):
    n = X.shape[0]
    dtype, dev = X.dtype, X.device
    Xa, ys, stats, Ginv, ynorm = _lad_setup(X, y, intercept)
    # The kernel takes rho as a host number and ||ys|| as a device tensor:
    # nothing is read back from the card before its launch.
    rho_host = float(rho)
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)

    buf = None
    # A traced solve takes the engine, as in the JAX package.
    if trace_len is None and _use_kernel_lad(n, dtype, tau, X):
        adj_y, adj_z, niter = lad_kernel.lad_solve(
            _hat_matrix(Xa, Ginv), ys.contiguous(), rho_host, eps_abs,
            eps_rel, ynorm, maxit)
    else:
        ops = _lad_ops(Xa, ys, Ginv, ynorm, n, Xa.shape[1], tau=tau)
        solve = make_fadmm_solver(ops, adapt_rho=False)
        zeros = torch.zeros((n,), dtype=dtype, device=dev)
        st0 = make_state(zeros, zeros, zeros, rho, 0.0)
        if trace_len is None:
            st = solve(st0, maxit, eps_abs, eps_rel)
        else:
            st, buf = make_traced_solve(solve, trace_len)(st0, maxit,
                                                          eps_abs, eps_rel)
        adj_y, adj_z, niter = st.adj_y, st.adj_z, st.it

    # beta = (X'X)^-1 X' (y - adj_y/rho + adj_z)
    # (reference: src/ADMMLAD.h:220-225)
    coef_std = dot(Ginv, dot(Xa.mT, ys - adj_y / rho + adj_z))
    if intercept:
        a, slopes = coef_std[0], coef_std[1:]
        # ys = (y - mean_y)/scale_y, Xs = (X - mean_x)/scale_x:
        # y ~ mean_y + scale_y*a + sum_j coef_j (X_j - mean_x_j).
        coef = slopes / stats.scale_x * stats.scale_y
        beta0 = (stats.mean_y + stats.scale_y * a
                 - torch.sum(coef * stats.mean_x))
    else:
        beta0, coef = recover(stats, coef_std, standardize_x=True,
                              intercept=False)
    return LADResult(beta0=beta0, coef=coef, niter=niter, trace=buf)


def _f64_class_defaults(dtype, eps_abs, eps_rel, rho):
    """dtype, eps and rho defaults shared by LAD and BP.  ``dtype=None``
    is float32, the precision the kernels take; the reference's eps 1e-4
    is a float64 tolerance, and float32 tightens it to 2e-5, which
    restores the reference's published accuracy (the JAX package's
    measured sweep).  rho = 5 is the JAX package's measured default
    (1.5-5x fewer iterations than the reference's 1.0 at an equal or
    better objective); pass ``rho=1.0`` for the reference's literal one."""
    if dtype is None:
        dtype = torch.float32
    eps = 1e-4 if dtype == torch.float64 else 2e-5
    return (dtype, eps if eps_abs is None else eps_abs,
            eps if eps_rel is None else eps_rel, 5.0 if rho is None else rho)


def lad_fit(X, y, *, intercept: bool = True, maxit: int = 10000,
            eps_abs: Optional[float] = None, eps_rel: Optional[float] = None,
            rho: Optional[float] = None, trace_len: Optional[int] = None,
            data_mesh=None, dtype=None, device="cuda") -> LADResult:
    """Fit median regression by FADMM.

    Same arguments as ``admm_tpu.lad_fit``, plus ``device``: tensors stay
    on their own device, anything else goes to ``device``.  Requires
    n > p (validated by the builder API).

    ``dtype=None`` means ``torch.float32`` (the JAX package reads its
    global x64 flag here; torch has none), with eps 2e-5 and the LAD
    kernel on the card; ``dtype=torch.float64`` is the explicit way to
    the reference's double precision and takes the engine with the
    reference's eps 1e-4.  rho defaults to 5.  ``trace_len`` records the
    per-iteration residual trace, on the engine (never the kernel).
    ``data_mesh`` shards X's rows over a mesh: X'X and the engine's
    factored projection ``X Ginv X' v`` run per block (``X'v`` a sum over
    the mesh, ``X .`` gathered); the hat-matrix kernel needs all of H, so
    it does not run on a mesh.
    """
    dtype, eps_abs, eps_rel, rho = _f64_class_defaults(dtype, eps_abs,
                                                       eps_rel, rho)
    X = _as_data(X, dtype, device, data_mesh)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    return _lad_fit(X, y, rho, maxit, eps_abs, eps_rel, intercept=intercept,
                    trace_len=None if trace_len is None else int(trace_len))


def quantile_fit(X, y, *, tau: float = 0.5, intercept: bool = True,
                 maxit: int = 10000, eps_abs: Optional[float] = None,
                 eps_rel: Optional[float] = None,
                 rho: Optional[float] = None,
                 trace_len: Optional[int] = None, data_mesh=None,
                 dtype=None, device="cuda") -> LADResult:
    """Quantile regression: ``minimize sum_i rho_tau(y_i - x_i'b)`` with
    the check loss ``rho_tau(r) = r (tau - 1{r < 0})``, n > p.
    ``tau = 0.5`` reduces exactly to :func:`lad_fit`; other quantiles swap
    the z-prox for the asymmetric soft-threshold (see ``_lad_ops``) and
    take the engine.  Everything else (the range-space projection, the
    free quantile-optimal intercept, the defaults, ``dtype``, ``device``
    and ``data_mesh``) is shared with LAD.
    """
    if not 0.0 < tau < 1.0:
        raise ValueError("tau must be in (0, 1)")
    dtype, eps_abs, eps_rel, rho = _f64_class_defaults(dtype, eps_abs,
                                                       eps_rel, rho)
    X = _as_data(X, dtype, device, data_mesh)
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    if X.shape[0] <= X.shape[1]:
        raise ValueError("nrow(x) must be greater than ncol(x)")
    return _lad_fit(X, y, rho, maxit, eps_abs, eps_rel, intercept=intercept,
                    tau=float(tau),
                    trace_len=None if trace_len is None else int(trace_len))
