"""Basis Pursuit solver: ``minimize ||x||_1  s.t.  A x = b`` with p > n
(counterpart of ``admm_tpu/models/bp.py``).

ADMM splitting (reference: src/ADMMBP.h:7-17)::

    minimize f(x) + g(z)   s.t.  x - z = 0
    f = indicator{A x = b},  g = ||.||_1

The x-update is the affine projection onto {x : Ax = b}::

    x = v - A'(AA')^{-1} A v + A'(AA')^{-1} b,   v = adj_z - adj_y/rho

(reference: src/ADMMBP.h:48-67); the z-update is a soft-threshold with
penalty 1/rho (reference: src/ADMMBP.h:84-88).  Accelerated FADMM with rho
fixed: the restart analysis (Goldstein et al. 2014) assumes a constant
penalty, and with the adaptive ladder the combined residual can cycle.
No standardization (reference: src/BP.cpp:24-35).

Two routes.  In float32, within the kernel's shared-memory rule, every
solve, a single signal included, is one launch of the batched BP kernel
(:mod:`admm_tpu_torch.kernels.bp`; its plain form on the CPU), one block
per signal, against A and the explicit ``(AA')^{-1}``.  Everything else
takes the generic engine with the cached ``K = (AA')^{-1} A``, two
products per iteration: ``x = v + AAAb - A'(K v)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.engine import (ProblemOps, col, make_batched_solver,
                           make_fadmm_solver, make_state, make_traced_solve)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..kernels import bp as bp_kernel
from ..linalg import chol_inverse, dot, tgram
from .lad import _f64_class_defaults
from ..parallel.mesh import is_sharded
from .lasso import _as_data, _as_tensor, _batched_cold_states


def _use_kernel_bp(n: int, p: int, dtype, A=None) -> bool:
    """BP kernel: float32, the port's dispatch bound ``8p + 4n <= 57600``
    (``kernels/bp.py::fits``), and all of A on one device (a
    column-sharded A takes the engine).  Any number of signals, one
    included."""
    return (dtype == torch.float32 and bp_kernel.fits(n, p)
            and not is_sharded(A))


class BPResult(NamedTuple):
    coef: torch.Tensor   # (p,) the sparse iterate z (reference: src/BP.cpp:37-43)
    niter: torch.Tensor  # int32
    # (trace_len, 5) per-iteration (eps_pri, r_pri, eps_dua, r_dua, rho)
    # when tracing was requested (admm_tpu_torch.diag.trace).
    trace: Optional[torch.Tensor] = None


def _bp_ops(A, K, n, p, aaab_of) -> ProblemOps:
    """``aaab_of(st)`` supplies the cached ``A'(AA')^{-1} b``: a closure
    constant for the single-signal solver, the lane state ``st.aux`` for
    the batched multi-signal solver; one factory for both."""
    def next_x(st):
        v = st.adj_z - st.adj_y / col(st.rho)
        return v + aaab_of(st) - dot(dot(v, K.mT), A)   # A'(K v), by lane

    def next_z(st, x_new):
        v = x_new + st.adj_y / col(st.rho)
        return soft_threshold(v, col(1.0 / st.rho)), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x), l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=p,
    )


def _bp_setup(A):
    """``(AA')^{-1}``, with the float32 jitter of the unregularised Gram."""
    jitter = 1e-6 if A.dtype == torch.float32 else 0.0
    return chol_inverse(tgram(A), jitter=jitter)


def _bp_fit_engine(A, b, rho, maxit, eps_abs, eps_rel, trace_len=None):
    """One signal through the generic FADMM engine, traced when
    ``trace_len`` is set."""
    n, p = A.shape
    Winv = _bp_setup(A)
    AAAb = dot(A.mT, dot(Winv, b))                # A'(AA')^-1 b
    # (AA')^-1 A, n x p; column-sharded like A.
    K = (A.map(lambda blk: dot(Winv, blk)) if is_sharded(A)
         else dot(Winv, A))
    solve = make_fadmm_solver(_bp_ops(A, K, n, p, lambda st: AAAb),
                              adapt_rho=False)
    zeros = torch.zeros((p,), dtype=A.dtype, device=A.device)
    st0 = make_state(zeros, zeros, zeros, rho, 0.0)
    if trace_len is None:
        st, buf = solve(st0, maxit, eps_abs, eps_rel), None
    else:
        st, buf = make_traced_solve(solve, trace_len)(st0, maxit, eps_abs,
                                                      eps_rel)
    return BPResult(coef=st.z, niter=st.it, trace=buf)


def _bp_fit(A, b, rho, maxit, eps_abs, eps_rel, trace_len=None):
    n, p = A.shape
    # A traced solve takes the engine, as in the JAX package.
    if trace_len is not None or not _use_kernel_bp(n, p, A.dtype, A):
        return _bp_fit_engine(A, b, rho, maxit, eps_abs, eps_rel, trace_len)
    # One signal is a batch of one lane: the kernel keeps the whole loop on
    # the device, where the engine reads ``done`` on the host every
    # iteration.
    res = _bp_fit_batch(A, b.reshape(1, n), rho, maxit, eps_abs, eps_rel)
    return BPResult(coef=res.coef[0], niter=res.niter[0])


def _bp_fit_batch(A, B, rho, maxit, eps_abs, eps_rel):
    n, p = A.shape
    m = B.shape[0]
    Winv = _bp_setup(A)
    K = dot(Winv, A)
    # (m, p) per-signal caches A'(AA')^{-1} b_i, one product for all.
    AAAB = dot(B, K)
    if _use_kernel_bp(n, p, A.dtype):
        z, niter = bp_kernel.bp_batch_solve(
            A.contiguous(), Winv.contiguous(), AAAB.contiguous(), rho,
            eps_abs, eps_rel, maxit)
        return BPResult(coef=z, niter=niter)
    solve = make_batched_solver(make_fadmm_solver(
        _bp_ops(A, K, n, p, lambda st: st.aux), adapt_rho=False))
    lam = torch.zeros((m,), dtype=A.dtype, device=A.device)
    st = _batched_cold_states(m, p, rho, lam)._replace(aux=AAAB)
    st = solve(st, maxit, eps_abs, eps_rel)
    return BPResult(coef=st.z, niter=st.it)


def bp_fit(A, b, *, maxit: int = 10000, eps_abs: Optional[float] = None,
           eps_rel: Optional[float] = None, rho: Optional[float] = None,
           trace_len: Optional[int] = None, data_mesh=None, dtype=None,
           device="cuda") -> BPResult:
    """Solve Basis Pursuit.

    Same arguments as ``admm_tpu.bp_fit``, plus ``device``: tensors stay
    on their own device, anything else goes to ``device``.  Requires
    p > n (validated by the builder API).

    ``dtype=None`` means ``torch.float32`` (the JAX package reads its
    global x64 flag here; torch has none), with eps 2e-5 and the BP
    kernel on the card; ``dtype=torch.float64`` is the explicit way to
    the reference's double precision and takes the engine with the
    reference's eps 1e-4.  rho defaults to 5.  ``trace_len`` records the
    per-iteration residual trace, on the engine (never the kernel).
    ``data_mesh`` shards A along its columns (the long axis p) over a
    mesh: AA' and ``A v`` are sums over the mesh, ``A'w`` is computed per
    block and gathered; the BP kernel holds all of A, so the engine runs.
    """
    dtype, eps_abs, eps_rel, rho = _f64_class_defaults(dtype, eps_abs,
                                                       eps_rel, rho)
    A = _as_data(A, dtype, device, data_mesh, dim=1)
    b = _as_tensor(b, dtype, A.device).reshape(-1)
    return _bp_fit(A, b, rho, maxit, eps_abs, eps_rel,
                   None if trace_len is None else int(trace_len))


def bp_fit_batch(A, B, *, maxit: int = 10000,
                 eps_abs: Optional[float] = None,
                 eps_rel: Optional[float] = None,
                 rho: Optional[float] = None, dtype=None,
                 device="cuda") -> BPResult:
    """Recover many sparse signals against one measurement matrix: all m
    right-hand sides share the one-time ``(AA')^{-1}`` and solve at once
    as lanes, the compressed-sensing serving workload.

    ``B`` is (m, n); returns ``coef`` (m, p) and ``niter`` (m,).
    ``dtype`` and ``device`` as in :func:`bp_fit`.
    """
    dtype, eps_abs, eps_rel, rho = _f64_class_defaults(dtype, eps_abs,
                                                       eps_rel, rho)
    A = _as_tensor(A, dtype, device)
    B = torch.atleast_2d(_as_tensor(B, dtype, A.device))
    return _bp_fit_batch(A, B, rho, maxit, eps_abs, eps_rel)
