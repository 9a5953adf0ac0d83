"""Generic ADMM / accelerated (fast) ADMM iteration engines.

PyTorch counterpart of ``admm_tpu/core/engine.py`` (reference:
src/ADMMBase.h:13-221 for vanilla ADMM with adaptive rho,
src/FADMMBase.h:17-270 for the Goldstein et al. 2014 accelerated variant
with restart).  The design is the same — an immutable state
(:class:`ADMMState`, a ``NamedTuple`` of tensors), a :class:`ProblemOps`
bundle of pure functions per model, and engine factories returning
``solve(state, maxit, eps_abs, eps_rel)`` — with the loops written out:

* ``lax.while_loop`` becomes a Python loop that reads ``done`` on the host
  once per iteration, so ``it`` is exact (the CUDA path kernels in
  :mod:`admm_tpu_torch.kernels` are what remove that sync);
* ``vmap`` becomes an explicit leading lane axis: iterates are
  ``(..., dim)`` and per-lane scalars ``(...)``, and every reduction runs
  over the last axis, so one body serves a single lambda and a batch of
  lanes alike.

Stopping rule (Boyd et al. 2011, section 3.3; reference:
src/ADMMBase.h:49-83)::

    eps_primal = sqrt(dim_dual) * eps_abs + eps_rel * max(||Ax||,||Bz||,||c||)
    eps_dual   = sqrt(dim_main) * eps_abs + eps_rel * ||A'y||
    converged  = ||r_primal|| < eps_primal  and  rho*||A'B dz|| < eps_dual
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

BIG_RESID = 9999.0  # sentinel used by the reference for "not yet computed"


class ADMMState(NamedTuple):
    """Immutable solver state (reference: src/FADMMBase.h:31-36).

    ``x``/``z``/``y`` are the primal, auxiliary and dual iterates;
    ``adj_z``/``adj_y``/``adj_a``/``adj_c`` the accelerated engine's
    extrapolation state; ``aux`` model-specific caches (the wide Lasso's
    ``cache_Ax``, reference: src/ADMMLassoWide.h:46).  Scalars are 0-d
    tensors, or ``(k,)`` with a leading lane axis.
    """

    x: Any
    z: Any
    y: Any
    adj_z: Any
    adj_y: Any
    aux: Any
    adj_a: torch.Tensor
    adj_c: torch.Tensor
    rho: torch.Tensor
    lam: torch.Tensor
    eps_pri: torch.Tensor
    eps_dua: torch.Tensor
    r_pri: torch.Tensor
    r_dua: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


class ProblemOps(NamedTuple):
    """Pure-function hooks describing one ADMM model (the virtual methods
    of ``ADMMBase``/``FADMMBase``, reference: src/ADMMBase.h:35-47).

    Each takes the current :class:`ADMMState` (plus fresh iterates where
    noted) and must accept a leading lane axis.
    """

    # x_new = argmin_x L_rho(x, z, y)
    next_x: Callable[[ADMMState], Any]
    # (z_new, aux_new) given the fresh x
    next_z: Callable[[ADMMState, Any], Any]
    # r = A x_new + B z_new - c
    primal_residual: Callable[[ADMMState, Any, Any, Any], torch.Tensor]
    # max(||Ax||, ||Bz||, ||c||) with the pre-update iterates
    eps_primal_scale: Callable[[ADMMState], torch.Tensor]
    # ||A'y|| with the pre-update dual
    eps_dual_scale: Callable[[ADMMState], torch.Tensor]
    # rho * ||A'B (z_new - z_old)||
    dual_residual: Callable[[ADMMState, Any], torch.Tensor]
    # ||B (z_new - adj_z)||^2 (accelerated engine only; may be None)
    combined_extra: Optional[Callable[[ADMMState, Any], torch.Tensor]]
    dim_main: int
    dim_dual: int


def col(s: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar as a column that broadcasts against ``(..., dim)``."""
    return s.unsqueeze(-1)


def make_state(x, z, y, rho, lam, *, aux=None, adj_z=None, adj_y=None,
               dtype=None) -> ADMMState:
    """Cold-start state: given iterates, sentinel residuals
    (reference: src/ADMMLassoTall.h:179-216)."""
    if dtype is None:
        dtype = x.dtype
    dev = x.device
    f = lambda s: torch.as_tensor(s, dtype=dtype, device=dev)
    return ADMMState(
        x=x, z=z, y=y,
        adj_z=z if adj_z is None else adj_z,
        adj_y=y if adj_y is None else adj_y,
        aux=aux,
        adj_a=f(1.0), adj_c=f(BIG_RESID),
        rho=f(rho), lam=f(lam),
        eps_pri=f(0.0), eps_dua=f(0.0),
        r_pri=f(BIG_RESID), r_dua=f(BIG_RESID),
        it=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
    )


def warm_start(state: ADMMState, lam) -> ADMMState:
    """Re-arm the solver for the next lambda, keeping x, z, y and rho
    (reference: src/ADMMLassoTall.h:219-230).

    As in the JAX package, the accelerated engine's momentum is
    re-synchronised to the warm iterates (adj_z = z, adj_y = y, a = 1,
    c = sentinel) instead of being carried: a converged solve leaves
    ``adj_c ~ 0``, which would pin the next lambda in permanent restart
    mode with stale extrapolation points and can satisfy the Boyd test
    falsely on a period-2 oscillation.

    The scalars take the shape of ``rho``: 0-d for one solve, ``(T,)``
    for a state with a leading lane axis (every lane at ``lam``).
    """
    rho = state.rho
    f = lambda s: torch.full_like(rho, s)
    return state._replace(
        lam=torch.as_tensor(lam, dtype=rho.dtype, device=rho.device)
        .expand(rho.shape).contiguous(),
        adj_z=state.z,
        adj_y=state.y,
        adj_a=f(1.0),
        adj_c=f(BIG_RESID),
        eps_pri=f(0.0),
        eps_dua=f(0.0),
        r_pri=f(BIG_RESID),
        r_dua=f(BIG_RESID),
        it=torch.zeros_like(state.it),
        done=torch.zeros_like(state.done),
    )


def _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua):
    """The reference's adaptive-rho ladder (reference: src/ADMMBase.h:85-109):
    x2 / :2 when one scaled residual dominates by 10x, then a 1.2 nudge
    toward whichever residual has already converged."""
    ratio_p = r_pri / eps_pri
    ratio_d = r_dua / eps_dua
    rho = torch.where(ratio_p > 10.0 * ratio_d, rho * 2.0, rho)
    rho = torch.where(ratio_d > 10.0 * ratio_p, rho * 0.5, rho)
    rho = torch.where(r_pri < eps_pri, rho / 1.2, rho)
    rho = torch.where(r_dua < eps_dua, rho * 1.2, rho)
    return rho


def _tolerances(ops: ProblemOps, state: ADMMState, eps_abs, eps_rel):
    dtype, dev = state.rho.dtype, state.rho.device
    sq_dual = torch.tensor(math.sqrt(ops.dim_dual), dtype=dtype, device=dev)
    sq_main = torch.tensor(math.sqrt(ops.dim_main), dtype=dtype, device=dev)
    eps_pri = ops.eps_primal_scale(state) * eps_rel + sq_dual * eps_abs
    eps_dua = ops.eps_dual_scale(state) * eps_rel + sq_main * eps_abs
    return eps_pri, eps_dua


def _as_scalars(state: ADMMState, eps_abs, eps_rel):
    dtype, dev = state.rho.dtype, state.rho.device
    return (torch.as_tensor(eps_abs, dtype=dtype, device=dev),
            torch.as_tensor(eps_rel, dtype=dtype, device=dev))


def _run(body, state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
    """The host loop of a single solve: one ``done`` read per iteration.
    ``it`` advances by exactly one per body call, so it is tracked on the
    host after one initial read."""
    eps_abs, eps_rel = _as_scalars(state, eps_abs, eps_rel)
    it = int(state.it)
    while it < maxit and not bool(state.done):
        state = body(state, eps_abs, eps_rel)
        it += 1
    return state


def _trace_row(state: ADMMState) -> torch.Tensor:
    """One trace row per lane, ``(..., 5)``: (eps_pri, r_pri, eps_dua,
    r_dua, rho)."""
    return torch.stack([state.eps_pri, state.r_pri, state.eps_dua,
                        state.r_dua, state.rho], dim=-1)


def make_traced_solve(solve, trace_len: int):
    """Wrap an engine's ``solve`` so a per-iteration residual trace is
    recorded (counterpart of ``admm_tpu.core.engine.make_traced_solve``).

    The reference has residual-table printers wired into its engines but
    commented out of the loops (reference: src/ADMMBase.h:111-146, call
    sites :196,204,213).  Here a preallocated ``(trace_len, 5)`` buffer of
    NaN on the state's device, in its dtype, takes ``(eps_primal,
    resid_primal, eps_dual, resid_dual, rho)`` at row ``min(it, trace_len
    - 1)`` each iteration, written through a device index: the host loop
    keeps its one ``done`` read per iteration and reads nothing else.
    Rows past convergence stay NaN; iterations past ``trace_len``
    overwrite the last row.

    Returns ``solve_traced(state, maxit, eps_abs, eps_rel) -> (state,
    buffer)``.
    """
    body = solve.body

    def solve_traced(state: ADMMState, maxit, eps_abs, eps_rel):
        eps_abs, eps_rel = _as_scalars(state, eps_abs, eps_rel)
        buf = torch.full((trace_len, 5), float("nan"),
                         dtype=state.rho.dtype, device=state.rho.device)
        it = int(state.it)
        while it < maxit and not bool(state.done):
            idx = torch.clamp(state.it, max=trace_len - 1).long().reshape(1)
            state = body(state, eps_abs, eps_rel)
            buf.index_copy_(0, idx, _trace_row(state).reshape(1, 5))
            it += 1
        return state, buf

    return solve_traced


def make_admm_solver(ops: ProblemOps, *, adapt_rho: bool = True,
                     rho_start_iter: int = 3):
    """Vanilla ADMM engine (reference: src/ADMMBase.h:192-216).

    Iteration: x-update -> z-update -> dual ascent ``y += rho r`` ->
    convergence test -> adaptive rho (after ``rho_start_iter``).  The
    returned ``state.it`` is the reference's ``niter``.
    """

    def body(state: ADMMState, eps_abs, eps_rel) -> ADMMState:
        eps_pri, eps_dua = _tolerances(ops, state, eps_abs, eps_rel)
        x_new = ops.next_x(state)
        z_new, aux_new = ops.next_z(state, x_new)
        r_dua = ops.dual_residual(state, z_new)
        r = ops.primal_residual(state, x_new, z_new, aux_new)
        r_pri = torch.sqrt(torch.sum(r * r, dim=-1))
        y_new = state.y + col(state.rho) * r
        done = (r_pri < eps_pri) & (r_dua < eps_dua)
        rho = state.rho
        if adapt_rho:
            rho_adapted = _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua)
            rho = torch.where(done | (state.it <= rho_start_iter), rho,
                              rho_adapted)
        return state._replace(
            x=x_new, z=z_new, y=y_new, aux=aux_new, rho=rho,
            eps_pri=eps_pri, eps_dua=eps_dua, r_pri=r_pri, r_dua=r_dua,
            it=state.it + 1, done=done,
        )

    def solve(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        return _run(body, state, maxit, eps_abs, eps_rel)

    solve.body = body
    return solve


def make_fadmm_solver(ops: ProblemOps, *, adapt_rho: bool = False,
                      rho_start_iter: int = 5, restart_tol: float = 0.999):
    """Accelerated (fast) ADMM with restart, Goldstein et al. 2014
    (reference: src/FADMMBase.h:219-265).

    The combined residual ``c = rho ||r||^2 + rho ||B(z - adj_z)||^2``
    gates Nesterov extrapolation of (z, y); when it fails to decrease by
    ``restart_tol`` the momentum restarts.  The dual ascent uses the
    extrapolated multiplier: ``y = adj_y + rho r``.
    """
    if ops.combined_extra is None:
        raise ValueError("FADMM needs combined_extra")

    def body(state: ADMMState, eps_abs, eps_rel) -> ADMMState:
        old_z, old_y = state.z, state.y
        eps_pri, eps_dua = _tolerances(ops, state, eps_abs, eps_rel)
        x_new = ops.next_x(state)
        z_new, aux_new = ops.next_z(state, x_new)
        r_dua = ops.dual_residual(state, z_new)
        r = ops.primal_residual(state, x_new, z_new, aux_new)
        r_pri = torch.sqrt(torch.sum(r * r, dim=-1))
        y_new = state.adj_y + col(state.rho) * r
        done = (r_pri < eps_pri) & (r_dua < eps_dua)

        # Acceleration / restart (reference: src/FADMMBase.h:240-256).
        c_new = state.rho * r_pri * r_pri \
            + state.rho * ops.combined_extra(state, z_new)
        accelerate = c_new < restart_tol * state.adj_c
        a_acc = 0.5 + 0.5 * torch.sqrt(1.0 + 4.0 * state.adj_a * state.adj_a)
        ratio = col((state.adj_a - 1.0) / a_acc)
        acc_v = col(accelerate)
        adj_z = torch.where(acc_v, (1.0 + ratio) * z_new - ratio * old_z,
                            old_z)
        adj_y = torch.where(acc_v, (1.0 + ratio) * y_new - ratio * old_y,
                            old_y)
        adj_a = torch.where(accelerate, a_acc, torch.ones_like(a_acc))
        adj_c = torch.where(accelerate, c_new, state.adj_c / restart_tol)

        # The reference breaks out before applying acceleration on the
        # converging iteration: hold adj_* so warm starts see the same.
        adj_z = torch.where(col(done), state.adj_z, adj_z)
        adj_y = torch.where(col(done), state.adj_y, adj_y)
        adj_a = torch.where(done, state.adj_a, adj_a)
        adj_c = torch.where(done, state.adj_c, adj_c)

        rho = state.rho
        if adapt_rho:
            rho_adapted = _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua)
            rho = torch.where(done | (state.it <= rho_start_iter), rho,
                              rho_adapted)
        return state._replace(
            x=x_new, z=z_new, y=y_new, aux=aux_new,
            adj_z=adj_z, adj_y=adj_y, adj_a=adj_a, adj_c=adj_c, rho=rho,
            eps_pri=eps_pri, eps_dua=eps_dua, r_pri=r_pri, r_dua=r_dua,
            it=state.it + 1, done=done,
        )

    def solve(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        return _run(body, state, maxit, eps_abs, eps_rel)

    solve.body = body
    return solve


def make_batched_solver(solve):
    """Batched-lane variant of an engine: one lane per lambda.

    The state carries a leading lane axis; every iteration runs the
    engine body on all lanes at once and lanes that have converged are
    frozen, so their ``it`` is the per-lambda iteration count.  The loop
    ends when no lane is both unconverged and under ``maxit``.
    """
    body = solve.body

    def solve_batched(states: ADMMState, maxit, eps_abs, eps_rel):
        eps_abs, eps_rel = _as_scalars(states, eps_abs, eps_rel)
        while bool(torch.any(~states.done & (states.it < maxit))):
            states = _freeze(states, body(states, eps_abs, eps_rel))
        return states

    return solve_batched


def _freeze(old: ADMMState, new: ADMMState) -> ADMMState:
    """Lanes that were done before the step keep their state."""
    d = old.done

    def f(a, b):
        if a is None:
            return None
        return torch.where(d.reshape(d.shape + (1,) * (b.dim() - d.dim())),
                           a, b)
    return ADMMState(*(f(a, b) for a, b in zip(old, new)))


def make_batched_traced_solve(solve, trace_len: int):
    """Batched-lane engine with a PER-LANE residual trace (counterpart of
    ``admm_tpu.core.engine.make_batched_traced_solve``).

    Lane l records its own row at ``min(it_l, trace_len - 1)`` of a
    ``(k, trace_len, 5)`` buffer of NaN; lanes that were done before the
    step stop recording, exactly as they stop iterating, so a lane's count
    of recorded rows is its ``niter`` (up to ``trace_len``).  The rows are
    written by indexed assignment on the device.

    Returns ``solve_traced(states, maxit, eps_abs, eps_rel) -> (states,
    buffer)``.
    """
    body = solve.body

    def solve_batched_traced(states: ADMMState, maxit, eps_abs, eps_rel):
        eps_abs, eps_rel = _as_scalars(states, eps_abs, eps_rel)
        k = states.rho.shape[0]
        dev = states.rho.device
        buf = torch.full((k, trace_len, 5), float("nan"),
                         dtype=states.rho.dtype, device=dev)
        lanes = torch.arange(k, device=dev)
        while bool(torch.any(~states.done & (states.it < maxit))):
            idx = torch.clamp(states.it, max=trace_len - 1).long()
            active = ~states.done
            states = _freeze(states, body(states, eps_abs, eps_rel))
            buf[lanes, idx] = torch.where(active[:, None],
                                          _trace_row(states),
                                          buf[lanes, idx])
        return states, buf

    return solve_batched_traced
