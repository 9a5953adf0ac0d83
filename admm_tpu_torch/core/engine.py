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
  :mod:`admm_tpu_torch.kernels` are what remove that sync); on a CUDA
  device, for hooks that declare themselves capturable
  (``ProblemOps.graph_safe``), a single solve instead runs chunks of
  ``_CHUNK`` guarded iterations, each one replay of a CUDA graph, with one
  host read a chunk (:func:`_chunked`); ``niter``, the iterates and rho are
  the op-by-op loop's, to the bit;
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

import functools
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..diag import profile

BIG_RESID = 9999.0  # sentinel used by the reference for "not yet computed"

# Iterations queued on the device between two host reads of the stop flag
# on the graph route (one read per chunk; a finished solve runs up to
# ``_CHUNK - 1`` frozen iterations).  Measured on the H100 on the wide
# scan path, 1000 x 2000 x 100 lambdas: 4 beats 8 and 16 (PERF.md
# section 6).
_CHUNK = 4


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
    # Every hook is capturable in a CUDA graph: it reads nothing on the
    # host and runs no collective (:func:`_route`).
    graph_safe: bool = False


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


def _sqrt_dims(ops: ProblemOps):
    """``state -> (sqrt(dim_dual), sqrt(dim_main))`` as tensors in the
    state's dtype and on its device, built once per solver for each: a
    ``torch.tensor`` from the host is a synchronous copy, and a captured
    iteration may make none."""
    made = {}

    def sqrt_dims(state: ADMMState):
        key = (state.rho.dtype, state.rho.device)
        if key not in made:
            made[key] = tuple(
                torch.tensor(math.sqrt(d), dtype=key[0], device=key[1])
                for d in (ops.dim_dual, ops.dim_main))
        return made[key]
    return sqrt_dims


def _tolerances(ops: ProblemOps, sqrt_dims, state: ADMMState, eps_abs,
                eps_rel):
    sq_dual, sq_main = sqrt_dims(state)
    eps_pri = ops.eps_primal_scale(state) * eps_rel + sq_dual * eps_abs
    eps_dua = ops.eps_dual_scale(state) * eps_rel + sq_main * eps_abs
    return eps_pri, eps_dua


def _as_scalars(state: ADMMState, eps_abs, eps_rel):
    dtype, dev = state.rho.dtype, state.rho.device
    return (torch.as_tensor(eps_abs, dtype=dtype, device=dev),
            torch.as_tensor(eps_rel, dtype=dtype, device=dev))


def _count_loop(iterations, reads, niter, graphed: int = 0) -> None:
    """A host loop's counts, added once at its end: the iterations the
    device ran (frozen ones included), its reads of device values, the
    iterations its solves report (``niter``: a host int, or a tensor,
    which is kept only while recording), and of the device's iterations
    those a replayed CUDA graph ran."""
    profile.count("engine.iterations", iterations)
    profile.count("engine.host_reads", reads)
    profile.count("solve.iterations", niter)
    profile.count("engine.graphed_iterations", graphed)


def _count_single(it0: int, it: int, maxit) -> None:
    """The counts of a single solve's loop: ``it`` read once, then
    ``done`` before each iteration and once more unless ``maxit`` ended
    the loop."""
    _count_loop(it - it0, 1 + (it - it0) + (it < maxit), it)


def _run(body, state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
    """The host loop of a single solve: one ``done`` read per iteration.
    ``it`` advances by exactly one per body call, so it is tracked on the
    host after one initial read."""
    eps_abs, eps_rel = _as_scalars(state, eps_abs, eps_rel)
    it0 = it = int(state.it)
    while it < maxit and not bool(state.done):
        state = body(state, eps_abs, eps_rel)
        it += 1
    _count_single(it0, it, maxit)
    return state


def _route(state: ADMMState, ops: ProblemOps) -> str:
    """How a single solve's loop runs: "graph" (:func:`_chunked`) when the
    state is on a CUDA device and the hooks are capturable
    (``ops.graph_safe``: nothing in them reads the host or runs a
    collective); "eager" (:func:`_run`, one read of ``done`` an
    iteration) otherwise."""
    if ops.graph_safe and state.rho.device.type == "cuda":
        return "graph"
    return "eager"


def _clone(a):
    """A copy of a tensor, or of a tuple of them (None stays None)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*map(_clone, a))
    return a.clone()


@functools.lru_cache(maxsize=None)
def _side_stream(device: int) -> torch.cuda.Stream:
    """The one side stream of a device on which every chunk is warmed up
    and captured.  cuBLAS keeps a workspace (32 MiB on the H100) for each
    stream it has run on, so a new stream a capture would hold one more
    each, up to PyTorch's pool of 32 streams (1.1 GB on the wide path)."""
    return torch.cuda.Stream(device)


def _graphed(advance, chunk, *args):
    """``advance`` (one chunk, written back into its state and flag in
    place) as a CUDA graph: captured once, replayed per chunk, so a chunk
    costs one launch of the host's instead of some sixty to eighty per
    iteration.  The same kernels run in the same order on the same
    tensors, so the bits are the eager loop's.  A warm-up of ``chunk`` on
    copies of ``args``, on the side stream the capture then uses, sets up
    the libraries' handles first.  The graph holds no reference to the
    tensors it reads and writes: the caller keeps them alive as long as
    it replays."""
    side = _side_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chunk(*map(_clone, args))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        advance()
    return graph.replay


def _keep(active, old: ADMMState, new: ADMMState) -> ADMMState:
    """One guarded step: a state that was not active keeps its values (a
    field the step left as it was stays that tensor)."""
    return ADMMState(*(a if a is b else torch.where(active, b, a)
                       for a, b in zip(old, new)))


def _chunked(body):
    """The graph route of a single solve: ``run(state, maxit, eps_abs,
    eps_rel)``.

    The path's state lives in static tensors; each call copies its
    incoming state into them (a warm start, a refreshed ``aux``, a resumed
    checkpoint) and runs chunks of ``_CHUNK`` guarded iterations, written
    back in place: ``active = ~done & (it < maxit)`` keeps a finished
    state by ``torch.where``, so ``niter``, the iterates and rho are those
    of the loop that stops at once.  The host reads one flag a chunk.  On
    a CUDA device the chunk is captured as a CUDA graph (:func:`_graphed`)
    at the first call and replayed after, and captured again when the
    state's shapes, dtypes or None pattern, ``maxit`` or the tolerances
    change; elsewhere it runs op by op.  Returns copies, never the static
    tensors."""
    slot = {}

    def build(state: ADMMState, maxit, eps_abs, eps_rel):
        st = _clone(state)
        eps = _as_scalars(state, eps_abs, eps_rel)
        more = torch.zeros((), dtype=torch.bool, device=state.rho.device)

        def chunk(st, eps_abs, eps_rel):
            """``_CHUNK`` guarded iterations, then the flag "still
            running"."""
            for _ in range(_CHUNK):
                active = ~st.done & (st.it < maxit)
                st = _keep(active, st, body(st, eps_abs, eps_rel))
            return st, ~st.done & (st.it < maxit)

        def advance():
            new, flag = chunk(st, *eps)
            for s, t in zip(st, new):
                if s is not t:
                    s.copy_(t)
            more.copy_(flag)

        graphed = st.rho.device.type == "cuda"
        if graphed:
            advance = _graphed(advance, chunk, st, *eps)
        # The graph reads and writes st, eps and more in place: they live
        # as long as it does.
        slot.update(st=st, eps=eps, more=more, advance=advance,
                    graphed=graphed)

    def run(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        key = (tuple(None if t is None else (t.shape, t.dtype, t.device)
                     for t in state), maxit, float(eps_abs), float(eps_rel))
        if slot.get("key") != key:
            build(state, maxit, eps_abs, eps_rel)
            slot["key"] = key
        st, more, advance = slot["st"], slot["more"], slot["advance"]
        for s, t in zip(st, state):
            if s is not None:
                s.copy_(t)
        chunks = 1
        advance()
        while bool(more):       # the one host read of each chunk
            advance()
            chunks += 1
        out = _clone(st)
        _count_loop(chunks * _CHUNK, chunks, out.it,
                    chunks * _CHUNK if slot["graphed"] else 0)
        return out

    return run


def _solver(body, ops: ProblemOps):
    """An engine's ``solve``: the graph route where :func:`_route` allows
    it, the op-by-op loop otherwise."""
    chunked = _chunked(body)

    def solve(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        if _route(state, ops) == "graph":
            with torch.cuda.device(state.rho.device):
                return chunked(state, maxit, eps_abs, eps_rel)
        return _run(body, state, maxit, eps_abs, eps_rel)

    solve.body = body
    return solve


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
        it0 = it = int(state.it)
        while it < maxit and not bool(state.done):
            idx = torch.clamp(state.it, max=trace_len - 1).long().reshape(1)
            state = body(state, eps_abs, eps_rel)
            buf.index_copy_(0, idx, _trace_row(state).reshape(1, 5))
            it += 1
        _count_single(it0, it, maxit)
        return state, buf

    return solve_traced


def make_admm_solver(ops: ProblemOps, *, adapt_rho: bool = True,
                     rho_start_iter: int = 3):
    """Vanilla ADMM engine (reference: src/ADMMBase.h:192-216).

    Iteration: x-update -> z-update -> dual ascent ``y += rho r`` ->
    convergence test -> adaptive rho (after ``rho_start_iter``).  The
    returned ``state.it`` is the reference's ``niter``.
    """
    sqrt_dims = _sqrt_dims(ops)

    def body(state: ADMMState, eps_abs, eps_rel) -> ADMMState:
        eps_pri, eps_dua = _tolerances(ops, sqrt_dims, state, eps_abs,
                                       eps_rel)
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

    return _solver(body, ops)


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
    sqrt_dims = _sqrt_dims(ops)

    def body(state: ADMMState, eps_abs, eps_rel) -> ADMMState:
        old_z, old_y = state.z, state.y
        eps_pri, eps_dua = _tolerances(ops, sqrt_dims, state, eps_abs,
                                       eps_rel)
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

    return _solver(body, ops)


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
        iterations = 0
        while bool(torch.any(~states.done & (states.it < maxit))):
            states = _freeze(states, body(states, eps_abs, eps_rel))
            iterations += 1
        _count_loop(iterations, iterations + 1, states.it)
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
        iterations = 0
        while bool(torch.any(~states.done & (states.it < maxit))):
            idx = torch.clamp(states.it, max=trace_len - 1).long()
            active = ~states.done
            states = _freeze(states, body(states, eps_abs, eps_rel))
            buf[lanes, idx] = torch.where(active[:, None],
                                          _trace_row(states),
                                          buf[lanes, idx])
            iterations += 1
        _count_loop(iterations, iterations + 1, states.it)
        return states, buf

    return solve_batched_traced
