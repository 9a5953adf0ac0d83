"""Generic ADMM / accelerated (fast) ADMM iteration engines.

PyTorch counterpart of ``admm_tpu/core/engine.py`` (reference:
src/ADMMBase.h:13-221 for vanilla ADMM with adaptive rho,
src/FADMMBase.h:17-270 for the Goldstein et al. 2014 accelerated variant
with restart).  The design is the same — an immutable state
(:class:`ADMMState`, a ``NamedTuple`` of tensors), a :class:`ProblemOps`
bundle of pure functions per model, and engine factories returning
``solve(state, maxit, eps_abs, eps_rel)`` — with the loops written out:

* ``lax.while_loop`` becomes one host loop (:func:`_host_loop`), shared
  by the single, batched and traced solves and by consensus
  (:mod:`admm_tpu_torch.parallel.consensus`).  Op by op it reads the
  host once an iteration, so ``it`` is exact (the CUDA path kernels in
  :mod:`admm_tpu_torch.kernels` are what remove that sync); on a CUDA
  device, for hooks that declare themselves capturable
  (``ProblemOps.graph_safe``), it runs groups of ``_CHUNK`` guarded
  iterations instead, each one replay of a CUDA graph, with one host
  read a group; ``niter``, the iterates, rho and the trace rows are the
  op-by-op loop's, to the bit;
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
# on the graph route (one read per group; a finished solve runs up to
# ``_CHUNK - 1`` frozen iterations).  Measured on the H100 (PERF.md
# section 6): 4 beats 8 and 16 on the engine's wide scan path, 1000 x
# 2000 x 100 lambdas, and 1, 2, 8 and 16 on consensus.
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


def _route(device, graph_safe: bool, mesh=None) -> str:
    """How a host loop runs: "graph" (groups of ``_CHUNK`` guarded
    iterations, each one replay of a CUDA graph) on a CUDA device when
    every hook is capturable (``graph_safe``: nothing in them reads the
    host or runs a collective) and so is the mesh
    (:attr:`~admm_tpu_torch.parallel.mesh.Mesh.capturable`: its local
    positions on one device, and no collective or NCCL's); "eager" (op by
    op, one host read an iteration) otherwise: gloo's collectives run on
    the host, and a graph captures the current device's work only."""
    if (graph_safe and torch.device(device).type == "cuda"
            and (mesh is None or mesh.capturable)):
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


def _keep(active, old, new):
    """One guarded step of any state ``NamedTuple`` (:class:`ADMMState`,
    the consensus state): where ``active`` is False the old values stay.
    A per-lane ``active`` broadcasts over each field's trailing axes; a
    field the step left as it was stays that tensor, and None stays
    None."""
    def keep(a, b):
        if a is b:
            return a
        act = active.reshape(active.shape + (1,) * (b.dim() - active.dim()))
        return torch.where(act, b, a)
    return type(old)(*map(keep, old, new))


def _active(state, maxit):
    """``(active, running)``: the lanes that step, and the loop's flag
    (some lane is neither done nor at ``maxit``).  A lane steps while it
    is not done and the loop runs, as in the JAX package's batched loop:
    lanes that are not done move in step, whatever their ``it``.  A
    single solve (0-d) needs no reduction."""
    free = ~state.done
    run = free & (state.it < maxit)
    if run.dim() == 0:
        return run, run
    running = torch.any(run)
    return free & running, running


def _trace_row(state) -> torch.Tensor:
    """One trace row per lane, ``(..., 5)``: (eps_pri, r_pri, eps_dua,
    r_dua, rho)."""
    return torch.stack([state.eps_pri, state.r_pri, state.eps_dua,
                        state.r_dua, state.rho], dim=-1)


def _step(body, state, eps, active, buf):
    """One iteration: ``body``, each lane's trace row into ``buf`` (or
    None) at ``min(it, trace_len - 1)``, and the guard ``active`` (None:
    every lane steps, unguarded)."""
    new = body(state, *eps)
    if buf is not None:
        buf = buf.view(-1, *buf.shape[-2:])          # (lanes, trace_len, 5)
        idx = torch.clamp(state.it, max=buf.shape[1] - 1).long()
        idx = idx.reshape(-1, 1, 1).expand(-1, 1, 5)
        row = _trace_row(new).reshape(-1, 1, 5)
        if active is not None:
            row = torch.where(active.reshape(-1, 1, 1), row,
                              buf.gather(1, idx))
        buf.scatter_(1, idx, row)
    return new if active is None else _keep(active, state, new)


def _host_loop(body, graph_safe: bool, mesh=None):
    """The one host loop of the engines and of consensus: ``run(state,
    maxit, eps_abs, eps_rel, trace_len=None) -> (state, trace)`` runs
    ``body(state, eps_abs, eps_rel)`` until no lane is both unfinished and
    under ``maxit``, stepping the lanes :func:`_active` names, so a lane's
    ``it`` is its ``niter``.  With ``trace_len`` each lane records its row
    at ``min(it, trace_len - 1)`` of a NaN buffer (``state.rho.shape +
    (trace_len, 5)``) on every step it takes.

    The route (:func:`_route`) sets how often the host reads:

    * "eager": one read an iteration.  A single solve (0-d ``done``)
      takes no guard and tracks ``it`` on the host after one read; lanes
      read the flag "still running" and step under the guard.
    * "graph": the state lives in static tensors, into which each call
      copies its incoming state (a warm start, a refreshed ``aux``, a
      resumed checkpoint) but for the fields that are the last call's
      answer; groups of ``_CHUNK`` guarded iterations write it back in
      place, and the host reads the flag once a group, so a finished
      solve runs up to ``_CHUNK - 1`` frozen iterations and ``niter``,
      the iterates and the trace rows stay those of the eager route.  On
      a CUDA device the group is captured as a CUDA graph
      (:func:`_graphed`) at the first call and replayed after, captured
      again when the state's shapes, dtypes or None pattern, ``maxit``,
      the tolerances or ``trace_len`` change; elsewhere (the CPU tests)
      it runs op by op.  Returns copies of the fields the body moves,
      never the static tensors.

    Callers treat a returned state as immutable, as the engines' states
    are: a new state is built out of place (``_replace``,
    :func:`warm_start`), never written in place (no ``st.it.zero_()``).
    The graph route relies on it: a field that is the very tensor the
    last call returned is not copied in again, and a field the body
    never moves comes back as the caller's own tensor.
    """
    slot = {}

    def trace_buffer(state, trace_len):
        return None if trace_len is None else torch.full(
            state.rho.shape + (trace_len, 5), float("nan"),
            dtype=state.rho.dtype, device=state.rho.device)

    def eager(state, maxit, eps, buf):
        if state.done.dim() == 0:
            # ``it`` advances by exactly one a step: read once, then
            # ``done`` before each step and once more unless maxit ends.
            it0 = it = int(state.it)
            while it < maxit and not bool(state.done):
                state = _step(body, state, eps, None, buf)
                it += 1
            _count_loop(it - it0, 1 + (it - it0) + (it < maxit), it)
            return state
        steps = 0
        while True:
            active, running = _active(state, maxit)
            if not bool(running):
                break
            state = _step(body, state, eps, active, buf)
            steps += 1
        _count_loop(steps, steps + 1, state.it)
        return state

    def build(state, maxit, eps, buf):
        st = _clone(state)
        more = torch.zeros((), dtype=torch.bool, device=state.rho.device)

        def chunk(st, eps_abs, eps_rel, buf):
            """``_CHUNK`` guarded iterations, then the flag "still
            running"."""
            for _ in range(_CHUNK):
                st = _step(body, st, (eps_abs, eps_rel),
                           _active(st, maxit)[0], buf)
            return st, _active(st, maxit)[1]

        def advance():
            new, flag = chunk(st, *eps, buf)
            # The fields the body moves (on the card, read at capture).
            slot["moving"] = [s is not t for s, t in zip(st, new)]
            for s, t in zip(st, new):
                if s is not t:
                    s.copy_(t)
            more.copy_(flag)

        graphed = st.rho.device.type == "cuda"
        if graphed:
            if mesh is not None:
                mesh.warm()
            advance = _graphed(advance, chunk, st, *eps, buf)
        # The graph reads and writes st, eps, buf and more in place: they
        # live as long as it does.
        slot.update(st=st, eps=eps, buf=buf, more=more, advance=advance,
                    graphed=graphed, out=(None,) * len(st))

    def chunked(state, maxit, eps_abs, eps_rel, trace_len):
        key = (tuple(None if t is None else (t.shape, t.dtype, t.device)
                     for t in state), maxit, float(eps_abs), float(eps_rel),
               trace_len)
        if slot.get("key") != key:
            build(state, maxit, _as_scalars(state, eps_abs, eps_rel),
                  trace_buffer(state, trace_len))
            slot["key"] = key
        st, buf, more, advance = (slot[k] for k in
                                  ("st", "buf", "more", "advance"))
        # The state is immutable: a field that is the last call's answer
        # is in place already.
        for s, t, last in zip(st, state, slot["out"]):
            if s is not None and t is not last:
                s.copy_(t)
        if buf is not None:
            buf.fill_(float("nan"))
        groups = 1
        advance()
        while bool(more):       # the one host read of each group
            advance()
            groups += 1
        # A field the body never moves keeps the caller's tensor.
        out = type(st)(*(_clone(s) if m else t for s, t, m in
                         zip(st, state, slot["moving"])))
        slot["out"] = out
        _count_loop(groups * _CHUNK, groups, out.it,
                    groups * _CHUNK if slot["graphed"] else 0)
        return out, _clone(buf)

    def run(state, maxit, eps_abs, eps_rel, trace_len=None):
        dev = state.rho.device
        if _route(dev, graph_safe, mesh) == "eager":
            buf = trace_buffer(state, trace_len)
            return eager(state, maxit, _as_scalars(state, eps_abs, eps_rel),
                         buf), buf
        # The capture and the replays on the state's device (none on the
        # CPU, where the group runs op by op).
        with torch.cuda.device(dev if dev.type == "cuda" else -1):
            return chunked(state, maxit, eps_abs, eps_rel, trace_len)

    return run


def _solver(body, graph_safe: bool):
    """An engine's ``solve(state, maxit, eps_abs, eps_rel) -> state`` on
    its own :func:`_host_loop`, for one solve or a state of lanes alike;
    ``solve.body`` and ``solve.graph_safe`` let a wrapper build another
    loop on the same body."""
    run = _host_loop(body, graph_safe)

    def solve(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        return run(state, maxit, eps_abs, eps_rel)[0]

    solve.body, solve.graph_safe = body, graph_safe
    return solve


def make_traced_solve(solve, trace_len: int):
    """Wrap an engine's ``solve`` so a per-iteration residual trace is
    recorded (counterpart of ``admm_tpu.core.engine.make_traced_solve``
    and, for a state of lanes, of ``make_batched_traced_solve``).

    The reference has residual-table printers wired into its engines but
    commented out of the loops (reference: src/ADMMBase.h:111-146, call
    sites :196,204,213).  Here each lane writes ``(eps_primal,
    resid_primal, eps_dual, resid_dual, rho)`` at row ``min(it, trace_len
    - 1)`` of a NaN buffer on the state's device, in its dtype, on every
    step it takes, through a device index: the host loop reads nothing
    more.  Rows past convergence stay NaN, so a lane's count of recorded
    rows is its ``niter`` (up to ``trace_len``); iterations past
    ``trace_len`` overwrite the last row.

    Returns ``solve_traced(state, maxit, eps_abs, eps_rel) -> (state,
    buffer)``, the buffer ``(trace_len, 5)`` for one solve and ``(k,
    trace_len, 5)`` for k lanes.
    """
    run = _host_loop(solve.body, solve.graph_safe)

    def solve_traced(state: ADMMState, maxit, eps_abs, eps_rel):
        return run(state, maxit, eps_abs, eps_rel, trace_len)

    return solve_traced


make_batched_traced_solve = make_traced_solve


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

    return _solver(body, ops.graph_safe)


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

    return _solver(body, ops.graph_safe)


def make_batched_solver(solve):
    """Batched-lane variant of an engine: one lane per lambda.

    The state carries a leading lane axis; every iteration runs the
    engine body on all lanes at once and lanes that have converged are
    frozen, so their ``it`` is the per-lambda iteration count.  The loop
    ends when no lane is both unconverged and under ``maxit``.  The same
    :func:`_host_loop` as the single solve, with its own capture.
    """
    return _solver(solve.body, solve.graph_safe)
