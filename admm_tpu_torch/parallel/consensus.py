"""Consensus (parallel) ADMM (counterpart of
``admm_tpu/parallel/consensus.py``).

Global-variable consensus over row blocks, the reference's one
distributed scheme (reference: src/PADMMBase.h:7-16)::

    minimize  sum_i f_i(x_i) + g(z)
    s.t.      x_i - z = 0   for every worker i

The reference ships it for the Lasso (reference: src/PADMMLasso.h) and
left a parallel Basis Pursuit unfinished (src/TODO/PADMMBP.h).  As in the
JAX package the engine is generic, one worker x-update hook plus one
master prox hook, and carries the Lasso, Elastic Net, group, SLOPE,
constrained and zero-sum lasso, Basis Pursuit, the penalized GLMs, the
multinomial and the multi-task paths.

Layout: the W workers are a leading batch axis, the JAX package's
``W_local`` (the reference's OpenMP threads as one batched product).
``mesh=`` (:mod:`admm_tpu_torch.parallel.mesh`) spreads them over D
positions, W/D contiguous workers each: a position factorizes and
updates only its own workers, and the one collective of an iteration
gathers the workers' new x rows, so every position then forms the packed
reduction below from the same (W, p) stack, in the same order as without
a mesh (the JAX package's psum of the packed vector).  The positions of
one process that share a device run their workers as one batch, so a
one-process mesh on one device gives the bits of the same W without a
mesh; ranks in separate processes run smaller batches, whose products
may round differently on the card.  Kept exactly, since each moves
``niter`` otherwise:

* the packed reduction ``[sum_i(x_i + y_i/rho), sum||x_i||^2,
  sum||y_i||^2, sum||r_i||^2]`` of each iteration;
* the lagged primal residual: ``||r_i||^2`` rides the next iteration's
  reduction, reset to ``BIG`` at each lambda, so the Boyd test certifies
  the previous iterate (one refining iteration past the reference's
  stop, reference: src/PADMMBase.h:200-214);
* rho = lambda_first / W (reference: src/PADMMLasso.h:199-200), fixed
  over the path, so each worker factorizes once per cold start.

The loop.  The JAX package runs the whole path as one compiled program
(``lax.scan`` over lambda around ``lax.while_loop``).  Here each lambda
runs on the engine's one host loop (``core/engine.py::_host_loop``): op
by op with one host read an iteration, or, where the hooks and the mesh
are capturable on a CUDA device, in groups of ``_CHUNK`` guarded
iterations, one CUDA graph replay and one host read a group.
``niter``, the iterates and the trace rows are the same on both routes.
Every batched product runs in full float32 (TF32 stays off, as
``admm_tpu_torch.linalg`` says): the Boyd test at 1e-5 needs it.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import _host_loop
from ..core.prox import soft_threshold
from ..data.standardize import recover
from ..data.standardize import standardize as standardize_data
from ..linalg import chol_inverse, gram
from ..models.bp import BPResult
from ..models.lasso import PathResult, _as_tensor, _linspace
from .mesh import all_gather, make_mesh

BIG = 9999.0


class _ConsensusState(NamedTuple):
    x: torch.Tensor         # (W, p) worker primal iterates
    y: torch.Tensor         # (W, p) worker duals
    z: torch.Tensor         # (p,) consensus variable
    r2_local: torch.Tensor  # sum over workers of ||x_i - z||^2, lagged
    rho: torch.Tensor
    lam: torch.Tensor
    # The last iteration's test, the trace row (r_pri the lagged one),
    # kept only when a trace is recorded.
    eps_pri: torch.Tensor
    r_pri: torch.Tensor
    eps_dua: torch.Tensor
    r_dua: torch.Tensor
    it: torch.Tensor        # int32
    done: torch.Tensor      # bool


def _bmm(spec, *ops):
    """Batched (worker-axis) product at full float32 precision."""
    return torch.einsum(spec, *ops)


def _chol_inverse_w(S, *, jitter: float = 0.0):
    """``chol_inverse`` of each worker's matrix (``vmap`` in the JAX
    package): the jitter is scaled by each matrix's own mean diagonal."""
    return torch.stack([chol_inverse(S[i], jitter=jitter)
                        for i in range(S.shape[0])])


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Model hooks: worker x-update factories and master prox operators
# ---------------------------------------------------------------------------

def _lasso_x_update(Xi, yi, rho, *, tall_block: bool):
    """Per-worker ridge solve ``argmin 1/2||A_i x - b_i||^2 +
    rho/2||x - v||^2`` with the factorization cached once per cold start
    (reference: src/PADMMLasso.h:17-31, :48-63): the direct inverse for
    tall blocks, Woodbury for wide ones."""
    _, rows, p = Xi.shape
    # A_i' b_i per worker (reference: src/PADMMLasso.h:42).
    Ab = _bmm("wrp,wr->wp", Xi, yi)
    if tall_block:
        Minv = _chol_inverse_w(_bmm("wrp,wrq->wpq", Xi, Xi)
                               + rho * _eye(p, Xi))

        def x_update(z, y, rho, x_prev):
            rhs = Ab - y + rho * z[None, :]
            return _bmm("wpq,wq->wp", Minv, rhs)
    else:
        # x = (rhs - A'(AA' + rho I)^-1 A rhs) / rho.
        Winv = _chol_inverse_w(_bmm("wrp,wsp->wrs", Xi, Xi)
                               + rho * _eye(rows, Xi))

        def x_update(z, y, rho, x_prev):
            rhs = Ab - y + rho * z[None, :]
            t = _bmm("wrs,ws->wr", Winv, _bmm("wrp,wp->wr", Xi, rhs))
            return (rhs - _bmm("wrp,wr->wp", Xi, t)) / rho

    return x_update


def _bp_x_update(Xi, yi, rho, *, jitter: float = 1e-6):
    """Per-worker affine projection onto ``{x : A_i x = b_i}``:
    ``x = v - A_i'(A_i A_i' + jitter I)^{-1}(A_i v - b_i)``, the inverse
    cached once (the consensus analog of reference: src/ADMMBP.h:48-67).
    A zero-padded row decouples in the jittered Gram matrix and adds
    nothing to the correction, so padding is inert."""
    rows = Xi.shape[1]
    Winv = _chol_inverse_w(_bmm("wrp,wsp->wrs", Xi, Xi)
                           + jitter * _eye(rows, Xi))

    def x_update(z, y, rho, x_prev):
        v = z[None, :] - y / rho
        t = _bmm("wrs,ws->wr", Winv, _bmm("wrp,wp->wr", Xi, v) - yi)
        return v - _bmm("wrp,wr->wp", Xi, t)

    return x_update


def _glm_x_update(Xi, yi, rho, *, family, n_total: int,
                  newton_steps: int = 2, weighted: bool = False,
                  hessian: str = "exact"):
    """Per-worker inexact Newton on ``loss_i/n + rho/2||x - v||^2`` for
    any :class:`~admm_tpu_torch.models.glm.GLMFamily` (reference:
    src/PADMMBase.h:17-83, any f_i plugs in).  ``hessian="exact"``
    builds and Cholesky-solves each worker's (q, q) Hessian per Newton
    step; ``"fixed"`` caches the curvature majorizer's inverse
    ``(bound X_i'W X_i/n + rho I)^{-1}`` once.  With ``weighted`` the
    response arrives stacked with the observation weights, ``(W, rows,
    2)``.  Zero-padded rows add zero gradient and zero Hessian."""
    q = Xi.shape[2]
    eye = _eye(q, Xi)
    wi = None
    if weighted:
        yi, wi = yi[..., 0], yi[..., 1]
    fixed_minv = None
    if hessian == "fixed":
        Xw = Xi if wi is None else Xi * torch.sqrt(wi)[..., None]
        fixed_minv = _chol_inverse_w(
            (family.curvature_bound / n_total)
            * _bmm("wrq,wrs->wqs", Xw, Xw) + rho * eye)

    def x_update(z, y, rho_, x_prev):
        v = z[None, :] - y / rho_
        b = x_prev
        for _ in range(newton_steps):
            u = _bmm("wrq,wq->wr", Xi, b)
            g = family.grad_eta(u, yi)
            if wi is not None:
                g = wi * g
            grad = _bmm("wrq,wr->wq", Xi, g) / n_total + rho_ * (b - v)
            if fixed_minv is not None:
                b = b - _bmm("wqs,ws->wq", fixed_minv, grad)
                continue
            w = family.weight_eta(u, yi)
            if wi is not None:
                w = wi * w
            H = _bmm("wrq,wrs->wqs", Xi * w[..., None], Xi) / n_total \
                + rho_ * eye
            # No error check: a host read per step otherwise (a failed
            # factor gives NaN, as the JAX package's Cholesky does).
            L = torch.linalg.cholesky_ex(H).L
            b = b - torch.cholesky_solve(grad[..., None], L)[..., 0]
        return b

    return x_update


def _glm_master_prox(W: int, alpha: float, pen_mask):
    """Masked elastic-net prox of the consensus mean; the intercept
    (pen_mask 0) passes unpenalized, as the serial GLM z-update does."""
    def prox(zbar, lam, rho):
        wr = W * rho
        pen = lam * pen_mask
        return soft_threshold(wr * zbar, alpha * pen) / (pen * (1.0 - alpha)
                                                         + wr)
    return prox


def _lasso_master_prox(W: int):
    """``z = soft_threshold(mean_i(x_i + y_i/rho), lambda/(rho W))``
    (reference: src/PADMMLasso.h:99-108)."""
    def prox(zbar, lam, rho):
        return soft_threshold(zbar, lam / (rho * W))
    return prox


def _enet_master_prox(W: int, alpha: float):
    """``argmin_z lam(alpha||z||_1 + (1-alpha)/2||z||^2) + W rho/2
    ||z - m||^2 = soft_threshold(W rho m, lam alpha) / (lam(1-alpha) +
    W rho)``; alpha = 1 is the Lasso's prox."""
    def prox(zbar, lam, rho):
        wr = W * rho
        return soft_threshold(wr * zbar, lam * alpha) / (lam * (1.0 - alpha)
                                                         + wr)
    return prox


def _group_master_prox(W: int, groups, weights, l1_ratio: float = 0.0):
    """Block soft-threshold of the consensus mean (``l1_ratio > 0``: the
    sparse-group compound prox of models/grouplasso.py)."""
    from ..models.grouplasso import _group_prox_fn

    prox = _group_prox_fn(groups, weights, l1_ratio)

    def master(zbar, lam, rho):
        return prox(zbar, lam / (rho * W))
    return master


def _bp_master_prox(W: int):
    """``z = soft_threshold(mean, 1/(rho W))``: the whole ||.||_1 sits in
    g (serial analog reference: src/ADMMBP.h:84-88)."""
    def prox(zbar, lam, rho):
        return soft_threshold(zbar, 1.0 / (rho * W))
    return prox


def _mn_x_update(Xi, yi, rho, *, nclass: int, n_total: int,
                 newton_steps: int = 2):
    """Per-worker fixed-majorizer Newton for the multinomial (softmax)
    model: the (q, C) block rides the engine flattened to q*C, the
    majorizer inverse ``(X_i'X_i/(2n) + rho I)^{-1}`` (softmax curvature
    bound 1/2) is cached once and shared by the classes.  Padded rows
    one-hot to class 0 but have zero features, so they add nothing."""
    Wl, _, q = Xi.shape
    C = nclass
    Yoh = torch.nn.functional.one_hot(yi.to(torch.int64), C).to(Xi.dtype)
    Minv = _chol_inverse_w(_bmm("wrq,wrs->wqs", Xi, Xi) / (2.0 * n_total)
                           + rho * _eye(q, Xi))

    def x_update(z, y, rho_, x_prev):
        V = (z[None, :] - y / rho_).reshape(Wl, q, C)
        B = x_prev.reshape(Wl, q, C)
        for _ in range(newton_steps):
            pi = torch.softmax(_bmm("wrq,wqc->wrc", Xi, B), dim=-1)
            G = _bmm("wrq,wrc->wqc", Xi, pi - Yoh) / n_total + rho_ * (B - V)
            B = B - _bmm("wqs,wsc->wqc", Minv, G)
        return B.reshape(Wl, q * C)

    return x_update


def _mn_master_prox(W: int, alpha: float, pen_mask, q: int, C: int,
                    grouped: bool):
    """Masked elastic net per entry (ungrouped) or row-norm shrinkage
    (grouped) of the (q, C) consensus mean; the intercept row passes."""
    def prox(zbar, lam, rho):
        wr = W * rho
        V = zbar.reshape(q, C)
        pen = lam * pen_mask[:, None]
        if grouped:
            rn = torch.sqrt(torch.sum(V * V, dim=1, keepdim=True))
            Z = V * torch.clamp(1.0 - pen / torch.clamp(wr * rn, min=1e-30),
                                min=0.0)
        else:
            Z = soft_threshold(wr * V, alpha * pen) / (pen * (1.0 - alpha)
                                                       + wr)
        return Z.reshape(q * C)

    return prox


def _mt_x_update(Xi, yi, rho, *, ntask: int, tall_block: bool):
    """Per-worker ridge solve with a (p, K) right-hand side for the
    multi-task Lasso, flattened to p*K; tall direct or wide Woodbury, the
    factorization cached once (reference: src/PADMMLasso.h:17-31, with K
    columns)."""
    Wl, rows, p = Xi.shape
    K = ntask
    AtY = _bmm("wrp,wrk->wpk", Xi, yi)
    if tall_block:
        Minv = _chol_inverse_w(_bmm("wrp,wrq->wpq", Xi, Xi)
                               + rho * _eye(p, Xi))

        def x_update(z, y, rho_, x_prev):
            rhs = AtY - y.reshape(Wl, p, K) + rho_ * z.reshape(p, K)[None]
            return _bmm("wpq,wqk->wpk", Minv, rhs).reshape(Wl, p * K)
    else:
        Winv = _chol_inverse_w(_bmm("wrp,wsp->wrs", Xi, Xi)
                               + rho * _eye(rows, Xi))

        def x_update(z, y, rho_, x_prev):
            rhs = AtY - y.reshape(Wl, p, K) + rho_ * z.reshape(p, K)[None]
            t = _bmm("wrs,wsk->wrk", Winv, _bmm("wrp,wpk->wrk", Xi, rhs))
            return ((rhs - _bmm("wrp,wrk->wpk", Xi, t))
                    / rho_).reshape(Wl, p * K)

    return x_update


def _mt_nuclear_master_prox(W: int, p: int, K: int):
    """SVT of the (p, K) consensus mean, the trace-norm master:
    ``argmin_Z lam||Z||_* + W rho/2 ||Z - m||_F^2 = svt(m, lam/(W rho))``
    (on a CUDA tensor the SVD runs in float64, models/rpca.py::svt)."""
    from ..models.rpca import svt

    def prox(zbar, lam, rho):
        return svt(zbar.reshape(p, K), lam / (W * rho)).reshape(p * K)

    return prox


def _mt_master_prox(W: int, p: int, K: int, alpha: float = 1.0):
    """Row-norm group soft-threshold of the (p, K) consensus mean;
    ``alpha < 1`` adds the exact ridge shrink (glmnet's mgaussian
    elastic net)."""
    def prox(zbar, lam, rho):
        wr = W * rho
        V = zbar.reshape(p, K)
        rn = torch.sqrt(torch.sum(V * V, dim=1, keepdim=True))
        shrunk = wr * V * torch.clamp(
            1.0 - lam * alpha / torch.clamp(wr * rn, min=1e-30), min=0.0)
        return (shrunk / (lam * (1.0 - alpha) + wr)).reshape(p * K)

    return prox


def _conlasso_x_update_maker(C, d):
    """Per-worker equality-constrained ridge solves for the constrained
    lasso: the block-eliminated KKT system of models/conlasso.py (cached
    ``(A_i'A_i + rho I)^{-1}`` and each worker's m x m dual Schur
    complement), so every worker iterate satisfies ``C x_i = d``."""
    def make(Xi, yi, rho):
        p = Xi.shape[2]
        Ab = _bmm("wrp,wr->wp", Xi, yi)
        jit = 1e-6 if Xi.dtype == torch.float32 else 0.0
        Minv = _chol_inverse_w(_bmm("wrp,wrq->wpq", Xi, Xi)
                               + rho * _eye(p, Xi), jitter=jit)
        MCt = _bmm("wpq,mq->wpm", Minv, C)
        Sinv = _chol_inverse_w(_bmm("mp,wpk->wmk", C, MCt), jitter=jit)

        def x_update(z, y, rho, x_prev):
            Mr = _bmm("wpq,wq->wp", Minv, Ab - y + rho * z[None, :])
            nu = _bmm("wmk,wk->wm", Sinv,
                      _bmm("mp,wp->wm", C, Mr) - d[None, :])
            return Mr - _bmm("wpm,wm->wp", MCt, nu)

        return x_update

    return make


# ---------------------------------------------------------------------------
# The generic consensus engine
# ---------------------------------------------------------------------------

def _consensus_solve(Xb, yb, x0, y0, z0, ilams, rho0, maxit, eps_abs,
                     eps_rel, *, nworkers: int, make_x_update: Callable,
                     master_prox: Callable, auto_rho: Callable,
                     trace_len: Optional[int] = None,
                     graph_safe: bool = True, mesh=None):
    """The consensus path over ``ilams`` from the iterates ``(x0, y0,
    z0)`` (zeros for a cold start, a saved state to resume); the JAX
    package's ``_consensus_shard``.

    ``mesh``: the W workers are dealt to its D positions in contiguous
    blocks of W/D; this process builds and runs the worker solve of its
    positions' blocks on their devices (:func:`_mesh_x_update`), and the
    new x rows are gathered
    (:func:`~admm_tpu_torch.parallel.mesh.all_gather`) into the replicated
    (W, p) stack the rest of the iteration reads.

    ``make_x_update(Xb, yb, rho) -> x_update(z, y, rho, x_prev)`` builds
    the worker solve with its factorizations cached, ``master_prox(zbar,
    lam, rho)`` is the z-update, ``auto_rho(lam_first)`` the model's rho
    when ``rho0 <= 0``.  With ``trace_len`` each lambda records
    (eps_pri, r_pri, eps_dua, r_dua, rho) at row ``min(it, trace_len -
    1)`` of a NaN buffer while it runs; r_pri is the lagged residual the
    test used.

    Each lambda runs on the engine's host loop
    (:func:`~admm_tpu_torch.core.engine._host_loop`), as a CUDA graph
    captured once per path and replayed where its route allows: not when
    ``graph_safe`` is False, since a hook that reads the host inside an
    iteration (the SVD's and the Cholesky's error checks, the parallel
    PAVA's loop) cannot be captured, nor can a gloo collective
    (:func:`~admm_tpu_torch.core.engine._route`).

    Returns ``(coefs, niter, (x, y, z, rho), traces)``.
    """
    p = x0.shape[-1]
    dtype, dev = Xb.dtype, Xb.device
    W = nworkers
    sqrtW = math.sqrt(W)
    scalar = partial(torch.tensor, dtype=dtype, device=dev)
    # The absolute tolerance, rounded in the path's dtype as on the device
    # (a host float carries it into the loop exactly).
    abs_tol = float(math.sqrt(p * W) * torch.tensor(eps_abs, dtype=dtype))
    rho0 = float(rho0)
    rho = (scalar(rho0) if rho0 > 0
           else torch.as_tensor(auto_rho(ilams[0]), dtype=dtype,
                                device=dev).reshape(()))
    x_update = (make_x_update(Xb, yb, rho) if mesh is None
                else _mesh_x_update(make_x_update, Xb, yb, rho, W, mesh))

    def body(st: _ConsensusState, abs_tol, eps_rel):
        x = x_update(st.z, st.y, st.rho, st.x)
        # The one reduction of the iteration: a sum over the workers of
        # the replicated stack (an all-reduce over devices in the JAX
        # package).
        g = torch.cat([torch.sum(x + st.y / st.rho, dim=0),
                       torch.stack([torch.sum(x * x), torch.sum(st.y * st.y),
                                    st.r2_local])])
        zbar = g[:p] / W
        sx2, sy2, sr2 = g[p], g[p + 1], g[p + 2]
        # sr2 is the previous iteration's primal residual (it rode this
        # reduction): the test lags the primal by one refining iteration.
        eps_pri = (torch.maximum(torch.sqrt(sx2),
                                 torch.sqrt(torch.sum(st.z * st.z)) * sqrtW)
                   * eps_rel + abs_tol)
        eps_dua = torch.sqrt(sy2) * eps_rel + abs_tol
        # Master z-update (reference: src/PADMMLasso.h:99-108).
        z_new = master_prox(zbar, st.lam, st.rho)
        r_dua = st.rho * sqrtW * torch.sqrt(torch.sum((z_new - st.z) ** 2))
        r = x - z_new[None, :]
        r_pri = torch.sqrt(sr2)
        new = st._replace(x=x, y=st.y + st.rho * r, z=z_new,
                          r2_local=torch.sum(r * r), it=st.it + 1,
                          done=(r_pri < eps_pri) & (r_dua < eps_dua))
        if trace_len is None:
            # Fields a step leaves as they were cost the guard nothing.
            return new
        return new._replace(eps_pri=eps_pri, r_pri=r_pri, eps_dua=eps_dua,
                            r_dua=r_dua)

    run = _host_loop(body, graph_safe, mesh)
    big = scalar(BIG)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    st = _ConsensusState(
        x=x0, y=y0, z=z0, r2_local=big, rho=rho, lam=ilams[0],
        eps_pri=big, r_pri=big, eps_dua=big, r_dua=big, it=zero, done=false)
    coefs, niters, bufs = [], [], []
    for lam in ilams:
        # Warm start: keep x, y, z, rho; reset the sentinels
        # (reference: src/PADMMLasso.h:215-223).
        st, buf = run(st._replace(lam=lam, r2_local=big, it=zero,
                                  done=false),
                      maxit, abs_tol, eps_rel, trace_len)
        # The reported coefficients are the consensus z
        # (reference: src/ParLasso.cpp:99).
        coefs.append(st.z)
        niters.append(st.it)
        bufs.append(buf)
    traces = None if trace_len is None else torch.stack(bufs)
    return (torch.stack(coefs), torch.stack(niters),
            (st.x, st.y, st.z, st.rho), traces)


def _mesh_x_update(make_x_update, Xb, yb, rho, W: int, mesh):
    """The worker solve on a mesh: each local position owns a contiguous
    block of W/D workers; consecutive positions on one device run their
    blocks as one batch there (one process on one device: the W workers
    of the call without a mesh), and the new x rows are gathered."""
    runs = []       # [lo, hi, device] of the device's consecutive blocks
    for (lo, hi), dev in zip(mesh.local_spans(W), mesh.devices):
        if runs and runs[-1][1] == lo and runs[-1][2] == dev:
            runs[-1][1] = hi
        else:
            runs.append([lo, hi, dev])
    parts = [(slice(lo, hi), dev, make_x_update(
        Xb[lo:hi].to(dev), yb[lo:hi].to(dev), rho.to(dev)))
        for lo, hi, dev in runs]

    def x_update(z, y, rho_, x_prev):
        return all_gather([upd(z.to(dev), y[sl].to(dev), rho_.to(dev),
                               x_prev[sl].to(dev))
                           for sl, dev, upd in parts], mesh, 0, W)

    return x_update


def _consensus_lasso_solver(nworkers: int, tall_block: bool,
                            alpha: float = 1.0, group_prox=None,
                            trace_len: Optional[int] = None, mesh=None):
    """The Lasso/Enet/group-Lasso instantiation of the engine (same
    worker ridge solves; the master prox selects the penalty)."""
    if callable(group_prox):
        master = group_prox(nworkers)
    elif group_prox is not None:
        master = _group_master_prox(nworkers, *group_prox)
    elif alpha >= 1.0:
        master = _lasso_master_prox(nworkers)
    else:
        master = _enet_master_prox(nworkers, alpha)
    return partial(
        _consensus_solve, nworkers=nworkers,
        make_x_update=partial(_lasso_x_update, tall_block=tall_block),
        master_prox=master,
        # Auto-rho (reference: src/PADMMLasso.h:199-200).
        auto_rho=lambda lam_first: lam_first / nworkers,
        trace_len=trace_len,
        graph_safe=getattr(group_prox, "graph_safe", True), mesh=mesh)


# ---------------------------------------------------------------------------
# Drivers (partition -> solve -> recover)
# ---------------------------------------------------------------------------

def _ndevices(device) -> int:
    """The devices a call without a mesh may span: the CUDA devices for a
    call on the card, the one CPU otherwise."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def _resolve_mesh(nworkers: Optional[int], mesh, device="cuda"):
    """``(W, mesh)`` from the user's worker count and mesh, as the JAX
    package resolves them: W defaults to the mesh size (or to one worker
    per device of the call); without a mesh, the auto mesh is the largest
    device count that divides W (D = 1, no mesh, on one device), and an
    explicit mesh of D positions needs W a multiple of D."""
    if nworkers is not None and int(nworkers) < 1:
        raise ValueError("nworkers must be a positive integer")
    if mesh is None:
        ndev = _ndevices(device)
        W = ndev if nworkers is None else int(nworkers)
        D = max(d for d in range(1, min(W, ndev) + 1) if W % d == 0)
        return W, (make_mesh(D) if D > 1 else None)
    D = mesh.size
    W = int(nworkers) if nworkers is not None else D
    if W % D != 0:
        raise ValueError(f"nworkers={W} must be a multiple of the "
                         f"explicit mesh size {D}")
    return W, mesh


def _call_device(mesh, device):
    """Where a consensus driver puts the data it is given as numpy: the
    mesh's home device, or ``device``."""
    return device if mesh is None else mesh.home


def _partition_rows(Xs, ys, W: int):
    """Rows as ``(W, rows_w, p)`` worker blocks, zero-padded.  Zero rows
    change neither A_i'A_i nor A_i'b_i and are inert under the jittered
    BP projection, so the optimum is unchanged (the reference gives the
    last worker the remainder instead, reference:
    src/PADMMLasso.h:163-179).  ``ys`` may be (n,) or (n, K)."""
    n, p = Xs.shape
    n_pad = -(-n // W) * W
    if n_pad != n:
        Xs = torch.cat([Xs, Xs.new_zeros((n_pad - n, p))])
        ys = torch.cat([ys, ys.new_zeros((n_pad - n,) + ys.shape[1:])])
    rows_w = n_pad // W
    return (Xs.reshape(W, rows_w, p),
            ys.reshape((W, rows_w) + ys.shape[1:]), rows_w)


def _run_consensus(Xb, yb, ilams, rho, maxit, eps_abs, eps_rel, *, solver,
                   init=None):
    """Run one solver over the worker blocks.  ``init`` is an optional
    ``(x0, y0, z0)`` warm state ((W, p), (W, p), (p,)) to resume from,
    zeros otherwise; ``rho`` > 0 is used as given (a resumed path passes
    the saved one).  Returns ``(coefs, niter, (x, y, z, rho), traces)``."""
    dtype, dev = Xb.dtype, Xb.device
    W, _, p = Xb.shape
    if init is None:
        z = torch.zeros((p,), dtype=dtype, device=dev)
        init = (torch.zeros((W, p), dtype=dtype, device=dev),
                torch.zeros((W, p), dtype=dtype, device=dev), z)
    x0, y0, z0 = (torch.as_tensor(a, dtype=dtype, device=dev)
                  for a in init)
    return solver(Xb, yb, x0, y0, z0, ilams, rho, int(maxit), eps_abs,
                  eps_rel)


def _ncol(X) -> int:
    return int(X.shape[1]) if hasattr(X, "shape") else np.shape(X)[1]


def _device_of(X, device):
    return X.device if isinstance(X, torch.Tensor) else device


def _grid(lam0, ratio, nlambda: int):
    """The log-linear grid ``lam0 .. ratio * lam0`` (``jnp.linspace``'s
    formula)."""
    return torch.exp(_linspace(torch.log(lam0), torch.log(ratio * lam0),
                               int(nlambda)))


def _user_grid(lambdas, dtype, device):
    lams = _as_tensor(lambdas, dtype, device).reshape(-1)
    return torch.sort(lams, descending=True).values


def parallel_lasso_path(X, y, *, nworkers: Optional[int] = None, mesh=None,
                        lambdas=None, nlambda: int = 100,
                        lambda_min_ratio: Optional[float] = None,
                        standardize: bool = True, intercept: bool = True,
                        maxit: int = 10000, eps_abs: float = 1e-5,
                        eps_rel: float = 1e-5, rho: float = -1.0,
                        alpha: float = 1.0, _enet_scale: bool = False,
                        _master_prox_override=None,
                        trace_len: Optional[int] = None, weights=None,
                        dtype=torch.float32, device="cuda") -> PathResult:
    """Consensus-ADMM Lasso/Enet lambda path over W workers.

    Same arguments and defaults as ``admm_tpu.parallel_lasso_path``, plus
    ``device`` (tensors stay on their own device, anything else goes to
    ``device``, or to the mesh's home device).  ``mesh``
    (:func:`admm_tpu_torch.parallel.mesh.make_mesh`) deals the workers to
    its D positions, W/D each; ``nworkers`` defaults to the mesh size, or
    to one worker per device of the call (1 on one device), and a worker
    count without a mesh takes the largest device count that divides it
    (:func:`_resolve_mesh`).  ``alpha < 1`` is the Elastic Net by
    consensus (an extension: the reference parallelizes only the Lasso,
    reference: src/ParLasso.cpp).  ``weights`` scale the rows by sqrt(w)
    in the standardization, so the worker ridge solves are weighted.

    The primal residual rides the reduction one iteration late (module
    docstring): the Boyd primal test certifies the previous iterate, and
    the returned one has run one further refining iteration.
    """
    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(X, device))
    X = _as_tensor(X, dtype, _call_device(mesh, device))
    y = _as_tensor(y, dtype, X.device).reshape(-1)
    n, p = X.shape
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    Xs, ys, stats = standardize_data(X, y, standardize_x=standardize,
                                     intercept=intercept, weights=w)
    if lambdas is not None:
        lams = _user_grid(lambdas, dtype, X.device)
    else:
        if callable(_master_prox_override):
            # A generic master prox (the consensus SLOPE) may carry its
            # penalty's own null threshold as ``lambda0``.
            lam0_fn = getattr(_master_prox_override, "lambda0", None)
            lam0 = (lam0_fn(Xs, ys) if lam0_fn is not None
                    else torch.max(torch.abs(Xs.mT @ ys)))
        elif _master_prox_override is not None:
            from ..models.grouplasso import _gl_lambda0

            lam0 = _gl_lambda0(Xs, ys, *_master_prox_override)
        else:
            lam0 = torch.max(torch.abs(Xs.mT @ ys))
        if _enet_scale:
            # Enet lambda0 inflation (reference: src/ADMMEnet.h:56).
            lam0 = lam0 / (alpha + 1e-4)
        lams = _grid(lam0 / n * stats.scale_y, lambda_min_ratio, nlambda)
    ilams = lams * n / stats.scale_y

    Xb, yb, rows_w = _partition_rows(Xs, ys, W)
    trace_len = None if trace_len is None else int(trace_len)
    solver = _consensus_lasso_solver(W, rows_w >= p, float(alpha),
                                     _master_prox_override, trace_len, mesh)
    coefs, niter, _, traces = _run_consensus(Xb, yb, ilams, rho, maxit,
                                             eps_abs, eps_rel, solver=solver)
    beta0, coef = recover(stats, coefs, standardize_x=standardize,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def parallel_group_lasso_path(X, y, groups, *, weights=None,
                              l1_ratio: float = 0.0, **kw) -> PathResult:
    """Consensus group-Lasso path: the Lasso scheme with the block
    soft-threshold as the master prox.  ``groups``/``weights``/
    ``l1_ratio`` as in :func:`admm_tpu_torch.group_lasso_path`."""
    from ..models.grouplasso import normalize_groups

    dtype = kw.get("dtype", torch.float32)
    if not 0.0 <= l1_ratio <= 1.0:
        raise ValueError("l1_ratio must be in [0, 1]")
    groups_t, weights_t = normalize_groups(
        groups, _ncol(X), weights, dtype, _device_of(X, _call_device(
            kw.get("mesh"), kw.get("device", "cuda"))))
    return parallel_lasso_path(
        X, y, _master_prox_override=(groups_t, weights_t, float(l1_ratio)),
        **kw)


def parallel_slope_path(X, y, *, lam_seq=None, q: float = 0.1,
                        **kw) -> PathResult:
    """Consensus SLOPE path: the Lasso scheme with the sorted-l1 prox as
    the master prox (the sequence scale t plays lambda).  ``lam_seq``/
    ``q`` as in :func:`admm_tpu_torch.slope_path`."""
    from ..models.slope import (_ISOTONIC_DENSE_MAX_P, _slope_t0,
                                bh_sequence, prox_sorted_l1)

    p = _ncol(X)
    dtype = kw.get("dtype", torch.float32)
    if lam_seq is None:
        lam_seq = bh_sequence(p, q)
    if isinstance(lam_seq, torch.Tensor):
        lam_seq = lam_seq.detach().cpu().numpy()
    lam_np = np.asarray(lam_seq, np.float64).ravel()
    if lam_np.shape != (p,):
        raise ValueError("lam_seq must have one entry per column of x")
    if np.any(np.diff(lam_np) > 1e-12) or not lam_np[0] > 0:
        raise ValueError("lam_seq must be nonincreasing with a "
                         "positive largest entry")
    lam_t = torch.as_tensor(lam_np, dtype=dtype, device=_device_of(
        X, _call_device(kw.get("mesh"), kw.get("device", "cuda"))))

    def make_master(W):
        def prox(zbar, lam, rho):
            return prox_sorted_l1(zbar, (lam / (rho * W)) * lam_t)
        return prox

    make_master.lambda0 = lambda Xs, ys: (_slope_t0(Xs, ys, lam_t)
                                          * (1.0 + 1e-4))
    # Past the dense crossover the prox runs the PAVA's host loop.
    make_master.graph_safe = p <= _ISOTONIC_DENSE_MAX_P
    return parallel_lasso_path(X, y, _master_prox_override=make_master,
                               **kw)


def parallel_enet_path(X, y, *, alpha: float = 1.0, **kw) -> PathResult:
    """Consensus Elastic-Net path (the reference has no
    ``admm_parenet``); ``alpha=1`` is :func:`parallel_lasso_path`."""
    return parallel_lasso_path(X, y, alpha=alpha, _enet_scale=True, **kw)


def parallel_constrained_lasso_path(
        X, y, C, d=None, *, nworkers: Optional[int] = None, mesh=None,
        lambdas=None, nlambda: int = 50, lambda_min_ratio: float = 1e-3,
        intercept: bool = True, maxit: int = 10000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0, weights=None,
        trace_len: Optional[int] = None, dtype=torch.float32,
        device="cuda") -> PathResult:
    """Consensus equality-constrained lasso path: every worker solves a
    constrained ridge subproblem (its iterate exactly feasible), the
    master applies the plain soft threshold.  Arguments as in
    :func:`admm_tpu_torch.constrained_lasso_path` plus ``nworkers``; the
    reported coefficients are the consensus z, so ``C b = d`` holds to
    solver tolerance."""
    from ..models.genlasso import center_weight

    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(X, device))
    X = _as_tensor(X, dtype, _call_device(mesh, device))
    dev = X.device
    y = _as_tensor(y, dtype, dev).reshape(-1)
    C = _as_tensor(C, dtype, dev)
    C = C.reshape(1, -1) if C.dim() < 2 else C
    n, p = X.shape
    if C.shape[1] != p:
        raise ValueError("C must be (m, ncol(x))")
    if C.shape[0] >= p:
        raise ValueError("need fewer constraints than coefficients")
    d = (torch.zeros((C.shape[0],), dtype=dtype, device=dev) if d is None
         else _as_tensor(d, dtype, dev).reshape(-1))
    if d.shape != (C.shape[0],):
        raise ValueError("d must have one entry per constraint row")
    w = None if weights is None else _as_tensor(weights, dtype, dev)
    Xs, ys, mean_x, mean_y = center_weight(X, y, w, intercept)

    if lambdas is not None:
        lams = _user_grid(lambdas, dtype, dev)
    else:
        # The serial driver's feasible-certificate grid top.
        g = Xs.mT @ ys
        nu_ls = chol_inverse(
            gram(C.mT), jitter=1e-6 if dtype == torch.float32 else 1e-12
        ) @ (C @ g)
        lam0 = torch.max(torch.abs(g - C.mT @ nu_ls)) / n
        lam0 = torch.where(torch.isfinite(lam0) & (lam0 > 0), lam0,
                           torch.max(torch.abs(g)) / n)
        lams = _grid(lam0, lambda_min_ratio, nlambda)
    ilams = lams * n

    Xb, yb, _ = _partition_rows(Xs, ys, W)
    solver = partial(_consensus_solve, nworkers=W,
                     make_x_update=_conlasso_x_update_maker(C, d),
                     master_prox=_lasso_master_prox(W),
                     auto_rho=lambda lam_first: lam_first / W,
                     trace_len=None if trace_len is None else int(trace_len),
                     mesh=mesh)
    coefs, niter, _, traces = _run_consensus(Xb, yb, ilams, rho, maxit,
                                             eps_abs, eps_rel, solver=solver)
    return PathResult(lambdas=lams, beta0=mean_y - coefs @ mean_x,
                      coef=coefs, niter=niter, trace=traces)


def parallel_zerosum_lasso_path(X, y, **kw) -> PathResult:
    """Consensus zero-sum lasso (``sum_j b_j = 0``): the constrained
    consensus path at C = 1'."""
    return parallel_constrained_lasso_path(X, y, np.ones((1, _ncol(X))),
                                           **kw)


def parallel_bp_fit(A, b, *, nworkers: Optional[int] = None, mesh=None,
                    maxit: int = 10000, eps_abs: Optional[float] = None,
                    eps_rel: Optional[float] = None,
                    rho: Optional[float] = None,
                    trace_len: Optional[int] = None, dtype=None,
                    device="cuda") -> BPResult:
    """Consensus Basis Pursuit: ``min ||z||_1 s.t. A_i z = b_i`` for every
    row block i, the working version of what the reference left dormant
    (reference: src/TODO/ParBP.cppp, src/TODO/PADMMBP.h; R/10_admm_bp.R
    dispatches to it at :100-120 but it was never compiled).  Workers
    project onto their affine sets exactly; the master soft-thresholds
    the consensus mean.

    ``dtype`` follows the port's rule, not the JAX package's x64 flag:
    None is ``torch.float32`` (eps 2e-5, jitter 1e-6) and
    ``torch.float64`` the reference's double (eps 1e-4, jitter 1e-10).
    rho defaults to 5.0 (the JAX package's measured default; 1.0 is the
    reference's).  As in :func:`parallel_lasso_path` the primal test lags
    one iteration.
    """
    if dtype is None:
        dtype = torch.float32
    if eps_abs is None:
        eps_abs = 1e-4 if dtype == torch.float64 else 2e-5
    if eps_rel is None:
        eps_rel = 1e-4 if dtype == torch.float64 else 2e-5
    if rho is None:
        rho = 5.0
    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(A, device))
    A = _as_tensor(A, dtype, _call_device(mesh, device))
    b = _as_tensor(b, dtype, A.device).reshape(-1)
    n, p = A.shape
    if p <= n:
        raise ValueError("ncol(x) must be greater than nrow(x)")

    Ab, bb, _ = _partition_rows(A, b, W)
    # Never zero: the jitter keeps padded zero rows inert.
    jitter = 1e-6 if dtype == torch.float32 else 1e-10
    solver = partial(_consensus_solve, nworkers=W,
                     make_x_update=partial(_bp_x_update, jitter=jitter),
                     master_prox=_bp_master_prox(W),
                     auto_rho=lambda lam_first: 1.0,
                     trace_len=None if trace_len is None else int(trace_len),
                     mesh=mesh)
    lams = torch.ones((1,), dtype=dtype, device=A.device)  # one solve
    coefs, niter, _, traces = _run_consensus(Ab, bb, lams, rho, maxit,
                                             eps_abs, eps_rel, solver=solver)
    return BPResult(coef=coefs[0], niter=niter[0],
                    trace=None if traces is None else traces[0])


def parallel_glm_lasso_path(
        X, y, family, *, nworkers: Optional[int] = None, mesh=None,
        lambdas=None, nlambda: int = 50, lambda_min_ratio: float = 1e-2,
        alpha: float = 1.0, standardize: bool = True,
        intercept: bool = True, maxit: int = 10000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0, newton_steps: int = 2,
        trace_len: Optional[int] = None, weights=None,
        hessian: str = "auto", dtype=torch.float32,
        device="cuda") -> PathResult:
    """Consensus penalized-GLM path for any
    :class:`~admm_tpu_torch.models.glm.GLMFamily` (reference:
    src/PADMMBase.h:17-83): each worker runs the family's inexact Newton
    on its rows' share of the loss, the master the masked elastic-net
    prox.  Objective, grid rule, standardization and the unpenalized
    intercept are :func:`admm_tpu_torch.glm_lasso_path`'s.
    ``hessian="auto"`` is "fixed" (the curvature majorizer, cached once)
    for a bounded family and "exact" otherwise."""
    from ..models.glm import GLMFamily, prep_design, recover_glm

    fam = family() if not isinstance(family, GLMFamily) else family
    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(X, device))
    X = _as_tensor(X, dtype, _call_device(mesh, device))
    dev = X.device
    y = _as_tensor(y, dtype, dev).reshape(-1)
    n, p = X.shape
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1] for GLM paths")
    if hessian == "auto":
        hessian = "fixed" if fam.curvature_bound is not None else "exact"
    if hessian == "fixed" and fam.curvature_bound is None:
        raise ValueError(f"family {fam.name!r} has unbounded curvature; "
                         "hessian='fixed' is not available")
    w = None
    if weights is not None:
        w = _as_tensor(weights, dtype, dev).reshape(-1)
        w = w * (n / torch.sum(w))  # glmnet: weights sum to n
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize, intercept,
                                             weights=w)
    Xs = Xa[:, 1:] if intercept else Xa
    if lambdas is not None:
        lams = _user_grid(lambdas, dtype, dev)
    else:
        r0 = fam.null_resid(y, intercept, w)
        if w is not None:
            r0 = w * r0
        lam0 = torch.max(torch.abs(Xs.mT @ r0)) / n / max(alpha, 1e-3)
        lams = _grid(lam0, lambda_min_ratio, nlambda)

    Xb, yb, _ = _partition_rows(Xa, y, W)
    if w is not None:
        # The weights ride stacked with the response (_glm_x_update).
        yb = torch.stack([yb, _partition_rows(Xa, w, W)[1]], dim=-1)
    solver = partial(
        _consensus_solve, nworkers=W,
        make_x_update=partial(_glm_x_update, family=fam, n_total=n,
                              newton_steps=int(newton_steps),
                              weighted=w is not None, hessian=hessian),
        master_prox=_glm_master_prox(W, float(alpha), pen_mask),
        # (curvature bound or 1)/W: each worker's loss share carries
        # about bound/W of the curvature (the JAX package's measured
        # rule, DESIGN.md "GLM rho").
        auto_rho=lambda lam_first: (fam.curvature_bound or 1.0) / W,
        trace_len=None if trace_len is None else int(trace_len),
        # The exact Hessian's batched Cholesky stays out of the graph.
        graph_safe=hessian == "fixed", mesh=mesh)
    # The GLM lam is on the user's scale (the 1/n is inside the loss).
    coefs_a, niter, _, traces = _run_consensus(Xb, yb, lams, rho, maxit,
                                               eps_abs, eps_rel,
                                               solver=solver)
    beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def parallel_logistic_lasso_path(X, y, **kw) -> PathResult:
    """Consensus sparse logistic regression (the binomial
    :func:`parallel_glm_lasso_path`)."""
    from ..models.glm import binomial

    return parallel_glm_lasso_path(X, y, binomial(), **kw)


def parallel_huber_lasso_path(X, y, *, M: float = 1.345,
                              **kw) -> PathResult:
    """Consensus Huber-loss Lasso/Enet path."""
    from ..models.glm import huber

    return parallel_glm_lasso_path(X, y, huber(float(M)), **kw)


def parallel_poisson_lasso_path(X, y, **kw) -> PathResult:
    """Consensus sparse Poisson regression path (exact Hessian: the
    family has no curvature bound)."""
    from ..models.glm import poisson

    return parallel_glm_lasso_path(X, y, poisson(), **kw)


def parallel_multinomial_lasso_path(
        X, y, *, nclass: Optional[int] = None,
        nworkers: Optional[int] = None, mesh=None, lambdas=None,
        nlambda: int = 50, lambda_min_ratio: float = 1e-2,
        alpha: float = 1.0, grouped: bool = False,
        standardize: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, newton_steps: int = 2,
        trace_len: Optional[int] = None, dtype=torch.float32,
        device="cuda"):
    """Consensus sparse multinomial (softmax) regression: each worker
    runs the fixed-majorizer Newton on its rows with the (q, C) block
    flattened to q*C, the master the (un)grouped prox; the reduction is
    q*C + 3 long.  Semantics are
    :func:`admm_tpu_torch.multinomial_lasso_path`'s.  As in the JAX
    package the result carries no trace (``trace_len`` is accepted and
    ignored)."""
    from ..models.glm import prep_design
    from ..models.multinomial import MNPathResult, mn_recover

    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(X, device))
    X = _as_tensor(X, dtype, _call_device(mesh, device))
    dev = X.device
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y_np = np.asarray(y).ravel()
    n, p = X.shape
    if nclass is None:
        nclass = int(y_np.max()) + 1
    C = int(nclass)
    if C < 2:
        raise ValueError("need at least 2 classes")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize, intercept)
    Xs = Xa[:, 1:] if intercept else Xa
    q = Xa.shape[1]
    yj = torch.as_tensor(y_np.astype(np.float32), dtype=dtype, device=dev)
    Yoh = torch.nn.functional.one_hot(yj.to(torch.int64), C).to(dtype)

    if lambdas is not None:
        lams = _user_grid(lambdas, dtype, dev)
    else:
        # The serial driver's grid rule (models/multinomial.py).
        pi0 = (torch.mean(Yoh, dim=0) if intercept
               else torch.full((C,), 1.0 / C, dtype=dtype, device=dev))
        G0 = Xs.mT @ (pi0[None, :] - Yoh) / n
        if grouped:
            lam0 = 1.001 * torch.max(torch.sqrt(torch.sum(G0 * G0, dim=1)))
        else:
            lam0 = torch.max(torch.abs(G0)) / max(alpha, 1e-3)
        lams = _grid(lam0, lambda_min_ratio, nlambda)

    Xb, yb, _ = _partition_rows(Xa, yj, W)
    solver = partial(
        _consensus_solve, nworkers=W,
        make_x_update=partial(_mn_x_update, nclass=C, n_total=n,
                              newton_steps=int(newton_steps)),
        master_prox=_mn_master_prox(W, float(alpha), pen_mask, q, C,
                                    bool(grouped)),
        # Per-class curvature scale 1/(4C) (the serial default), split
        # over W workers.
        auto_rho=lambda lam_first: 1.0 / (4.0 * C * W),
        mesh=mesh)
    zeros = torch.zeros((W, q * C), dtype=dtype, device=dev)
    coefs_flat, niter, _, _ = _run_consensus(
        Xb, yb, lams, rho, maxit, eps_abs, eps_rel, solver=solver,
        init=(zeros, zeros, zeros[0]))
    beta0, coef = mn_recover(coefs_flat.reshape(-1, q, C), sd_x, mean_x, C,
                             intercept)
    return MNPathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def parallel_multitask_lasso_path(
        X, Y, *, nworkers: Optional[int] = None, mesh=None, lambdas=None,
        nlambda: int = 50, lambda_min_ratio: float = 1e-2,
        alpha: float = 1.0, standardize: bool = True,
        intercept: bool = True, maxit: int = 10000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0,
        trace_len: Optional[int] = None, penalty: str = "rows",
        dtype=torch.float32, device="cuda"):
    """Consensus multi-task Lasso: per-worker cached ridge solves with a
    matrix right-hand side (tall direct or wide Woodbury), the master the
    row-norm prox, or the SVT trace-norm prox with ``penalty="nuclear"``;
    the reduction is p*K + 3 long.  Converges to
    :func:`admm_tpu_torch.multitask_lasso_path`.  As in the JAX package
    the result carries no trace (``trace_len`` is accepted and ignored)."""
    from ..models.multitask import (MTPathResult, _mt_lambda0, mt_recover,
                                    mt_standardize)

    if penalty not in ("rows", "nuclear"):
        raise ValueError("penalty must be 'rows' or 'nuclear'")
    if penalty == "nuclear" and alpha != 1.0:
        raise ValueError("alpha is a row concept; the nuclear penalty "
                         "does not support it")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(X, device))
    X = _as_tensor(X, dtype, _call_device(mesh, device))
    Y = _as_tensor(Y, dtype, X.device)
    if Y.dim() != 2:
        raise ValueError("Y must be (n, K)")
    n, p = X.shape
    K = Y.shape[1]
    Xs, Ys, sd_x, sd_y, mean_x, mean_y, _ = mt_standardize(
        X, Y, standardize_x=standardize, intercept=intercept)
    lam0 = _mt_lambda0(Xs, Ys, alpha=alpha, penalty=penalty) / n
    if lambdas is not None:
        lams = _user_grid(lambdas, dtype, X.device)
    else:
        lams = _grid(lam0, lambda_min_ratio, nlambda)
    ilams = lams * n

    Xb, Yb, rows_w = _partition_rows(Xs, Ys, W)
    solver = partial(
        _consensus_solve, nworkers=W,
        make_x_update=partial(_mt_x_update, ntask=K,
                              tall_block=rows_w >= p),
        master_prox=(_mt_nuclear_master_prox(W, p, K)
                     if penalty == "nuclear"
                     else _mt_master_prox(W, p, K, float(alpha))),
        # The consensus-lasso rule on the internal scale
        # (reference: src/PADMMLasso.h:199-200).
        auto_rho=lambda lam_first: lam_first / W,
        # The SVT's SVD reads its error flag on the host.
        graph_safe=penalty == "rows", mesh=mesh)
    zeros = torch.zeros((W, p * K), dtype=dtype, device=X.device)
    coefs_flat, niter, _, _ = _run_consensus(
        Xb, Yb, ilams, rho, maxit, eps_abs, eps_rel, solver=solver,
        init=(zeros, zeros, zeros[0]))
    beta0, coef = mt_recover(coefs_flat.reshape(-1, p, K), sd_x, sd_y,
                             mean_x, mean_y)
    return MTPathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


__all__ = [
    "parallel_lasso_path", "parallel_enet_path",
    "parallel_group_lasso_path", "parallel_slope_path",
    "parallel_constrained_lasso_path", "parallel_zerosum_lasso_path",
    "parallel_bp_fit", "parallel_glm_lasso_path",
    "parallel_logistic_lasso_path", "parallel_huber_lasso_path",
    "parallel_poisson_lasso_path", "parallel_multinomial_lasso_path",
    "parallel_multitask_lasso_path",
]
