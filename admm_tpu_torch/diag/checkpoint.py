"""Checkpoint / resume for lambda-path solves (counterpart of
``admm_tpu/diag/checkpoint.py``).

The reference has no cross-process checkpointing; *within* a run the
lambda-path warm-start protocol is its resume mechanism (reference:
src/ADMMLassoTall.h:219-230).  A path's whole solver state is a
``NamedTuple`` of tensors (:class:`~admm_tpu_torch.core.engine.ADMMState`,
or a family's tuple of them), so a path is solved in chunks of lambdas,
the terminal state of each chunk is written to disk, and a crashed run
resumes from it and ends with the bits of an uninterrupted one.  What is
derived from the data (standardization, Gram matrices, factorizations,
auto-rho) is a deterministic function of (X, y, options) and is rebuilt
on resume, not stored.

Usage::

    res = checkpointed_lasso_path(X, y, lambdas=lams,
                                  checkpoint="run.npz", chunk_size=10)

If the process dies mid-path, the same call again skips the completed
chunks and returns what one uninterrupted call would have.

The file is the JAX package's ``.npz`` layout (``state__{i}``,
``state__{i}__none``, then the extras), so a state saved by either
package loads in the other.  Each driver takes the JAX signature with
``dtype=torch.float32`` and ``device`` ("cuda" by default; tensors stay
on their own device).  The drivers run the generic engines of
:mod:`admm_tpu_torch.core.engine` chunk by chunk through
``models/lasso.py::_scan_path``, never a kernel of
:mod:`admm_tpu_torch.kernels`, as the JAX drivers never run a Pallas
kernel; the consensus driver runs ``parallel/consensus.py``'s loop, a
CUDA graph per chunk on the card.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..core.engine import col, make_admm_solver, make_state, warm_start
from ..data.standardize import recover
from ..data.standardize import standardize as _standardize
from ..parallel.mesh import barrier, is_writer
from ..models.lasso import (PathResult, _as_tensor, _scan_path, _tall_engine,
                            _wide_engine)

_STATE_PREFIX = "state__"


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------

def _leaves(tree):
    """Leaves in the JAX flattening order of a state: tuples
    (``NamedTuple`` fields in order) element by element; a tensor and
    ``None`` are leaves."""
    if not isinstance(tree, tuple):
        return [tree]
    return [leaf for child in tree for leaf in _leaves(child)]


def _rebuild(like, leaves):
    """``like``'s structure around the leaves taken from the iterator."""
    if not isinstance(like, tuple):
        return next(leaves)
    kids = [_rebuild(child, leaves) for child in like]
    return type(like)(*kids) if hasattr(like, "_fields") else tuple(kids)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_pytree(path: str, tree, **extras) -> None:
    """Write a state, a tuple tree of tensors, plus named numpy extras to
    ``.npz``.

    Leaves are keyed by their flattened position; ``None`` leaves are
    recorded so the structure round-trips.  The write is atomic (a temp
    file, then ``os.replace``), so a crash mid-save never corrupts an
    existing checkpoint.
    """
    payload = {}
    for i, leaf in enumerate(_leaves(tree)):
        key = f"{_STATE_PREFIX}{i}"
        payload[key] = np.asarray(False) if leaf is None else _host(leaf)
        payload[key + "__none"] = np.asarray(leaf is None)
    payload.update(extras)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, like):
    """Load a tree saved by :func:`save_pytree`, shaped ``like`` the
    template: each leaf goes to the device and dtype of ``like``'s leaf
    at its position.  Returns ``(tree, extras_dict)``."""
    template = _leaves(like)
    with np.load(path) as data:
        leaves = []
        i = 0
        while f"{_STATE_PREFIX}{i}" in data:
            if bool(data[f"{_STATE_PREFIX}{i}__none"]):
                leaves.append(None)
            else:
                leaves.append(np.array(data[f"{_STATE_PREFIX}{i}"]))
            i += 1
        extras = {k: data[k] for k in data.files
                  if not k.startswith(_STATE_PREFIX)}
    if len(leaves) != len(template):
        raise ValueError(f"checkpoint {path!r} holds {len(leaves)} leaves, "
                         f"the template {len(template)}")
    out = []
    for saved, ref in zip(leaves, template):
        if (saved is None) != (ref is None):
            raise ValueError(f"checkpoint {path!r} does not match the "
                             "template's structure")
        out.append(None if ref is None else torch.from_numpy(saved).to(
            device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(out)), extras


# ---------------------------------------------------------------------------
# Problem identity and the chunk loop
# ---------------------------------------------------------------------------

def _fingerprint(Xs, ys, lams, alpha, maxit, eps_abs, eps_rel, rho,
                 standardize_x, intercept, enet_scale, *, model="lasso",
                 extra_arrays=()):
    """Problem identity, so a checkpoint is never resumed against another
    problem, model or options.  Every option that changes the solve is in
    it, the static flags and the ``model`` tag included; the arrays the
    solve runs on (the data, the full grid, each driver's
    ``extra_arrays``) enter as a SHA-256 over their bytes, copied to the
    host once per call.  The 256-bit digest rides as four float64 lanes
    after the option lanes."""
    h = hashlib.sha256()
    h.update(model.encode())
    for arr in (Xs, ys, lams) + tuple(extra_arrays):
        a = np.ascontiguousarray(_host(arr))
        h.update(str(a.dtype).encode())
        h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
        h.update(a.tobytes())
    digest = np.frombuffer(h.digest(), dtype=np.uint64).astype(np.float64)
    return np.concatenate([np.array([
        Xs.shape[0], Xs.shape[1], lams.shape[0],
        float(alpha), float(maxit), float(eps_abs), float(eps_rel),
        float(rho), float(standardize_x), float(intercept),
        float(enet_scale),
    ], dtype=np.float64), digest])


def _validate_chunking(chunk_size, lambdas):
    if int(chunk_size) < 1:
        raise ValueError("chunk_size must be >= 1")
    lambdas = _host(lambdas)
    if lambdas.size < 1:
        raise ValueError("lambdas must be non-empty")
    return int(chunk_size), lambdas


def _grid(lambdas, dtype, device):
    """The user's grid in ``dtype`` on ``device``, decreasing."""
    lams = torch.as_tensor(np.asarray(lambdas).reshape(-1), dtype=dtype,
                           device=device)
    return torch.sort(lams, descending=True).values


def _sync(tree) -> None:
    """Wait for the device that holds the state (``block_until_ready``)."""
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


def _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel, *, fp,
                  checkpoint, chunk_size, _stop_after_chunks=None,
                  mesh=None):
    """The chunk/save/resume loop of every checkpointed driver.
    ``segment(st, ilams_chunk, maxit, eps_abs, eps_rel) -> (st, coefs,
    niter)`` advances the warm-start chain over one chunk, the outputs'
    leading axis the chunk's lambdas.  Returns ``(coefs, niter)`` on the
    grid's device, or None once ``_stop_after_chunks`` chunks ran (the
    fault-injection hook of the tests).  Deletes the checkpoint when the
    path is complete.  On a ``mesh`` of several processes the state is
    replicated on every one; only the process of position 0 writes and
    deletes the file, and the others wait for it (``mesh.barrier``), so
    every process resumes from the same chunk."""
    nlam = int(ilams.shape[0])
    k_done = 0
    coefs_done, niter_done = [], []
    st = st0
    if os.path.exists(checkpoint):
        with np.load(checkpoint) as data:
            fp_old = np.asarray(data["fingerprint"])
        # The trailing 4 lanes are the content digest, compared exactly
        # (allclose's rtol would drop ~47 bits of a ~1e19 lane); the
        # option lanes keep the float tolerance.  Checked before the state
        # is read: another problem's state may not fit this template.
        if (fp_old.shape != fp.shape
                or not np.array_equal(fp_old[-4:], fp[-4:])
                or not np.allclose(fp_old[:-4], fp[:-4])):
            raise ValueError(
                f"checkpoint {checkpoint!r} belongs to a different "
                "problem/options; refusing to resume")
        st, extras = load_pytree(checkpoint, st0)
        k_done = int(extras["k_done"])
        coefs_done = [extras["coefs"]]
        niter_done = [extras["niter"]]

    chunks_run = 0
    while k_done < nlam:
        if (_stop_after_chunks is not None
                and chunks_run >= _stop_after_chunks):
            return None
        hi = min(k_done + chunk_size, nlam)
        st, coefs, niter = segment(st, ilams[k_done:hi], maxit, eps_abs,
                                   eps_rel)
        _sync(st)
        # A resumed run starts from fresh contiguous tensors (np.load):
        # the live state is copied into fresh ones too, so both runs hand
        # the next chunk's products the same layouts and alignments.
        st = _rebuild(st, iter([
            None if a is None
            else a.clone(memory_format=torch.contiguous_format)
            for a in _leaves(st)]))
        coefs_done.append(_host(coefs))
        niter_done.append(_host(niter))
        k_done = hi
        chunks_run += 1
        if is_writer(mesh):
            save_pytree(checkpoint, st, fingerprint=fp,
                        k_done=np.asarray(k_done),
                        coefs=np.concatenate(coefs_done, axis=0),
                        niter=np.concatenate(niter_done, axis=0))
        barrier(mesh)

    dev = ilams.device
    coefs = torch.from_numpy(np.concatenate(coefs_done, axis=0)).to(dev)
    niter = torch.from_numpy(np.concatenate(niter_done, axis=0)).to(dev)
    if is_writer(mesh) and os.path.exists(checkpoint):
        os.unlink(checkpoint)
    barrier(mesh)
    return coefs, niter


def _segment(solve, report, refresh=None):
    """The chunk step of a family's engine triple: ``_scan_path`` from
    the carried state."""
    return lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er, refresh=refresh)[:3]


def _xy(X, y, dtype, device):
    X = _as_tensor(X, dtype, device)
    return X, _as_tensor(y, dtype, X.device).reshape(-1)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def checkpointed_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        alpha: float = 1.0, standardize_x: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        _enet_scale: bool = False, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Lasso/Enet lambda path solved in resumable chunks.

    The same warm-start chain as :func:`admm_tpu_torch.lasso_path` with
    explicit ``lambdas`` (n > p the tall engine, otherwise the wide one),
    cut at chunk boundaries: after every ``chunk_size`` lambdas the solver
    state and the results so far are written to ``checkpoint``.  On a
    rerun the completed chunks are skipped; the file is deleted once the
    path is complete.  ``_stop_after_chunks`` is a fault-injection hook
    for tests: the run is abandoned (returning None) after that many
    chunks.
    """
    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    n, p = X.shape
    Xs, ys, stats = _standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n / stats.scale_y
    if n > p:
        st0, solve, report = _tall_engine(Xs, ys, ilams[0], rho, alpha)
    else:
        st0, solve, report = _wide_engine(Xs, ys, ilams[0], rho, alpha,
                                          _enet_scale)
    fp = _fingerprint(Xs, ys, ilams, alpha, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, _enet_scale)
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_dantzig_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Dantzig-selector lambda path in resumable chunks (the protocol of
    :func:`checkpointed_lasso_path` on ``models/dantzig.py::
    _dantzig_engine``)."""
    from ..models.dantzig import _dantzig_engine

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    n = X.shape[0]
    Xs, ys, stats = _standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n / stats.scale_y
    st0, solve, report = _dantzig_engine(Xs, ys, ilams[0], rho)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False, model="dantzig")
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_group_lasso_path(
        X, y, groups, *, lambdas, checkpoint: str, chunk_size: int = 10,
        weights=None, standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Group-Lasso lambda path in resumable chunks.  ``groups`` and
    ``weights`` enter the fingerprint (another grouping refuses to
    resume)."""
    from ..models.grouplasso import (_gl_tall_engine, _gl_wide_engine,
                                     _GroupProblem, normalize_groups)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    n, p = X.shape
    groups_t, weights_t = normalize_groups(groups, p, weights, dtype,
                                           X.device)
    gp = _GroupProblem(groups=groups_t, weights=weights_t)
    Xs, ys, stats = _standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n / stats.scale_y
    engine = _gl_tall_engine if n > p else _gl_wide_engine
    st0, solve, report = engine(Xs, ys, ilams[0], rho, gp)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False, model="group",
                      extra_arrays=(groups_t, weights_t))
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_glm_path(
        X, y, family, *, lambdas, checkpoint: str, chunk_size: int = 10,
        alpha: float = 1.0, standardize: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        newton_steps: int = 2, hessian: str = "auto", weights=None,
        dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Penalized-GLM lambda path (any family) in resumable chunks, on
    ``models/glm.py::_glm_engine``.  ``hessian="auto"`` is "fixed" for a
    bounded family and "exact" otherwise: the adaptive majorizer's
    per-lambda refresh anchors on in-chunk warm starts and its aux does
    not cross a chunk boundary, so "adaptive" raises.  The family name and
    parameter, the Hessian mode, ``newton_steps`` and the observation
    weights enter the fingerprint."""
    from ..models.glm import GLMFamily, _glm_engine, prep_design, recover_glm

    fam = family() if not isinstance(family, GLMFamily) else family
    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1] for GLM paths")
    if hessian == "auto":
        hessian = "fixed" if fam.curvature_bound is not None else "exact"
    if hessian == "adaptive":
        raise ValueError("checkpointed GLM paths support hessian="
                         "'fixed' or 'exact' (the adaptive majorizer's "
                         "aux does not cross chunk boundaries)")
    if hessian not in ("fixed", "exact"):
        raise ValueError(f"unknown hessian mode {hessian!r}")
    if hessian == "fixed" and fam.curvature_bound is None:
        raise ValueError(f"family {fam.name!r} has unbounded curvature; "
                         "hessian='fixed' is not available")
    X, y = _xy(X, y, dtype, device)
    n = X.shape[0]
    w = None
    if weights is not None:
        w = _as_tensor(weights, dtype, X.device).reshape(-1)
        w = w * (n / torch.sum(w))
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize, intercept,
                                             weights=w)
    # GLM paths run on user-scale lambdas (the 1/n rides in the loss).
    lams = _grid(lambdas, dtype, X.device)
    st0, solve, report, _ = _glm_engine(
        Xa, y, fam, lams[0], rho, pen_mask, alpha, int(newton_steps),
        obs_w=w, hessian=hessian)
    fp = _fingerprint(
        Xa, y, lams, alpha, maxit, eps_abs, eps_rel, rho, standardize,
        intercept, False,
        # fam.param tells parametrized likelihoods apart (huber's M).
        model=(f"glm-{fam.name}-p{float(fam.param)!r}-{hessian}"
               f"-ns{int(newton_steps)}"),
        extra_arrays=() if w is None else (w,))
    out = _chunked_scan(st0, _segment(solve, report), lams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs_a, niter = out
    beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_gen_lasso_path(
        X, y, D, *, lambdas, checkpoint: str, chunk_size: int = 10,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Generalized-Lasso lambda path in resumable chunks.  The penalty
    matrix ``D`` enters the fingerprint."""
    from ..models.genlasso import _genlasso_engine, center_weight

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    D = _as_tensor(D, dtype, X.device)
    n = X.shape[0]
    Xs, ys, mean_x, mean_y = center_weight(X, y, None, intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n
    st0, solve, report = _genlasso_engine(Xs, ys, D, ilams[0], rho)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      False, intercept, False, model="genlasso",
                      extra_arrays=(D,))
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    return PathResult(lambdas=lams, beta0=mean_y - coefs @ mean_x,
                      coef=coefs, niter=niter)


def checkpointed_parallel_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        nworkers: Optional[int] = None, mesh=None, alpha: float = 1.0,
        standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, _enet_scale: bool = False, dtype=torch.float32,
        device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Consensus (parallel) Lasso/Enet lambda path in resumable chunks.

    The resume state is ``(x (W, p), y (W, p), z (p,), rho)``; each chunk
    is one ``parallel/consensus.py::_run_consensus`` from it (a CUDA graph
    captured per chunk on the card).  rho is set once at the path's first
    lambda (reference: src/PADMMLasso.h:199-200) and carried through the
    checkpoint.  ``mesh`` deals the workers over its positions as in
    ``parallel_lasso_path``; the state is replicated on every process at
    each chunk boundary (the workers' rows are gathered every iteration),
    so the file holds it whole, and a resume hands each position its own
    workers again.
    """
    from ..parallel.consensus import (_call_device, _consensus_lasso_solver,
                                      _device_of, _partition_rows,
                                      _resolve_mesh, _run_consensus)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    W, mesh = _resolve_mesh(nworkers, mesh, _device_of(X, device))
    X, y = _xy(X, y, dtype, _call_device(mesh, device))
    n, p = X.shape
    Xs, ys, stats = _standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n / stats.scale_y
    Xb, yb, rows_w = _partition_rows(Xs, ys, W)
    solver = _consensus_lasso_solver(W, rows_w >= p, float(alpha),
                                     mesh=mesh)
    fp = _fingerprint(Xs, ys, ilams, alpha, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, _enet_scale,
                      model=f"consensus-lasso-W{W}")
    zeros = torch.zeros((W, p), dtype=dtype, device=X.device)
    st0 = (zeros, zeros, zeros[0],
           torch.tensor(rho, dtype=dtype, device=X.device))

    def segment(st, il, m, ea, er):
        x, yd, z, rho_c = st
        coefs, niter, state, _ = _run_consensus(
            Xb, yb, il, rho_c, m, ea, er, solver=solver, init=(x, yd, z))
        return state, coefs, niter

    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel, fp=fp,
                        checkpoint=checkpoint, chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks, mesh=mesh)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_multitask_lasso_path(
        X, Y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, penalty: str = "rows", dtype=torch.float32,
        device="cuda", _stop_after_chunks: Optional[int] = None):
    """Multi-task Lasso lambda path in resumable chunks (the flattened
    (p, K) state of ``models/multitask.py::_mt_engine``).
    ``penalty="nuclear"`` checkpoints the reduced-rank path; the penalty
    tag enters the fingerprint."""
    if penalty not in ("rows", "nuclear"):
        raise ValueError("penalty must be 'rows' or 'nuclear'")
    from ..models.multitask import (MTPathResult, _mt_engine, mt_recover,
                                    mt_standardize)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = _as_tensor(X, dtype, device)
    Y = _as_tensor(Y, dtype, X.device)
    if Y.dim() != 2 or Y.shape[0] != X.shape[0]:
        raise ValueError("Y must be an (n, K) matrix")
    n = X.shape[0]
    Xs, Ys, sd_x, sd_y, mean_x, mean_y, _ = mt_standardize(
        X, Y, standardize_x=standardize_x, intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n
    st0, solve, report = _mt_engine(Xs, Ys, ilams[0], rho, penalty=penalty)
    fp = _fingerprint(Xs, Ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False,
                      model=f"multitask-{penalty}")
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = mt_recover(coefs, sd_x, sd_y, mean_x, mean_y)
    return MTPathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_multinomial_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        nclass: Optional[int] = None, alpha: float = 1.0,
        grouped: bool = False, standardize_x: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        newton_steps: int = 2, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None):
    """Sparse multinomial lambda path in resumable chunks.  The class
    count, the penalty style (``grouped``) and ``newton_steps`` enter the
    fingerprint's model tag; the labels enter through the hashed one-hot
    response."""
    from ..models.glm import prep_design
    from ..models.multinomial import MNPathResult, _mn_engine, mn_recover

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = _as_tensor(X, dtype, device)
    y_np = _host(y).ravel()
    C = int(y_np.max()) + 1 if nclass is None else int(nclass)
    Yoh = torch.nn.functional.one_hot(
        torch.as_tensor(y_np.astype(np.int64), device=X.device), C).to(dtype)
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize_x, intercept)
    lams = _grid(lambdas, dtype, X.device)
    st0, solve, report = _mn_engine(Xa, Yoh, lams[0], rho, pen_mask, alpha,
                                    bool(grouped), int(newton_steps))
    fp = _fingerprint(
        Xa, Yoh, lams, alpha, maxit, eps_abs, eps_rel, rho, standardize_x,
        intercept, False,
        model=(f"multinomial-C{C}-{'grouped' if grouped else 'enet'}"
               f"-ns{int(newton_steps)}"))
    out = _chunked_scan(st0, _segment(solve, report), lams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs_a, niter = out
    beta0, coef = mn_recover(coefs_a, sd_x, mean_x, C, intercept)
    return MNPathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_slope_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        lam_seq=None, q: float = 0.1, standardize_x: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """SLOPE scale path (``lambdas`` are the t values) in resumable
    chunks.  The penalty sequence (Benjamini-Hochberg at ``q`` unless
    given) is validated as ``slope_path`` does and enters the
    fingerprint."""
    from ..models.slope import _check_lam_seq, _slope_engine

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    n, p = X.shape
    lam_t = torch.as_tensor(_check_lam_seq(lam_seq, q, p), dtype=dtype,
                            device=X.device)
    Xs, ys, stats = _standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    ts = _grid(lambdas, dtype, X.device)
    its = ts * n / stats.scale_y
    st0, solve, report = _slope_engine(Xs, ys, lam_t, its[0], rho)
    fp = _fingerprint(Xs, ys, its, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False, model="slope",
                      extra_arrays=(lam_t,))
    out = _chunked_scan(st0, _segment(solve, report), its, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=ts, beta0=beta0, coef=coef, niter=niter)


def checkpointed_glasso_path(
        X=None, *, cov=None, lambdas, checkpoint: str,
        chunk_size: int = 5, weights=None,
        penalize_diagonal: bool = False, assume_centered: bool = False,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, xupdate: str = "newton", dtype=torch.float32,
        device="cuda", _stop_after_chunks: Optional[int] = None):
    """Graphical-lasso lambda path in resumable chunks: the warm-started
    scan over the (p, p) matrix state of ``models/glasso.py``.  The
    adaptive rho rides the saved state.  The covariance, the penalty
    convention and ``xupdate`` ("newton" or "eigh", validated as
    ``glasso_path`` does) enter the fingerprint."""
    from ..models.glasso import (GlassoResult, _glasso_engine, _pen_mask,
                                 empirical_covariance)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    if (X is None) == (cov is None):
        raise ValueError("pass exactly one of X or cov")
    if xupdate not in ("newton", "eigh"):
        raise ValueError("xupdate must be 'newton' or 'eigh'")
    if cov is not None:
        S = _as_tensor(cov, dtype, device)
        if S.dim() != 2 or S.shape[0] != S.shape[1]:
            raise ValueError("cov must be a square (p, p) matrix")
    else:
        S = empirical_covariance(X, weights, dtype=dtype, device=device,
                                 assume_centered=assume_centered)
    p = S.shape[-1]
    pen_mask = _pen_mask(p, bool(penalize_diagonal), dtype, S.device)
    lams = _grid(lambdas, dtype, S.device)
    st0, solve, report = _glasso_engine(S, pen_mask, lams[0], rho, xupdate)
    fp = _fingerprint(S, torch.zeros((1,), dtype=dtype), lams, 1.0, maxit,
                      eps_abs, eps_rel, rho, False, False,
                      penalize_diagonal, model="glasso-" + xupdate)
    out = _chunked_scan(st0, _segment(solve, report), lams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    precs, niter = out
    return GlassoResult(lambdas=lams, precision=precs, cov=S, niter=niter)


def checkpointed_svm_path(
        X, y, *, Cs, checkpoint: str, chunk_size: int = 5,
        loss: str = "squared_hinge", intercept: bool = True,
        weights=None, maxit: int = 20000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0, dtype=torch.float32,
        device="cuda", _stop_after_chunks: Optional[int] = None):
    """Linear-SVM C path in resumable chunks (the warm-started scan of
    ``models/svm.py``).  The loss, the intercept flag, the labels and the
    row weights enter the fingerprint; auto-rho comes from the whole C
    grid, as in the one-shot path, so chunking never changes the shared
    factorization.  The result carries the original class labels."""
    from ..models.svm import SVMResult, _as_sign, _svm_engine

    chunk_size, Cs_np = _validate_chunking(chunk_size, Cs)
    if loss not in ("hinge", "squared_hinge"):
        raise ValueError("loss must be 'hinge' or 'squared_hinge'")
    if np.any(Cs_np <= 0) or not np.all(np.isfinite(Cs_np)):
        raise ValueError("Cs must be positive and finite")
    ysign, classes = _as_sign(y)
    X = _as_tensor(X, dtype, device)
    n, p = X.shape
    if ysign.shape[0] != n:
        raise ValueError("x and y must have the same number of rows")
    obs_w = (torch.ones((n,), dtype=dtype, device=X.device) if weights is None
             else _as_tensor(weights, dtype, X.device).reshape(-1))
    Cs_t = _grid(Cs_np, dtype, X.device)
    ysign_t = torch.as_tensor(ysign, dtype=dtype, device=X.device)
    st0, solve, report = _svm_engine(X, ysign_t, Cs_t, obs_w, loss,
                                     bool(intercept), rho)
    fp = _fingerprint(X, ysign_t, Cs_t, 1.0, maxit, eps_abs, eps_rel, rho,
                      False, intercept, False, model=f"svm-{loss}",
                      extra_arrays=(obs_w,))
    out = _chunked_scan(st0, _segment(solve, report), Cs_t, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    vs, niter = out
    if intercept:
        coefs, b = vs[:, :p], vs[:, p]
    else:
        coefs = vs
        b = torch.zeros((Cs_t.shape[0],), dtype=dtype, device=X.device)
    return SVMResult(Cs=Cs_t, coef=coefs, intercept=b, niter=niter,
                     classes=classes)


def checkpointed_cox_path(
        X, time, event, *, lambdas, checkpoint: str, chunk_size: int = 10,
        alpha: float = 1.0, standardize: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, newton_steps: int = 2, weights=None,
        offset=None, strata=None, start=None, dtype=torch.float32,
        device="cuda", _stop_after_chunks: Optional[int] = None):
    """Cox partial-likelihood lambda path in resumable chunks: the
    warm-started scan of ``models/cox.py`` with its per-lambda adaptive
    majorizer (``_scan_path``'s ``refresh``), so the chunked run equals
    the one-shot scan.  The sorted times (which define the risk sets), the
    weights, offset, strata codes and entry times enter the
    fingerprint."""
    from ..models.cox import (CoxPathResult, _check_survival, _cox_majorizer_inv,
                              _cox_ops, _cox_prep, _cox_standardize)
    from ..models.cox import _host as _flat_host

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    X = _as_tensor(X, dtype, device)
    dev = X.device
    t_np, d_np = _flat_host(time), _flat_host(event)
    n, p = X.shape
    st_np = _check_survival(n, t_np, d_np, start)
    order, first, last, seg, ext = _cox_prep(t_np, strata, st_np, dev)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    extra = [f(t_np[order])]
    tag = "cox"
    if strata is not None:
        codes = np.unique(np.asarray(strata).ravel(), return_inverse=True)[1]
        extra.append(f(codes[order].astype(np.float64)))
        tag += "-strata"
    if st_np is not None:
        extra.append(f(st_np[order]))
        tag += "-startstop"
    w = off = None
    if weights is not None:
        w_np = _flat_host(weights)
        if w_np.shape != (n,):
            raise ValueError("weights must have one entry per row")
        if np.any(w_np <= 0):
            raise ValueError("cox weights must be positive (a zero "
                             "weight: drop the row)")
        w = f(w_np[order])
        w = w * (n / torch.sum(w))
        extra.append(w)
    if offset is not None:
        o_np = _flat_host(offset)
        if o_np.shape != (n,):
            raise ValueError("offset must have one entry per row")
        off = f(o_np[order])
        extra.append(off)
    dj = f(d_np[order])
    wc = torch.ones((n,), dtype=dtype, device=dev) if w is None else w
    Xs, sd_x = _cox_standardize(X[torch.as_tensor(order, device=dev)], wc, n,
                                standardize)
    rho_t = torch.tensor(rho if rho > 0 else 0.5, dtype=dtype, device=dev)
    lams = _grid(lambdas, dtype, dev)
    solve = make_admm_solver(
        _cox_ops(Xs, dj, first, last, n, p, alpha, int(newton_steps), None,
                 None, None, off, w, seg, ext), adapt_rho=False)

    def refresh(b):
        return _cox_majorizer_inv(b, Xs, dj, first, last, n, rho_t, w, off,
                                  seg, ext)

    zeros = torch.zeros((p,), dtype=dtype, device=dev)
    # aux is the majorizer's inverse from the first lambda on: the cold
    # state carries one too, so a saved state has the same leaves.
    st0 = make_state(zeros, zeros, zeros, rho_t, lams[0], aux=refresh(zeros))
    fp = _fingerprint(Xs, dj, lams, alpha, maxit, eps_abs, eps_rel, rho,
                      standardize, False, False,
                      model=f"{tag}-ns{int(newton_steps)}",
                      extra_arrays=tuple(extra))
    out = _chunked_scan(st0, _segment(solve, lambda st: st.z, refresh), lams,
                        maxit, eps_abs, eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs_s, niter = out
    return CoxPathResult(lambdas=lams, coef=coefs_s / sd_x[None, :],
                         niter=niter)


def checkpointed_sqrt_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        standardize: bool = True, intercept: bool = True, weights=None,
        maxit: int = 10000, eps_abs: float = 1e-6, eps_rel: float = 1e-6,
        rho: float = -1.0, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Square-root-lasso path in resumable chunks: the concomitant
    warm-started scan of ``models/sqrtlasso.py``, whose saved state
    carries both the inner FADMM iterates and sigma."""
    from ..models.sqrtlasso import _sqrt_concomitant_scan_setup, _sqrt_prepare

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    Xs, ys, sd_x, mean_x, mean_y = _sqrt_prepare(
        X, y, w, standardize_x=standardize, intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    carry0, advance = _sqrt_concomitant_scan_setup(Xs, ys, lams[0], rho)
    fp = _fingerprint(Xs, ys, lams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize, intercept, False, model="sqrtlasso")
    out = _chunked_scan(carry0, advance, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint, chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    coef = coefs / sd_x[None, :]
    return PathResult(lambdas=lams, beta0=mean_y - coef @ mean_x, coef=coef,
                      niter=niter)


def checkpointed_constrained_lasso_path(
        X, y, C, d=None, *, lambdas, checkpoint: str,
        chunk_size: int = 10, intercept: bool = True, weights=None,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Equality-constrained lasso path in resumable chunks: the
    warm-started scan on the block-eliminated KKT engine of
    ``models/conlasso.py``.  The constraint matrix and right-hand side
    enter the fingerprint."""
    from ..models.conlasso import _conlasso_engine
    from ..models.genlasso import center_weight

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    C = torch.atleast_2d(_as_tensor(C, dtype, X.device))
    if C.shape[1] != X.shape[1]:
        raise ValueError("C must be (m, ncol(x))")
    d = (torch.zeros((C.shape[0],), dtype=dtype, device=X.device)
         if d is None else _as_tensor(d, dtype, X.device).reshape(-1))
    n = X.shape[0]
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    Xs, ys, mean_x, mean_y = center_weight(X, y, w, intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n
    st0, solve, report = _conlasso_engine(Xs, ys, C, d, ilams[0], rho)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      False, intercept, False, model="conlasso",
                      extra_arrays=(C, d))
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    return PathResult(lambdas=lams, beta0=mean_y - coefs @ mean_x,
                      coef=coefs, niter=niter)


def checkpointed_relaxed_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        gammas=(0.0, 0.25, 0.5, 0.75, 1.0), alpha: float = 1.0,
        standardize: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None):
    """Relaxed-lasso (lambda, gamma) grid in resumable chunks: the chunks
    advance the lasso warm-start chain; the unpenalized support refits
    (``models/relaxed.py::_masked_refits``) and the affine gamma blend run
    once on the finished path.  The gamma grid enters the fingerprint."""
    from ..models.relaxed import _blend, _masked_refits

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    n, p = X.shape
    gam = torch.sort(_as_tensor(gammas, dtype, X.device).reshape(-1)).values
    Xs, ys, stats = _standardize(X, y, standardize_x=standardize,
                                intercept=intercept)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n / stats.scale_y
    if n > p:
        st0, solve, report = _tall_engine(Xs, ys, ilams[0], rho, alpha)
    else:
        st0, solve, report = _wide_engine(Xs, ys, ilams[0], rho, alpha,
                                          False)
    fp = _fingerprint(Xs, ys, ilams, alpha, maxit, eps_abs, eps_rel, rho,
                      standardize, intercept, False, model="relaxed",
                      extra_arrays=(gam,))
    out = _chunked_scan(st0, _segment(solve, report), ilams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize,
                          intercept=intercept)
    refit_beta0, refit_coef = _masked_refits(
        X, y, (torch.abs(coefs) > 0).to(dtype), None,
        standardize_x=standardize, intercept=intercept)
    return _blend(gam, PathResult(lambdas=lams, beta0=beta0, coef=coef,
                                  niter=niter), refit_beta0, refit_coef)


def checkpointed_quantile_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        tau=0.5, standardize: bool = True, intercept: bool = True,
        weights=None, maxit: int = 20000, eps_abs: float = 1e-6,
        eps_rel: float = 1e-6, rho: float = -1.0, dtype=torch.float32,
        device="cuda", _stop_after_chunks: Optional[int] = None):
    """Penalized quantile (tau x lambda) grid in resumable chunks: one
    lane per tau (the JAX package's ``vmap``), the lanes' warm-started
    scans advancing together over the shared explicit lambda grid.  The
    tau grid and the weights enter the fingerprint."""
    from ..core.engine import make_batched_solver, make_fadmm_solver
    from ..models.quantile import (QuantilePathResult, _cold_lanes,
                                   _quantile_ops, _quantile_prepare,
                                   _quantile_recover, _quantile_setup)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X, y = _xy(X, y, dtype, device)
    n = X.shape[0]
    taus = _as_tensor(tau, dtype, X.device).reshape(-1)
    t_np = _host(taus)
    if np.any(t_np <= 0) or np.any(t_np >= 1):
        raise ValueError("tau values must be in (0, 1)")
    T = taus.shape[0]
    w = None if weights is None else _as_tensor(weights, dtype, X.device)
    Xs, ys, wrow, sd_x, sd_y, mean_x, mean_y = _quantile_prepare(
        X, y, w, standardize_x=standardize, intercept=intercept)
    Xa, pf, q, Minv, rho_t = _quantile_setup(Xs, intercept, rho)
    lams = _grid(lambdas, dtype, X.device)
    ilams = lams * n / sd_y
    solve = make_batched_solver(make_fadmm_solver(
        _quantile_ops(Xa, ys, Minv, wrow, pf, n, q, col(taus)),
        adapt_rho=False))
    st0 = _cold_lanes(T, q, n, rho_t, ilams[0].expand(T))
    fp = _fingerprint(Xa, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize, intercept, False, model="quantile",
                      extra_arrays=(taus, wrow))

    def segment(sts, il, m, ea, er):
        coefs, niter = [], []
        for lam in il:
            sts = solve(warm_start(sts, lam), m, ea, er)
            coefs.append(sts.z[:, n:])
            niter.append(sts.it)
        # The chunk loop concatenates along the leading (lambda) axis.
        return sts, torch.stack(coefs), torch.stack(niter)

    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel, fp=fp,
                        checkpoint=checkpoint, chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out                       # (L, T, q), (L, T)
    beta0, coef = _quantile_recover(coefs.transpose(0, 1), intercept, sd_x,
                                    sd_y, mean_x, mean_y)
    return QuantilePathResult(
        taus=taus, lambdas=lams[None, :].expand(T, -1).clone(), beta0=beta0,
        coef=coef, niter=niter.transpose(0, 1).contiguous())


def checkpointed_rpca_path(
        M, *, lambdas, checkpoint: str, chunk_size: int = 3,
        observed=None, rank: Optional[int] = None, power_iters: int = 2,
        maxit: int = 5000, eps_abs: float = 1e-7, eps_rel: float = 1e-6,
        rho: float = -1.0, dtype=torch.float32, device="cuda",
        _stop_after_chunks: Optional[int] = None):
    """PCP sparsity-penalty path in resumable chunks: the warm-started
    scan over the (L, S, Y) matrix state of ``models/rpca.py``, the
    partial SVT's warm basis riding the saved state when ``rank`` is
    given.  The data, the mask, the rank options and the grid enter the
    fingerprint."""
    from ..models.rpca import (_as_matrix, _check_mask, _rpca_engine,
                               _rpca_path_result)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    M = _as_matrix(M, dtype, device)
    M0, mask = _check_mask(M, observed)
    lams = _grid(lambdas, dtype, M.device)
    rank = None if rank is None else int(rank)
    st0, solve, report = _rpca_engine(M0, lams[0], rho, mask, rank,
                                      int(power_iters))
    tag = "rpca" if rank is None else f"rpca-r{rank}-q{int(power_iters)}"
    fp = _fingerprint(M0, torch.zeros((1,), dtype=dtype), lams, 1.0, maxit,
                      eps_abs, eps_rel, rho, False, False, False, model=tag,
                      extra_arrays=() if mask is None else (mask.to(dtype),))
    out = _chunked_scan(st0, _segment(solve, report), lams, maxit, eps_abs,
                        eps_rel, fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    return _rpca_path_result(lams, *out)
