"""Linear Support Vector Machine (counterpart of ``admm_tpu/models/svm.py``;
an extension beyond the reference)::

    minimize_{w, b}  1/2 ||w||^2 + C * sum_i loss(1 - y_i (x_i' w + b))

with ``loss`` the hinge or the squared hinge (sklearn ``LinearSVC``'s
two).  The splitting is over the margins, the LAD solver's range-space
move (reference: src/ADMMLAD.h:20-29): ``A = diag(y) [X, 1]``, ``v = [w;
b]``, ``A v - z = 0`` with ``f(v) = 1/2 ||w||^2`` and ``g(z) = C sum_i
w_i loss(1 - z_i)``.  The x-update is one product against the cached
inverse of ``P + rho A'A``; the z-update is the loss's closed-form prox;
FADMM at a fixed rho, since the factorization depends on it.

The inverse depends on rho only, so every C of the path shares ONE
factorization and the C grid solves as lanes of one engine loop
(``svm_path``).  No kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, col, make_batched_solver,
                           make_fadmm_solver, make_state)
from ..core.prox import l2norm, sqnorm
from ..interop import to_numpy
from ..linalg import chol_inverse, gram
from ..parallel.mesh import blockwise
from .lasso import _as_data, _as_tensor, _batched_cold_states, _scan_path


class SVMResult(NamedTuple):
    """SVM C-path result."""
    Cs: torch.Tensor         # (k,) regularization values (descending)
    coef: torch.Tensor       # (k, p) weight vectors
    intercept: torch.Tensor  # (k,) biases (0 when intercept=False)
    niter: torch.Tensor      # (k,) int32 ADMM iteration counts
    trace: Optional[torch.Tensor] = None
    # The original class labels (negative, positive); predict(type="class")
    # maps back through them.
    classes: Optional[tuple] = None


def hinge_prox(v, scale):
    """prox of ``scale * max(0, 1 - z)`` at v (scale = C w_i / rho)."""
    return torch.where(v >= 1.0, v,
                       torch.where(v <= 1.0 - scale, v + scale,
                                   torch.ones_like(v)))


def sq_hinge_prox(v, scale):
    """prox of ``scale * max(0, 1 - z)^2`` at v: solves ``min
    scale (1 - z)^2 + 1/2 (z - v)^2``."""
    return torch.where(v >= 1.0, v, (v + 2.0 * scale) / (1.0 + 2.0 * scale))


def _svm_ops(A, Minv, loss, obs_w, n, d) -> ProblemOps:
    """A = diag(y) [X, (1)]; v = [w, (b)]; margins z = A v."""
    prox = hinge_prox if loss == "hinge" else sq_hinge_prox

    def next_x(st):
        rhs = (col(st.rho) * st.adj_z - st.adj_y) @ A
        return rhs @ Minv.mT

    def next_z(st, x_new):
        Av = x_new @ A.mT
        v = Av + st.adj_y / col(st.rho)
        return prox(v, col(st.lam) * obs_w / col(st.rho)), Av

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: aux - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.aux),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y @ A),
        dual_residual=lambda st, z_new: st.rho * l2norm((z_new - st.z) @ A),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=d, dim_dual=n,
    )


def _svm_setup(X, ysign, intercept, rho0, Cs):
    """The margin matrix A, the cached inverse of ``P + rho A'A`` shared by
    every C, rho and d.  Auto-rho ``0.3 C^(1/3)`` at the grid's geometric
    mean C (the JAX package's DESIGN.md "SVM rho", measured on the TPU)."""
    dtype, dev = X.dtype, X.device
    A = blockwise(X, lambda b, sl: torch.cat(
        [b * ysign[sl, None]] + ([ysign[sl, None]] if intercept else []),
        dim=1))
    d = A.shape[1]
    if rho0 > 0:
        rho = torch.tensor(rho0, dtype=dtype, device=dev)
    else:
        rho = 0.3 * torch.exp(torch.mean(torch.log(Cs))).pow(1.0 / 3.0)
    P = torch.ones((d,), dtype=dtype, device=dev)
    if intercept:
        P[-1] = 0.0
    Minv = chol_inverse(torch.diag(P) + rho * gram(A),
                        jitter=1e-7 if dtype == torch.float32 else 0.0)
    return A, Minv, rho, d


def _svm_engine(X, ysign, Cs, obs_w, loss, intercept, rho0):
    """(cold state, solver, reported iterate v = [w, (b)]) of the scan
    path; rho comes from the whole C grid."""
    n = X.shape[0]
    dtype, dev = X.dtype, X.device
    A, Minv, rho, d = _svm_setup(X, ysign, intercept, rho0, Cs)
    solve = make_fadmm_solver(_svm_ops(A, Minv, loss, obs_w, n, d),
                              adapt_rho=False)
    zn = torch.zeros((n,), dtype=dtype, device=dev)
    st0 = make_state(torch.zeros((d,), dtype=dtype, device=dev), zn, zn, rho,
                     Cs[0], aux=zn)
    return st0, solve, (lambda st: st.x)


def _svm_path_dev(X, ysign, Cs, obs_w, rho0, maxit, eps_abs, eps_rel, *,
                  loss, intercept, path_mode, trace_len=None):
    n, p = X.shape
    dtype, dev = X.dtype, X.device
    st0, solve, report = _svm_engine(X, ysign, Cs, obs_w, loss, intercept,
                                     rho0)
    traces = None
    if path_mode == "batch":
        k = Cs.shape[0]
        st = _batched_cold_states(k, st0.x.shape[0], st0.rho, Cs, aux_dim=n)
        zn = torch.zeros((k, n), dtype=dtype, device=dev)
        st = st._replace(z=zn, y=zn, adj_z=zn, adj_y=zn)
        st = make_batched_solver(solve)(st, maxit, eps_abs, eps_rel)
        vs, niter = st.x, st.it
    else:
        _, vs, niter, traces = _scan_path(st0, solve, report, Cs, maxit,
                                          eps_abs, eps_rel, trace_len)
    if intercept:
        coefs, b = vs[:, :p], vs[:, p]
    else:
        coefs, b = vs, torch.zeros((Cs.shape[0],), dtype=dtype, device=dev)
    return SVMResult(Cs=Cs, coef=coefs, intercept=b, niter=niter,
                     trace=traces)


def _as_sign(y):
    """Labels as +-1 (the larger label positive, sklearn's convention) and
    the original (negative, positive) labels, on the host."""
    y = np.asarray(to_numpy(y))
    classes = np.unique(y)
    if classes.size != 2:
        raise ValueError("SVM needs exactly two classes in y")
    if set(classes.tolist()) == {-1, 1}:
        return y.astype(np.float64), (-1, 1)
    return np.where(y == classes[1], 1.0, -1.0), tuple(classes.tolist())


def svm_path(X, y, *, Cs=None, nC: int = 20, C_min_ratio: float = 1e-3,
             loss: str = "squared_hinge", intercept: bool = True,
             weights=None, maxit: int = 20000, eps_abs: float = 1e-5,
             eps_rel: float = 1e-5, rho: float = -1.0,
             path_mode: str = "batch", trace_len: Optional[int] = None,
             data_mesh=None, dtype=torch.float32,
             device="cuda") -> SVMResult:
    """Solve the linear-SVM C path.

    Same arguments and defaults as ``admm_tpu.svm_path``, plus ``device``:
    tensors stay on their own device, anything else goes to ``device``.
    ``y`` holds two classes (any labels).  All ``Cs`` solve as lanes
    against one cached factorization (``path_mode="batch"``); "scan"
    warm-starts them in sequence.  ``weights`` scale each row's penalty
    ``C w_i``.  The auto grid is ``nC`` geometric points over
    ``[C_min_ratio, 1]``.  ``data_mesh`` shards X's rows over a mesh: the
    margin matrix's Gram and the margin products run per block (``A'u``
    a sum over the mesh, ``A v`` gathered)."""
    ysign, classes = _as_sign(y)
    X = _as_data(X, dtype, device, data_mesh)
    n, p = X.shape
    if ysign.shape[0] != n:
        raise ValueError("x and y must have the same number of rows")
    if loss not in ("hinge", "squared_hinge"):
        raise ValueError("loss must be 'hinge' or 'squared_hinge'")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode, trace_len = "scan", int(trace_len)
    obs_w = (torch.ones((n,), dtype=dtype, device=X.device) if weights is None
             else _as_tensor(weights, dtype, X.device).reshape(-1))
    if Cs is None:
        Cs = np.geomspace(1.0, C_min_ratio, int(nC))
    Cs_np = np.atleast_1d(np.asarray(to_numpy(Cs), np.float64))
    if np.any(Cs_np <= 0) or not np.all(np.isfinite(Cs_np)):
        # C <= 0 would NaN the whole solve (auto-rho hits 0).
        raise ValueError("Cs must be positive and finite")
    Cs_t = torch.sort(torch.as_tensor(Cs_np, dtype=dtype, device=X.device),
                      descending=True).values
    res = _svm_path_dev(X, torch.as_tensor(ysign, dtype=dtype,
                                           device=X.device),
                        Cs_t, obs_w, rho, maxit, eps_abs, eps_rel, loss=loss,
                        intercept=bool(intercept), path_mode=path_mode,
                        trace_len=trace_len)
    return res._replace(classes=classes)


def svm_fit(X, y, *, C: float = 1.0, **kw) -> SVMResult:
    """Single-C soft-margin linear SVM (see :func:`svm_path`)."""
    return svm_path(X, y, Cs=[C], **kw)


class CVSVMResult(NamedTuple):
    Cs: np.ndarray        # (k,) shared grid
    cvm: np.ndarray       # (k,) mean held-out loss
    cvsd: np.ndarray      # (k,) its standard error
    C_min: float          # grid point minimising cvm
    C_1se: float          # smallest C with cvm <= min + 1 se
    fit: SVMResult        # full-data path on the same grid
    foldid: np.ndarray    # (n,) fold assignment


def _cv_svm_decisions(X, ysign, masks, w, Cs, fid, rho0, maxit, eps_abs,
                      eps_rel, *, loss, intercept, mesh=None):
    """Every fold's C path and the held-out decision values
    (``cv._fold_sweep``): fold f fits with weights ``w * mask_f`` (held-out
    rows get penalty 0, so each fit is the training-subset fit), fold after
    fold on the device; row i keeps the (k,) decision values of the fold
    that held it out (``fid`` the clipped foldid).  Returns (n, k) on X's
    device."""
    from .cv import _fold_sweep

    return _fold_sweep(X, masks, fid, mesh, lambda mask: _svm_path_dev(
        X, ysign, Cs, w * mask, rho0, maxit, eps_abs, eps_rel, loss=loss,
        intercept=intercept, path_mode="batch"),
        lambda res, X_rows: X_rows @ res.coef.mT + res.intercept[None, :])


def cv_svm_path(X, y, *, nfolds: int = 10, foldid=None, weights=None,
                Cs=None, nC: int = 20, C_min_ratio: float = 1e-3,
                loss: str = "squared_hinge", intercept: bool = True,
                type_measure: str = "class", maxit: int = 20000,
                eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                rho: float = -1.0, seed: int = 0, fold_mesh=None,
                dtype=torch.float32, device="cuda") -> CVSVMResult:
    """K-fold CV over the SVM C grid, scored by held-out misclassification
    (``type_measure="class"``) or the loss itself (``"loss"``), with
    glmnet's per-observation aggregation and one-SE rule (toward smaller C,
    stronger regularization).  Same arguments and defaults as
    ``admm_tpu.cv_svm_path``, plus ``device``.  ``fold_mesh`` (a mesh of
    :mod:`admm_tpu_torch.parallel.mesh`, nfolds a multiple of its size)
    deals the folds over its positions."""
    ysign, _ = _as_sign(y)
    Xd = _as_tensor(X, dtype, device)
    n = Xd.shape[0]
    if type_measure not in ("class", "loss"):
        raise ValueError("type_measure must be 'class' or 'loss'")
    if foldid is not None:
        foldid = np.asarray(foldid, int)
        if foldid.shape != (n,):
            raise ValueError("foldid must have one entry per row")
        nfolds = int(foldid.max()) + 1
        counts = np.bincount(foldid[foldid >= 0], minlength=nfolds)
        if nfolds < 2 or np.any(counts == 0):
            raise ValueError(
                "foldid must assign at least one row to each of >= 2 "
                f"folds (got counts {counts.tolist()})")
    else:
        nfolds = int(nfolds)
        if not 2 <= nfolds <= n:
            raise ValueError("nfolds must be in [2, nrow(x)]")
        rng = np.random.default_rng(seed)
        foldid = np.tile(np.arange(nfolds), n // nfolds + 1)[:n]
        foldid = foldid[rng.permutation(n)]
    w = (torch.ones((n,), dtype=dtype, device=Xd.device) if weights is None
         else _as_tensor(weights, dtype, Xd.device).reshape(-1))
    fit = svm_path(Xd, y, Cs=Cs, nC=nC, C_min_ratio=C_min_ratio, loss=loss,
                   intercept=intercept, weights=weights, maxit=maxit,
                   eps_abs=eps_abs, eps_rel=eps_rel, rho=rho, dtype=dtype,
                   device=Xd.device)
    masks = torch.as_tensor(foldid[None, :] != np.arange(nfolds)[:, None],
                            dtype=dtype, device=Xd.device)
    eta = to_numpy(_cv_svm_decisions(
        Xd, torch.as_tensor(ysign, dtype=dtype, device=Xd.device), masks, w,
        fit.Cs, np.clip(foldid, 0, None), rho, maxit, eps_abs, eps_rel,
        loss=loss, intercept=bool(intercept),
        mesh=fold_mesh)).astype(np.float64)                       # (n, k)
    # Train-only rows (foldid < 0) are never held out: not scored.
    scored = foldid >= 0
    margin = (ysign[:, None] * eta)[scored]
    if type_measure == "class":
        cvraw = (margin <= 0).astype(float)
    else:
        h = np.maximum(0.0, 1.0 - margin)
        cvraw = h if loss == "hinge" else h * h
    ws = to_numpy(w).astype(np.float64)[scored]
    ws = ws / ws.sum()
    nsc = int(scored.sum())
    cvm = ws @ cvraw
    cvsd = np.sqrt((ws @ (cvraw - cvm) ** 2) / max(nsc - 1, 1))
    imin = int(np.argmin(cvm))
    Cs_np = to_numpy(fit.Cs).astype(np.float64)
    ok = np.flatnonzero(cvm <= cvm[imin] + cvsd[imin])
    return CVSVMResult(Cs=Cs_np, cvm=cvm, cvsd=cvsd,
                       C_min=float(Cs_np[imin]),
                       C_1se=float(Cs_np[ok[-1]]),   # smallest such C
                       fit=fit, foldid=foldid)
