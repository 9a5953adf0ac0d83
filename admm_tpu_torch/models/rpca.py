"""Robust PCA, the sparse + low-rank decomposition, and nuclear-norm
matrix completion by ADMM (counterpart of ``admm_tpu/models/rpca.py``; an
extension beyond the reference).

Principal Component Pursuit (Candes, Li, Ma, Wright 2011)::

    minimize_{L, S}  ||L||_* + lambda ||S||_1   s.t.  L + S = M

as a prox exchange: the L-update is singular-value thresholding
(:func:`svt`) of ``M - S - Y/rho`` at ``1/rho``, the S-update the
elementwise soft threshold of ``M - L - Y/rho`` at ``lambda/rho``, then
dual ascent on ``L + S - M``.  Nothing is factorized, so the plain-ADMM
adaptive rho ladder runs (reference: src/ADMMBase.h:85-109).  As in the
JAX package:

* ``observed=``: PCP with missing entries, the z-prox free off the mask
  (:func:`_masked_soft`);
* ``rank=``: the warm-started partial SVT (:func:`svt_partial`), subspace
  iteration from the previous iterate's right basis, carried in
  ``state.aux``.  The first basis is the QR of a normal draw from a CPU
  ``torch.Generator`` seeded 0 (the JAX package draws from
  ``PRNGKey(0)``, which torch cannot reproduce): the converged
  decomposition is the same, the basis and the bits are not;
* :func:`rpca_path` (warm-started scan over lambda) and :func:`cv_rpca`
  (K folds of held-out OBSERVED ENTRIES, from numpy's
  ``default_rng(seed)``);
* :func:`matrix_complete`: ``min ||L||_*`` s.t. ``L = M`` on the observed
  entries, the same SVT against a projection.

Each (m, n) iterate travels flattened as ``(m * n,)``, so the engine's
last-axis norms are the JAX package's Frobenius norms.  The exact SVD is
``torch.linalg.svd`` once per iteration (on the card cuSOLVER's, in
float64: :func:`svt`).  No kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import (ProblemOps, make_admm_solver, make_state,
                           make_traced_solve)
from ..core.prox import l2norm, soft_threshold
from .lasso import _as_tensor, _scan_path


class RPCAResult(NamedTuple):
    """Low-rank + sparse decomposition ``M ~ low_rank + sparse``."""
    low_rank: torch.Tensor  # (m, n) L
    sparse: torch.Tensor    # (m, n) S (exact zeros)
    lam: torch.Tensor       # the sparsity penalty used
    niter: torch.Tensor     # int32 ADMM iterations
    trace: Optional[torch.Tensor] = None
    # Partial-SVT solves only (rank= given): True when every direction of
    # the rank + oversample basis survived the final threshold, so the
    # decomposition may be truncated (raise ``rank``).  None otherwise.
    rank_saturated: Optional[torch.Tensor] = None


class RPCAPathResult(NamedTuple):
    """Warm-started lambda path of PCP decompositions."""
    lambdas: torch.Tensor   # (k,) sparsity penalties, decreasing
    low_rank: torch.Tensor  # (k, m, n)
    sparse: torch.Tensor    # (k, m, n) exact zeros
    rank: torch.Tensor      # (k,) numerical rank of each low_rank
    nnz: torch.Tensor       # (k,) nonzero count of each sparse
    niter: torch.Tensor     # (k,) int32 ADMM iterations


class RPCACVResult(NamedTuple):
    """Entry-holdout CV over the sparsity penalty."""
    lambdas: np.ndarray
    cvm: np.ndarray        # (k,) mean held-out-entry error across folds
    cvsd: np.ndarray       # (k,) standard error
    lambda_min: float
    lambda_1se: float
    fit: RPCAPathResult    # full-data path on the same grid
    foldid: np.ndarray     # (m, n) int fold of each observed entry; -1 off


def svt(A, tau):
    """Singular-value thresholding, the prox of ``tau * ||.||_*``, of a
    matrix or of a batch of matrices (``(..., m, n)``; ``tau`` a scalar or
    broadcastable against the ``(..., min(m, n))`` singular values).

    It feeds the Boyd residuals, so it must be accurate to the working
    precision.  On a CUDA tensor the SVD and the reconstruction run in
    float64 and the result is rounded back to ``A``'s dtype: cuSOLVER's
    default float32 driver (gesvdj) leaves ``U'U - I`` at 2e-4 at 500 x
    500 on the H100, which stalls PCP (83 iterations against the 16 of the
    JAX package and of float64) and keeps matrix completion from
    converging at all, while the float64 SVD costs 30 ms there against
    19 (``compare_svd.py``).  On the CPU, LAPACK's SVD in ``A``'s dtype
    is accurate to it."""
    W = A.to(torch.float64) if A.is_cuda else A
    U, s, Vh = torch.linalg.svd(W, full_matrices=False)
    return ((U * torch.clamp(s - tau, min=0.0)[..., None, :]) @ Vh).to(A.dtype)


def svt_partial(A, tau, V, power_iters: int = 2):
    """SVT restricted to the top-r subspace of the warm basis ``V`` (n, r),
    refined by ``power_iters`` rounds of subspace iteration.  Returns ``(L,
    V_new)``, ``V_new`` the rotated right-singular basis for the next warm
    start.  Exact whenever every singular value above ``tau`` lives in the
    converged subspace."""
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(A @ V)
        V, _ = torch.linalg.qr(A.mT @ Q)
    B = A @ V                                              # (m, r)
    U, s, Wt = torch.linalg.svd(B, full_matrices=False)    # Wt (r, r)
    L = (U * torch.clamp(s - tau, min=0.0)[None, :]) @ (Wt @ V.mT)
    return L, V @ Wt.mT


def _masked_soft(v, thr, mask):
    """The partial-observation z-prox: soft threshold on the observed
    entries, the identity off them (the free variable absorbs that
    block)."""
    s = soft_threshold(v, thr)
    return s if mask is None else torch.where(mask, s, v)


def _pcp_ops(M0, m, n, next_x, next_z) -> ProblemOps:
    """The residuals and scales shared by both PCP splittings (flattened
    (m * n,) iterates; ``M0`` flattened too)."""
    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x + z - M0,
        eps_primal_scale=lambda st: torch.maximum(
            torch.maximum(l2norm(st.x), l2norm(st.z)), l2norm(M0)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=m * n, dim_dual=m * n,
    )


def _rpca_ops(M0, m, n, mask=None) -> ProblemOps:
    """Exact-SVD PCP ops (x = L, z = S); ``mask`` (optional bool (m, n))
    restricts the constraint to the observed entries (``M0`` is zero off
    the mask)."""
    Mf = M0.reshape(-1)
    maskf = None if mask is None else mask.reshape(-1)

    def next_x(st):
        A = (Mf - st.z - st.y / st.rho).reshape(m, n)
        return svt(A, 1.0 / st.rho).reshape(-1)

    def next_z(st, x_new):
        v = Mf - x_new - st.y / st.rho
        return _masked_soft(v, st.lam / st.rho, maskf), None

    return _pcp_ops(Mf, m, n, next_x, next_z)


def _rpca_partial_ops(M0, m, n, mask, power_iters) -> ProblemOps:
    """Partial-SVT PCP ops, roles swapped (x = S, z = L), so that the warm
    basis V rides ``state.aux`` through the engine's ``(z_new, aux_new)``
    return."""
    Mf = M0.reshape(-1)
    maskf = None if mask is None else mask.reshape(-1)

    def next_x(st):
        v = Mf - st.z - st.y / st.rho
        return _masked_soft(v, st.lam / st.rho, maskf)

    def next_z(st, x_new):
        A = (Mf - x_new - st.y / st.rho).reshape(m, n)
        L, V = svt_partial(A, 1.0 / st.rho, st.aux, power_iters)
        return L.reshape(-1), V

    return _pcp_ops(Mf, m, n, next_x, next_z)


_SVT_OVERSAMPLE = 8


def _start_basis(n, r, dtype, device):
    """The partial SVT's first basis: the QR of an (n, r) normal draw from
    a CPU generator seeded 0 (module docstring)."""
    g = torch.Generator().manual_seed(0)
    G = torch.randn((n, r), generator=g, dtype=torch.float64)
    V0, _ = torch.linalg.qr(G.to(dtype=dtype, device=device))
    return V0


def _rpca_engine(M0, lam0, rho0, mask=None, rank=None, power_iters=2):
    """The PCP engine: cold state, solver, and a report mapping the state
    to the stacked ``(2, m, n)`` array ``[L, S]`` (S zero off the observed
    entries).  Shared by :func:`rpca`, :func:`rpca_path` and the CV fold
    sweep."""
    m, n = M0.shape
    dtype, dev = M0.dtype, M0.device
    # The paper's step (Candes et al. section 5): rho = N / (4 ||M||_1)
    # over the observed entries.
    nobs = (torch.tensor(float(m * n), dtype=dtype, device=dev)
            if mask is None else torch.sum(mask).to(dtype))
    rho = (torch.tensor(rho0, dtype=dtype, device=dev) if rho0 > 0
           else nobs / (4.0 * torch.sum(torch.abs(M0)) + 1e-30))
    Z = torch.zeros((m * n,), dtype=dtype, device=dev)
    keep = (lambda s: s) if mask is None else (
        lambda s: torch.where(mask, s, torch.zeros_like(s)))
    if rank is None:
        ops = _rpca_ops(M0, m, n, mask)
        st0 = make_state(Z, Z, Z, rho, lam0)

        def report(st):        # x = L, z = S
            return torch.stack([st.x.reshape(m, n),
                                keep(st.z.reshape(m, n))])
    else:
        r = min(int(rank) + _SVT_OVERSAMPLE, m, n)
        ops = _rpca_partial_ops(M0, m, n, mask, int(power_iters))
        st0 = make_state(Z, Z, Z, rho, lam0,
                         aux=_start_basis(n, r, dtype, dev))

        def report(st):        # x = S, z = L
            return torch.stack([st.z.reshape(m, n),
                                keep(st.x.reshape(m, n))])
    solve = make_admm_solver(ops, adapt_rho=True)
    return st0, solve, report


def _rpca_dev(M0, lam, rho0, maxit, eps_abs, eps_rel, trace_len=None,
              mask=None, rank=None, power_iters=2):
    st0, solve, report = _rpca_engine(M0, lam, rho0, mask, rank, power_iters)
    if trace_len is not None:
        st, buf = make_traced_solve(solve, trace_len)(st0, maxit, eps_abs,
                                                      eps_rel)
    else:
        st, buf = solve(st0, maxit, eps_abs, eps_rel), None
    LS = report(st)
    saturated = None
    if rank is not None:
        # The truncation is invisible to the residuals it feeds: report
        # whether the final iterate fills its whole basis.
        r_eff = min(int(rank) + _SVT_OVERSAMPLE, *M0.shape)
        sv = torch.linalg.svdvals(LS[0])
        saturated = torch.sum(sv > 0.5 / st.rho) >= r_eff
    return RPCAResult(low_rank=LS[0], sparse=LS[1], lam=st.lam, niter=st.it,
                      trace=buf, rank_saturated=saturated)


def _rpca_path_dev(M0, lams, rho0, maxit, eps_abs, eps_rel, mask=None,
                   rank=None, power_iters=2):
    st0, solve, report = _rpca_engine(M0, lams[0], rho0, mask, rank,
                                      power_iters)
    _, LS, niter, _ = _scan_path(st0, solve, report, lams, maxit, eps_abs,
                                 eps_rel)
    L, S = LS[:, 0], LS[:, 1]
    # Numerical rank and support size at the dtype-scaled tolerance.
    sv = torch.linalg.svdvals(L)                          # (k, min(m, n))
    tol = (torch.max(sv, dim=1, keepdim=True).values * max(M0.shape)
           * torch.finfo(M0.dtype).eps * 10)
    return RPCAPathResult(lambdas=lams, low_rank=L, sparse=S,
                          rank=torch.sum(sv > tol, dim=1),
                          nnz=torch.sum(S != 0, dim=(1, 2)), niter=niter)


def _mc_ops(M, mask, m, n) -> ProblemOps:
    Mf, maskf = M.reshape(-1), mask.reshape(-1)

    def next_x(st):
        # L-update: the nuclear prox of the constraint-feasible iterate.
        A = (st.z - st.y / st.rho).reshape(m, n)
        return svt(A, 1.0 / st.rho).reshape(-1)

    def next_z(st, x_new):
        # Projection onto {Z : Z_ij = M_ij on the observed entries}.
        return torch.where(maskf, Mf, x_new + st.y / st.rho), None

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: torch.maximum(l2norm(st.x),
                                                  l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=m * n, dim_dual=m * n,
    )


def _mc_dev(M, mask, rho0, maxit, eps_abs, eps_rel, trace_len=None):
    m, n = M.shape
    dtype, dev = M.dtype, M.device
    solve = make_admm_solver(_mc_ops(M, mask, m, n), adapt_rho=True)
    nobs = torch.sum(mask)
    # rpca's balance heuristic, on the observed entries only.
    rho = (torch.tensor(rho0, dtype=dtype, device=dev) if rho0 > 0
           else nobs / (4.0 * torch.sum(torch.abs(M) * mask) + 1e-30))
    Z0 = (M * mask).reshape(-1)
    st0 = make_state(Z0, Z0, torch.zeros_like(Z0), rho, 0.0, dtype=dtype)
    if trace_len is not None:
        st, buf = make_traced_solve(solve, trace_len)(st0, maxit, eps_abs,
                                                      eps_rel)
    else:
        st, buf = solve(st0, maxit, eps_abs, eps_rel), None
    return st.x.reshape(m, n), st.it, buf


def _as_matrix(M, dtype, device):
    M = _as_tensor(M, dtype, device)
    if M.dim() != 2:
        raise ValueError("M must be a 2-D matrix")
    return M


def _as_mask(observed, M):
    mask = (observed.to(device=M.device, dtype=torch.bool)
            if isinstance(observed, torch.Tensor)
            else torch.as_tensor(np.asarray(observed, bool), device=M.device))
    if mask.shape != M.shape:
        raise ValueError("observed mask must match M's shape")
    return mask


def matrix_complete(M, observed=None, *, rho: float = -1.0,
                    maxit: int = 5000, eps_abs: float = 1e-7,
                    eps_rel: float = 1e-6, trace_len: Optional[int] = None,
                    dtype=torch.float32, device="cuda"):
    """Exact nuclear-norm matrix completion (Candes & Recht 2009)::

        minimize ||L||_*   s.t.  L_ij = M_ij  on the observed entries

    by the SVT/projection ADMM.  Same arguments as
    ``admm_tpu.matrix_complete`` plus ``device``; ``observed`` is a boolean
    mask (default: the nonzero entries of ``M``).  Returns ``(L, niter)``,
    or ``(L, niter, trace)`` with ``trace_len``."""
    M = _as_matrix(M, dtype, device)
    mask = M != 0 if observed is None else _as_mask(observed, M)
    L, niter, buf = _mc_dev(M, mask, rho, maxit, eps_abs, eps_rel,
                            None if trace_len is None else int(trace_len))
    if trace_len is not None:
        return L, niter, buf
    return L, niter


def _check_mask(M, observed):
    if observed is None:
        return M, None
    mask = _as_mask(observed, M)
    return M * mask, mask


def _lambda_grid(m, n, lambdas, nlambda, lambda_scale):
    """The PCP grid, float64 numpy, decreasing: geometric from
    ``lambda_scale * lam*`` down to ``lam* / lambda_scale`` around the
    universal ``lam* = 1/sqrt(max(m, n))``, or the user's sorted."""
    if lambdas is None:
        star = 1.0 / np.sqrt(max(m, n))
        return np.geomspace(lambda_scale * star, star / lambda_scale,
                            int(nlambda))
    lams = np.sort(np.atleast_1d(np.asarray(lambdas, np.float64)))
    return lams[::-1].copy()


def rpca(M, *, lam: Optional[float] = None, observed=None,
         rank: Optional[int] = None, power_iters: int = 2,
         rho: float = -1.0, maxit: int = 5000, eps_abs: float = 1e-7,
         eps_rel: float = 1e-6, trace_len: Optional[int] = None,
         dtype=torch.float32, device="cuda") -> RPCAResult:
    """Principal Component Pursuit: split ``M`` into a low-rank and a
    sparse part.  Same arguments and defaults as ``admm_tpu.rpca`` plus
    ``device``: ``lam`` defaults to ``1/sqrt(max(m, n))``, ``rho`` to
    ``N_obs / (4 ||M||_1)``; ``observed`` fits on the observed entries
    (``sparse`` is zero off them); ``rank`` switches the L-update to the
    warm-started partial SVT (check ``rank_saturated``)."""
    M = _as_matrix(M, dtype, device)
    m, n = M.shape
    if lam is None:
        lam = 1.0 / np.sqrt(max(m, n))
    M0, mask = _check_mask(M, observed)
    return _rpca_dev(M0, torch.tensor(lam, dtype=dtype, device=M.device),
                     rho, maxit, eps_abs, eps_rel,
                     None if trace_len is None else int(trace_len), mask,
                     None if rank is None else int(rank), int(power_iters))


def rpca_path(M, *, lambdas=None, nlambda: int = 10,
              lambda_scale: float = 3.0, observed=None,
              rank: Optional[int] = None, power_iters: int = 2,
              rho: float = -1.0, maxit: int = 5000, eps_abs: float = 1e-7,
              eps_rel: float = 1e-6, dtype=torch.float32,
              device="cuda") -> RPCAPathResult:
    """Warm-started PCP path over the sparsity penalty (``admm_tpu.rpca_path``
    plus ``device``): the default grid is geometric around the universal
    ``1/sqrt(max(m, n))``, from ``lambda_scale`` times it down to it over
    ``lambda_scale``."""
    M = _as_matrix(M, dtype, device)
    m, n = M.shape
    M0, mask = _check_mask(M, observed)
    lams = _lambda_grid(m, n, lambdas, nlambda, lambda_scale)
    return _rpca_path_dev(M0, torch.as_tensor(lams, dtype=dtype,
                                              device=M.device),
                          rho, maxit, eps_abs, eps_rel, mask,
                          None if rank is None else int(rank),
                          int(power_iters))


def _rpca_fold_scores(M0, obs, train_masks, lams, rho0, maxit, eps_abs,
                      eps_rel, rank, power_iters, squared):
    """The fold sweep: each fold's lambda path on its training entries
    (the JAX package's vmapped lanes, one after another here); returns
    per-fold per-lambda (held-out error sums (F, k), held-out counts
    (F,))."""
    errs, cnts = [], []
    for train in train_masks:
        st0, solve, report = _rpca_engine(M0 * train, lams[0], rho0, train,
                                          rank, power_iters)
        _, LS, _, _ = _scan_path(st0, solve, report, lams, maxit, eps_abs,
                                 eps_rel)
        held = obs & ~train
        diff = LS[:, 0] - M0[None, :, :]
        err = diff * diff if squared else torch.abs(diff)
        errs.append(torch.sum(torch.where(held[None], err,
                                          torch.zeros_like(err)),
                              dim=(1, 2)))
        cnts.append(torch.sum(held).to(M0.dtype))
    return torch.stack(errs), torch.stack(cnts)


def cv_rpca(M, *, lambdas=None, nlambda: int = 10,
            lambda_scale: float = 3.0, nfolds: int = 5, seed: int = 0,
            observed=None, rank: Optional[int] = None,
            power_iters: int = 2, score: str = "mae", rho: float = -1.0,
            maxit: int = 5000, eps_abs: float = 1e-6, eps_rel: float = 1e-5,
            dtype=torch.float32, device="cuda") -> RPCACVResult:
    """Entry-holdout cross-validation over the PCP sparsity penalty
    (``admm_tpu.cv_rpca`` plus ``device``): the observed entries are
    dealt into ``nfolds`` folds by numpy's ``default_rng(seed)``; each
    fold's path refits on the other entries (the masked solver) and is
    scored by the low-rank part's error on its held-out entries
    (``score="mae"``, the default, or ``"mse"``)."""
    M = _as_matrix(M, dtype, device)
    if score not in ("mae", "mse"):
        raise ValueError("score must be 'mae' or 'mse'")
    if int(nfolds) < 2:
        raise ValueError("nfolds must be >= 2")
    m, n = M.shape
    M0, mask = _check_mask(M, observed)
    obs_np = (np.ones((m, n), bool) if mask is None
              else mask.detach().cpu().numpy())
    lams = _lambda_grid(m, n, lambdas, nlambda, lambda_scale)

    rng = np.random.default_rng(seed)
    idx = np.flatnonzero(obs_np.ravel())
    fold_flat = np.full(m * n, -1, np.int32)
    fold_flat[rng.permutation(idx)] = np.arange(idx.size) % int(nfolds)
    foldid = fold_flat.reshape(m, n)
    train_masks = torch.as_tensor(
        np.stack([obs_np & (foldid != f) for f in range(int(nfolds))]),
        device=M.device)
    lams_t = torch.as_tensor(lams, dtype=dtype, device=M.device)
    rk = None if rank is None else int(rank)
    errs, cnts = _rpca_fold_scores(
        M0, torch.as_tensor(obs_np, device=M.device), train_masks, lams_t,
        rho, maxit, eps_abs, eps_rel, rk, int(power_iters), score == "mse")
    per_fold = (errs.detach().cpu().numpy()
                / cnts.detach().cpu().numpy()[:, None])
    cvm = per_fold.mean(axis=0)
    cvsd = per_fold.std(axis=0, ddof=1) / np.sqrt(int(nfolds))
    i_min = int(np.argmin(cvm))
    ok = cvm <= cvm[i_min] + cvsd[i_min]
    i_1se = int(np.flatnonzero(ok)[0])        # lams sorted decreasing
    fit = _rpca_path_dev(M0, lams_t, rho, maxit, eps_abs, eps_rel, mask, rk,
                         int(power_iters))
    return RPCACVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                        lambda_min=float(lams[i_min]),
                        lambda_1se=float(lams[i_1se]), fit=fit,
                        foldid=foldid)
