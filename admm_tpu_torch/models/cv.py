"""K-fold cross-validation over the lambda path (counterpart of
``admm_tpu/models/cv.py``, for the models the port holds: the gaussian
Lasso/Elastic Net, the GLM families, the Dantzig selector, the
(sparse-)group, generalized/fused and constrained/zero-sum Lasso; the
relaxed lasso's CV is in :mod:`admm_tpu_torch.models.relaxed`).

Conventions follow glmnet's ``cv.glmnet``: the lambda grid comes from the
full-data fit; fold f's model is the path fitted without fold f's rows and
scored on them; errors are aggregated per observation (``cvm`` and its
standard error ``cvsd``); ``lambda_min`` minimises the curve and
``lambda_1se`` is the largest lambda within one standard error of it.

``cv_mode="onepass"`` (the default through "auto") is the JAX package's
protocol: fold f is the WEIGHTED path with weight 0 on its held-out rows
(exactly the training-subset fit: the weights are renormalized to sum to
n), and each row's linear predictor is formed on the device by the fold
that held it out.  The JAX package vmaps the fold axis into one program;
here the folds are a loop on the device, one path solve per fold, so in
float32 each fold of a gaussian CV is one launch of the batch kernel
(``tall_path_batch`` or ``wide_path_batch``; every fold has its own
standardized design, so folds cannot share a launch as lanes).  Only the
two (nlambda,) curves come back to the host for the default measures, the
(n, nlambda) predictors otherwise.  ``cv_mode="loop"`` fits each training
subset as its own unweighted path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..diag import profile
from ..interop import to_numpy
from ..parallel.mesh import all_sum
from .lasso import PathResult, _as_tensor, lasso_path, validate_pf_limits


class CVResult(NamedTuple):
    lambdas: np.ndarray     # (nlambda,) the shared grid
    cvm: np.ndarray         # (nlambda,) mean CV error
    cvsd: np.ndarray        # (nlambda,) standard error of the CV error
    lambda_min: float       # grid point minimising cvm
    lambda_1se: float       # largest lambda with cvm <= min + 1 se
    fit: PathResult         # full-data path fit on the same grid
    foldid: np.ndarray      # (n,) fold assignment (-1 = train-only row)
    # glmnet's keep=TRUE: the (n, nlambda) prevalidated linear predictors
    # (each row from the fold fit that excluded it), or None.
    fit_preval: Optional[np.ndarray] = None


def _squared_error(eta, y):
    """Per-observation squared error (gaussian; glmnet type.measure
    'mse').  ``eta`` is the (nlambda, n_va) linear predictor."""
    return (eta - y[None, :]) ** 2


def binomial_deviance(eta, y):
    """Per-observation binomial deviance -2[y log p + (1-y) log(1-p)],
    stably from the linear predictor."""
    return 2.0 * (np.logaddexp(0.0, eta) - y[None, :] * eta)


def _weighted_curves(err, ws, n_sc):
    """glmnet's cvm and cvsd of an (n, nlambda) per-observation error
    tensor: weighted mean over the scored rows (``ws`` is 0 elsewhere) and
    the two-pass standard error; one (2, nlambda) tensor."""
    sw = torch.sum(ws)
    cvm = (ws @ err) / sw
    cvsd = torch.sqrt((ws @ (err - cvm[None, :]) ** 2) / sw
                      / torch.clamp(n_sc - 1.0, min=1.0))
    return torch.stack([cvm, cvsd])


def _make_family_score_reduce(err_fn):
    """The device reducer of a family's tensor ``cv_loss_dev``: ``(eta
    (n, L), y, ws, n_sc) -> (2, L)`` cvm and cvsd."""
    def reduce(eta, y, ws, n_sc):
        return _weighted_curves(err_fn(eta.mT, y).mT, ws, n_sc)

    return reduce


def _score_reduce_dev(eta, y, ws, n_sc, kind):
    """cvm and cvsd of the one-pass sweep for mse or mae, reduced on the
    device so only two (nlambda,) curves go to the host (glmnet's
    formulas; ``ws`` is the scoring weight, 0 on unscored rows)."""
    r = eta - y[:, None]
    err = r * r if kind == "mse" else torch.abs(r)
    return _weighted_curves(err, ws, n_sc)


def _resolve_measure(type_measure, fam, default_loss):
    """glmnet's ``type.measure`` -> a per-observation numpy ``loss(eta,
    y)`` (or the 'auc' sentinel, scored per fold) and the sense of
    "better" ('min' or 'max').

    Gaussian (``fam`` None): 'default'/'mse', 'deviance' (= mse), 'mae'.
    GLM families: 'default'/'deviance' (the family's CV loss),
    'mse'/'mae' on the response scale, and for binomial links 'class'
    (misclassification at a mean of 1/2) and 'auc' (per fold).
    """
    if type_measure in ("default", None):
        return default_loss, "min"
    name = getattr(fam, "name", "gaussian") if fam is not None \
        else "gaussian"

    def response(eta):
        # Family objects carry their own inverse link (mean_eta).
        if fam is not None and getattr(fam, "mean_eta", None) is not None:
            return fam.mean_eta(eta)
        if name == "binomial":
            return 1.0 / (1.0 + np.exp(-eta))
        if name == "poisson":
            return np.exp(eta)
        return eta

    if type_measure == "deviance":
        if fam is None:
            return _squared_error, "min"      # gaussian deviance == mse
        return default_loss, "min"
    if type_measure == "mse":
        return (lambda eta, y: (response(eta) - y[None, :]) ** 2), "min"
    if type_measure == "mae":
        return (lambda eta, y:
                np.abs(response(eta) - y[None, :])), "min"
    if type_measure == "class":
        if not name.startswith("binomial"):
            raise ValueError("type_measure='class' needs a binomial "
                             "family (or cv_multinomial_path)")
        # Every binomial link's inverse is increasing through a mean of
        # 1/2, so thresholding the response is link-correct.
        return (lambda eta, y:
                ((response(eta) > 0.5).astype(float) != y[None, :])
                .astype(float)), "min"
    if type_measure == "auc":
        if not name.startswith("binomial"):
            raise ValueError(
                "type_measure='auc' needs a binomial family")
        return "auc", "max"
    raise ValueError(
        f"unknown type_measure {type_measure!r}; choose from "
        "'default', 'deviance', 'mse', 'mae', 'class', 'auc'")


def _fold_auc(eta_all, y, foldid, nfolds, w=None):
    """Per-fold AUC (Mann-Whitney, glmnet's type.measure='auc'): returns
    (cvraw (nfolds, L), fold_w (nfolds,)), weight 0 for a fold holding a
    single class (its AUC is undefined)."""
    from scipy.stats import rankdata

    L = eta_all.shape[1]
    cvraw = np.zeros((nfolds, L))
    fold_w = np.zeros(nfolds)
    for f in range(nfolds):
        va = foldid == f
        yv = y[va]
        npos = int((yv == 1).sum())
        nneg = int((yv == 0).sum())
        if npos == 0 or nneg == 0:
            continue
        ranks = np.apply_along_axis(rankdata, 0, eta_all[va])
        rpos = ranks[yv == 1].sum(axis=0)
        cvraw[f] = (rpos - npos * (npos + 1) / 2.0) / (npos * nneg)
        fold_w[f] = float(va.sum()) if w is None else float(w[va].sum())
    if fold_w.sum() == 0:
        raise ValueError("AUC is undefined in every fold (each fold "
                         "held a single class); use fewer folds")
    return cvraw, fold_w


def _fold_sweep(X, masks, fid, mesh, solve_fold, eta_of=None):
    """The one-pass fold sweep: fold f's path is ``solve_fold(mask_f)``
    (the weighted path, weight 0 on fold f's rows); each row keeps the
    linear predictors of the fold that held it out (``fid``, a numpy
    array, is the clipped foldid, so a train-only row takes fold 0's).
    ``eta_of(res, X_rows)`` forms a fold's ``(n_f, ...)`` predictors; by
    default a path's ``beta0 + X coef'``, (n_f, nlambda).  Returns the (n,
    ...) predictors on X's device.  The rows of every fold go to the device
    once, before the first solve; one fold's standardized design is alive
    at a time.

    ``mesh`` (``fold_mesh``, :mod:`admm_tpu_torch.parallel.mesh`): the
    folds are dealt to its D positions in contiguous blocks of nfolds/D
    and this process solves only its own positions' folds, exactly as
    without a mesh; every row is written by the one fold that held it out,
    so the sum over positions of the zero-filled predictors
    (:func:`~admm_tpu_torch.parallel.mesh.all_sum`) is exact.  The
    positions of one process share X's device."""
    n, nf = X.shape[0], masks.shape[0]
    folds = range(nf)
    if mesh is not None:
        folds = _own_folds(nf, mesh, X.device)
    order = np.argsort(fid, kind="stable")
    edges = np.searchsorted(fid[order], np.arange(nf + 1))
    order = torch.as_tensor(order, device=X.device)
    eta = None
    for f in folds:
        with profile.span("cv_fold", fold=f):
            res = solve_fold(masks[f])
            rows = order[int(edges[f]):int(edges[f + 1])]
            part = (res.beta0[None, :] + X[rows] @ res.coef.mT
                    if eta_of is None else eta_of(res, X[rows]))
            if eta is None:
                eta = (torch.empty if mesh is None else torch.zeros)(
                    (n,) + tuple(part.shape[1:]), dtype=part.dtype,
                    device=X.device)
            eta[rows] = part
            del res
    return eta if mesh is None else all_sum([eta], mesh)


def _own_folds(nfolds: int, mesh, device) -> list:
    """The folds this process solves on ``mesh``: position d owns the
    contiguous block ``[d nfolds/D, (d+1) nfolds/D)``."""
    if nfolds % mesh.size:
        raise ValueError(f"nfolds={nfolds} must be a multiple of the "
                         f"fold_mesh size {mesh.size}")
    if any(torch.device(d) != torch.device(device) for d in mesh.devices):
        raise ValueError("a fold_mesh's positions in this process must "
                         "share the data's device; give each device its "
                         "own process (make_mesh(group=...))")
    per = nfolds // mesh.size
    return [f for pos in mesh.local for f in range(pos * per,
                                                    (pos + 1) * per)]


def _make_gaussian_fold_eta(alpha, enet_scale, standardize, intercept,
                            solver_kw):
    """The gaussian Lasso/Enet fold sweep: ``run(X, y, lams, masks, fid)
    -> (n, nlambda)`` own-fold predictors; every fold solves with
    ``path_mode="batch"`` and sees exactly the full fit's normalized
    factors and box (``exclude`` merged in)."""
    from .lasso import _path_user, validate_pf_limits

    def run(X, y, lams, masks, fid, mesh=None):
        pf, lim = validate_pf_limits(
            solver_kw.get("penalty_factor"), solver_kw.get("exclude"),
            solver_kw.get("lower_limits"), solver_kw.get("upper_limits"),
            X.shape[1], X.dtype, X.device)
        return _fold_sweep(X, masks, fid, mesh, lambda mask: _path_user(
            X, y, lams, solver_kw.get("rho", -1.0),
            solver_kw.get("maxit", 10000), solver_kw.get("eps_abs", 1e-5),
            solver_kw.get("eps_rel", 1e-5), alpha, mask, pf, lim,
            standardize_x=standardize, intercept=intercept,
            enet_scale=enet_scale, path_mode="batch"))

    return run


def _make_glm_fold_eta(fam, alpha, standardize, intercept, maxit,
                       eps_abs, eps_rel, rho, path_mode,
                       newton_steps=None, penalty_factor=None,
                       lower_limits=None, upper_limits=None, exclude=None,
                       offset=None):
    """The fold sweep of any GLM family (same contract as
    :func:`_make_gaussian_fold_eta`): fold f is the weighted GLM path
    with weight 0 on its held-out rows, which takes the engine (the GLM
    kernel takes no observation weights).  ``offset`` enters every fold
    fit and the returned predictors."""
    from .glm import _glm_path
    from .lasso import validate_pf_limits

    steps = _default_newton_steps(fam, newton_steps)

    def run(X, y, lams, masks, fid, mesh=None):
        pf, lim = validate_pf_limits(penalty_factor, exclude, lower_limits,
                                     upper_limits, X.shape[1], X.dtype,
                                     X.device)
        off = (None if offset is None
               else _as_tensor(offset, X.dtype, X.device).reshape(-1))
        eta = _fold_sweep(X, masks, fid, mesh, lambda mask: _glm_path(
            X, y, 2, 1e-2, lams, rho, maxit, eps_abs, eps_rel, alpha, mask,
            off, pf, lim, family=fam, standardize_x=standardize,
            intercept=intercept, path_mode=path_mode, newton_steps=steps))
        return eta if off is None else eta + off[:, None]

    return run


def _default_newton_steps(fam, newton_steps):
    """The family's shipped x-update default (one Newton step for
    poisson) unless overridden."""
    from .glm import _NEWTON_STEPS

    if newton_steps is not None:
        return int(newton_steps)
    return 1 if getattr(fam, "name", "") == "poisson" else _NEWTON_STEPS


def _cv_foldid(n, nfolds, seed, foldid):
    """Fold assignment (glmnet's conventions, -1 = train-only row):
    ``(foldid, nfolds)``.  Without an explicit ``foldid`` rows are dealt
    round-robin over a permutation (``np.random.default_rng(seed)``), so
    fold sizes differ by at most one; an explicit one defines nfolds."""
    if foldid is None:
        if not 2 <= nfolds <= n:
            raise ValueError("nfolds must be in [2, nrow(x)]")
        rng = np.random.default_rng(seed)
        foldid = np.resize(np.arange(nfolds, dtype=np.int64), n)
        foldid = foldid[rng.permutation(n)]
    else:
        foldid = np.asarray(foldid, np.int64)
        if foldid.shape != (n,):
            raise ValueError("foldid must have one entry per row")
        nfolds = int(foldid.max()) + 1
        counts = np.bincount(foldid[foldid >= 0], minlength=nfolds)
        if nfolds < 2 or np.any(counts == 0):
            raise ValueError(
                "foldid must assign at least one row to each of >= 2 "
                f"folds (got counts {counts.tolist()})")
    return foldid, nfolds


def _cv_curve(per_obs, foldid, w=None):
    """cvm and cvsd from an (n, nlambda) per-observation loss matrix
    (glmnet's aggregation over the scored rows, optionally weighted)."""
    scored = foldid >= 0
    n_sc = int(scored.sum())
    if w is None:
        cvm = per_obs[scored].mean(axis=0)
        cvsd = np.sqrt(((per_obs[scored] - cvm) ** 2).mean(axis=0)
                       / (n_sc - 1))
    else:
        ws = np.asarray(w, np.float64).ravel()[scored]
        cvm = (ws[:, None] * per_obs[scored]).sum(axis=0) / ws.sum()
        cvsd = np.sqrt((ws[:, None] * (per_obs[scored] - cvm) ** 2)
                       .sum(axis=0) / ws.sum() / (n_sc - 1))
    return cvm, cvsd


@profile.spanned("fit")
def cv_lasso_path(X, y, *, nfolds: int = 10, nlambda: int = 100,
                  lambda_min_ratio: Optional[float] = None,
                  lambdas=None, alpha: float = 1.0,
                  _enet_scale: bool = False, standardize: bool = True,
                  intercept: bool = True, seed: int = 0, foldid=None,
                  path_mode: str = "batch", cv_mode: str = "auto",
                  weights=None, offset=None, type_measure: str = "default",
                  keep: bool = False, _path_fn=None, _loss_fn=None,
                  _fold_eta_fn=None, _family=None, device="cuda",
                  **solver_kw) -> CVResult:
    """Cross-validated Lasso/Elastic-Net path.

    Same arguments and defaults as ``admm_tpu.cv_lasso_path``, plus
    ``device``: a tensor ``X`` stays on its own device, anything else goes
    to ``device``; ``solver_kw`` (``rho``, ``maxit``, ``eps_abs``,
    ``eps_rel``, ``dtype``, ``penalty_factor``, ``lower_limits``, ...)
    passes to every path solve.

    Folds are dealt as in ``cv.glmnet`` (``seed``), or given by
    ``foldid`` (which then defines nfolds; -1 rows train every fold and
    are never scored).  ``cv_mode``: "onepass" (the default through
    "auto") solves fold f as the weighted path with weight 0 on its rows,
    fold after fold on the device; "loop" fits each training subset.
    The full fit follows ``path_mode``; the folds always solve all lambdas
    at once ("batch").  ``weights`` weight the full fit, every fold fit
    and the aggregation; ``offset`` is the gaussian response shift.
    ``type_measure``: 'default'/'mse'/'deviance' or 'mae' here (the GLM
    drivers add 'class' and 'auc').  ``keep`` returns the (n, nlambda)
    prevalidated predictors in ``fit_preval``.

    ``fold_mesh`` (via ``solver_kw``; a mesh of
    :mod:`admm_tpu_torch.parallel.mesh`) deals the one-pass sweep's folds
    over its positions, nfolds a multiple of its size; each process
    solves its own folds, and the result equals the CV without a mesh
    (folds are independent).  The full fit runs on every process.
    """
    fold_mesh = solver_kw.pop("fold_mesh", None)
    dtype = solver_kw.get("dtype") or torch.float32
    X = _as_tensor(X, dtype, device)
    n, p = X.shape
    y = np.asarray(to_numpy(y), np.float64).ravel()
    if offset is not None:
        # glmnet's gaussian offset shifts every fold fit and the held-out
        # residual alike: shifting y once reproduces its cvm/cvsd.
        if _family is not None or _loss_fn is not None:
            raise ValueError("offset= here is the gaussian response "
                             "shift; GLM CV drivers take their own "
                             "offset argument")
        off_g = np.asarray(to_numpy(offset), np.float64).ravel()
        if off_g.shape != y.shape:
            raise ValueError("offset must have one entry per row")
        y = y - off_g
    else:
        off_g = None
    w = None if weights is None else np.asarray(to_numpy(weights),
                                                np.float64).ravel()
    if w is not None and w.shape != (n,):
        raise ValueError("weights must have one entry per row")
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    # Cheap validation before the full fit; an explicit foldid defines
    # nfolds (glmnet).
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)
    y_t = torch.as_tensor(y, dtype=dtype, device=X.device)

    is_default_path = _path_fn is None
    if is_default_path:
        def _path_fn(Xf, yf, lambdas, wf=None):
            return lasso_path(Xf, yf, lambdas=lambdas, nlambda=nlambda,
                              lambda_min_ratio=lambda_min_ratio,
                              alpha=alpha, _enet_scale=_enet_scale,
                              standardize=standardize,
                              intercept=intercept, path_mode=path_mode,
                              weights=wf, device=X.device, **solver_kw)
    elif w is not None and _fold_eta_fn is None:
        raise ValueError(
            "weights are supported only for CV drivers with a "
            "one-pass fold solver (gaussian / GLM families)")
    full = _path_fn(X, y_t, lambdas, w)

    loss, sense = _resolve_measure(
        type_measure, _family,
        (_loss_fn if _loss_fn is not None
         else _family.cv_loss if _family is not None
         else _squared_error))
    fold_eta = _fold_eta_fn
    if fold_eta is None and is_default_path and cv_mode != "loop":
        fold_eta = _make_gaussian_fold_eta(alpha, _enet_scale, standardize,
                                           intercept, solver_kw)
    if cv_mode == "onepass" and fold_eta is None:
        raise ValueError("cv_mode='onepass' needs a one-pass fold "
                         "solver; this CV driver has none — use "
                         "cv_mode='loop'")
    with profile.span("pack"):
        lams = to_numpy(full.lambdas).astype(np.float64)
    scored = foldid >= 0
    n_sc = int(scored.sum())
    cvm = cvsd = eta_all = None
    if fold_eta is not None and cv_mode != "loop":
        masks = (foldid[None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        if w is not None:
            masks = masks * w[None, :]
        eta_dev = fold_eta(
            X, y_t, full.lambdas,
            torch.as_tensor(masks, dtype=dtype, device=X.device),
            np.clip(foldid, 0, None), mesh=fold_mesh)
        # Default measures without keep: score on the device, and only
        # the two curves cross to the host.
        dev_reduce = None
        if not keep and _loss_fn is None:
            if (_family is None
                    and type_measure in ("default", None, "mse", "mae")):
                kind = "mae" if type_measure == "mae" else "mse"
                dev_reduce = lambda e, yy, ws, ns: _score_reduce_dev(
                    e, yy, ws, ns, kind)
            elif (_family is not None
                  and type_measure in ("default", None, "deviance")
                  and getattr(_family, "cv_loss_dev", None) is not None):
                dev_reduce = _make_family_score_reduce(_family.cv_loss_dev)
        if dev_reduce is not None:
            ws = scored.astype(np.float64)
            if w is not None:
                ws = ws * w
            reduced = dev_reduce(
                eta_dev, y_t, torch.as_tensor(ws, dtype=dtype,
                                              device=X.device),
                torch.tensor(float(n_sc), dtype=dtype, device=X.device))
            with profile.span("pack"):
                curves = to_numpy(reduced).astype(np.float64)
            cvm, cvsd = curves[0], curves[1]
        else:
            with profile.span("pack"):
                eta_all = to_numpy(eta_dev)
    else:
        X_np = to_numpy(X).astype(np.float64)
        eta_all = np.full((n, lams.shape[0]), np.nan)
        for f in range(nfolds):
            tr = torch.as_tensor(np.flatnonzero(foldid != f),
                                 device=X.device)
            va = foldid == f
            res = _path_fn(X[tr], y_t[tr], lams,
                           None if w is None else w[foldid != f])
            with profile.span("pack"):
                eta_all[va] = (
                    to_numpy(res.beta0).astype(np.float64)[:, None]
                    + to_numpy(res.coef).astype(np.float64) @ X_np[va].T).T

    if cvm is not None:
        pass  # scored on the device above
    elif loss == "auc":
        # A per-FOLD measure (glmnet): fold AUCs aggregated with the
        # folds' sample weights; larger is better.
        cvraw, fold_w = _fold_auc(eta_all, y, foldid, nfolds, w)
        fw = fold_w / fold_w.sum()
        cvm = fw @ cvraw
        nf_eff = int((fold_w > 0).sum())
        cvsd = np.sqrt((fw @ (cvraw - cvm) ** 2) / max(nf_eff - 1, 1))
    else:
        cvm, cvsd = _cv_curve(loss(eta_all.T, y).T, foldid, w)
    if sense == "max":
        i_min = int(np.argmax(cvm))
        within = cvm >= cvm[i_min] - cvsd[i_min]
    else:
        i_min = int(np.argmin(cvm))
        within = cvm <= cvm[i_min] + cvsd[i_min]
    lambda_min = float(lams[i_min])
    lambda_1se = float(lams[np.flatnonzero(within)[0]])  # grid decreasing

    if keep and off_g is not None:
        # glmnet's buildPredmat: the prevalidated predictors carry the
        # offset, so scoring them against the original y reproduces cvm.
        eta_all = eta_all + off_g[:, None]
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                    lambda_min=lambda_min, lambda_1se=lambda_1se,
                    fit=full, foldid=foldid,
                    fit_preval=eta_all if keep else None)


def cv_enet_path(X, y, *, alpha: float = 1.0, **kw) -> CVResult:
    """Cross-validated Elastic-Net path (lambda0 inflation as in
    reference: src/ADMMEnet.h:56)."""
    return cv_lasso_path(X, y, alpha=alpha, _enet_scale=True, **kw)


def cv_logistic_path(X, y, **kw) -> CVResult:
    """Cross-validated sparse logistic regression path, scored by the
    binomial deviance (glmnet's default for family='binomial'): the
    binomial case of :func:`cv_glm_path`."""
    from .glm import binomial

    return cv_glm_path(X, y, binomial(), **kw)


def cv_glm_path(X, y, family, *, nlambda: int = 50,
                lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
                standardize: bool = True, intercept: bool = True,
                maxit: int = 10000, eps_abs: float = 1e-5,
                eps_rel: float = 1e-5, rho: float = -1.0,
                path_mode: str = "auto", loss=None,
                newton_steps: Optional[int] = None,
                penalty_factor=None, lower_limits=None,
                upper_limits=None, exclude=None, offset=None,
                device="cuda", **kw) -> CVResult:
    """Cross-validated path for any GLM family
    (:mod:`admm_tpu_torch.models.glm`), same arguments and defaults as
    ``admm_tpu.cv_glm_path`` plus ``device``; ``dtype`` (float32 by
    default) may ride ``kw``.  Held-out rows are scored by the family's
    per-observation loss at the linear predictor (on the device) unless
    ``loss(eta, y)`` is given; ``type_measure`` and the fold protocol are
    :func:`cv_lasso_path`'s.  The full fit of a binomial or huber path in
    float32 is one launch of the GLM kernel; the folds are weighted, so
    they take the engine."""
    from .glm import GLMFamily, glm_lasso_path

    fam = family() if not isinstance(family, GLMFamily) else family
    if offset is not None and kw.get("cv_mode") == "loop":
        raise ValueError("offset with cv_mode='loop' is not supported; "
                         "use the default one-pass fold sweep")
    steps = _default_newton_steps(fam, newton_steps)
    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return glm_lasso_path(Xf, yf, fam, lambdas=lambdas,
                              nlambda=nlambda,
                              lambda_min_ratio=lambda_min_ratio,
                              alpha=alpha, standardize=standardize,
                              intercept=intercept, maxit=maxit,
                              eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                              path_mode=path_mode, weights=wf,
                              offset=offset, penalty_factor=penalty_factor,
                              lower_limits=lower_limits,
                              upper_limits=upper_limits, exclude=exclude,
                              newton_steps=steps, dtype=dtype,
                              device=device)

    fold_eta = _make_glm_fold_eta(fam, alpha, standardize, intercept,
                                  maxit, eps_abs, eps_rel, rho, path_mode,
                                  newton_steps=newton_steps,
                                  penalty_factor=penalty_factor,
                                  lower_limits=lower_limits,
                                  upper_limits=upper_limits,
                                  exclude=exclude, offset=offset)
    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _loss_fn=loss,
                         _fold_eta_fn=fold_eta, _family=fam, device=device,
                         **kw)


def cv_dantzig_path(X, y, *, nlambda: int = 100,
                    lambda_min_ratio: Optional[float] = None,
                    standardize: bool = True, intercept: bool = True,
                    maxit: int = 10000, eps_abs: float = 1e-5,
                    eps_rel: float = 1e-5, rho: float = -1.0,
                    path_mode: str = "batch", device="cuda",
                    **kw) -> CVResult:
    """Cross-validated Dantzig-selector path (same fold protocol as
    :func:`cv_lasso_path`, scored by held-out MSE; the folds run the
    weighted engine, which has no kernel), plus ``device``."""
    from .dantzig import _dpath_user, dantzig_path

    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return dantzig_path(Xf, yf, lambdas=lambdas, nlambda=nlambda,
                            lambda_min_ratio=lambda_min_ratio,
                            standardize=standardize, intercept=intercept,
                            maxit=maxit, eps_abs=eps_abs, eps_rel=eps_rel,
                            rho=rho, path_mode=path_mode, weights=wf,
                            dtype=dtype, device=device)

    def fold_eta(Xf, yf, lams, masks, fid, mesh=None):
        return _fold_sweep(Xf, masks, fid, mesh, lambda mask: _dpath_user(
            Xf, yf, lams, rho, maxit, eps_abs, eps_rel, mask,
            standardize_x=standardize, intercept=intercept,
            path_mode="batch"))

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta,
                         device=device, **kw)


def cv_group_lasso_path(X, y, groups, *, weights=None, nlambda: int = 100,
                        lambda_min_ratio: Optional[float] = None,
                        standardize: bool = True, intercept: bool = True,
                        maxit: int = 10000, eps_abs: float = 1e-5,
                        eps_rel: float = 1e-5, rho: float = -1.0,
                        obs_weights=None, l1_ratio: float = 0.0,
                        device="cuda", **kw) -> CVResult:
    """Cross-validated (sparse-)group-Lasso path (same fold protocol as
    :func:`cv_lasso_path`; the folds run the weighted group path on the
    engine), plus ``device``.  ``weights`` are the GROUP penalty weights,
    ``obs_weights`` the observation weights (the group path's naming)."""
    from .grouplasso import _gl_path, group_lasso_path, normalize_groups

    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return group_lasso_path(Xf, yf, groups, weights=weights,
                                lambdas=lambdas, nlambda=nlambda,
                                lambda_min_ratio=lambda_min_ratio,
                                standardize=standardize,
                                intercept=intercept, maxit=maxit,
                                eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                                obs_weights=wf, l1_ratio=l1_ratio,
                                dtype=dtype, device=device)

    def fold_eta(Xf, yf, lams, masks, fid, mesh=None):
        gi, gw = normalize_groups(groups, Xf.shape[1], weights, Xf.dtype,
                                  Xf.device)
        return _fold_sweep(Xf, masks, fid, mesh, lambda mask: _gl_path(
            Xf, yf, gi, gw, 2, 1e-2, lams, rho, maxit, eps_abs, eps_rel,
            mask, standardize_x=standardize, intercept=intercept,
            l1_ratio=float(l1_ratio)))

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         weights=obs_weights, _path_fn=path_fn,
                         _fold_eta_fn=fold_eta, device=device, **kw)


def cv_gen_lasso_path(X, y, D, *, nlambda: int = 50,
                      lambda_min_ratio: float = 1e-3,
                      intercept: bool = True, maxit: int = 10000,
                      eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                      rho: float = -1.0, path_mode: str = "batch",
                      device="cuda", **kw) -> CVResult:
    """Cross-validated generalized-Lasso path: selects lambda for a (m, p)
    structure matrix ``D`` (fused lasso, trend filtering) by held-out MSE;
    same fold protocol as :func:`cv_lasso_path` (each fold the weighted
    batch path on the engine), plus ``device``."""
    from .genlasso import _gen_path, gen_lasso_path

    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return gen_lasso_path(Xf, yf, D, lambdas=lambdas, nlambda=nlambda,
                              lambda_min_ratio=lambda_min_ratio,
                              intercept=intercept, maxit=maxit,
                              eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                              path_mode=path_mode, weights=wf, dtype=dtype,
                              device=device)

    def fold_eta(Xf, yf, lams, masks, fid, mesh=None):
        Dt = _as_tensor(D, Xf.dtype, Xf.device)
        return _fold_sweep(Xf, masks, fid, mesh, lambda mask: _gen_path(
            Xf, yf, Dt, 2, 1e-2, lams, rho, maxit, eps_abs, eps_rel, mask,
            intercept=intercept, path_mode="batch"))

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         intercept=intercept, _path_fn=path_fn,
                         _fold_eta_fn=fold_eta, device=device, **kw)


def cv_fused_lasso_path(X, y, *, order: int = 1, **kw) -> CVResult:
    """Cross-validated fused lasso / trend filtering (the generalized
    Lasso with the discrete difference operator)."""
    from .genlasso import difference_matrix

    p = X.shape[1] if hasattr(X, "shape") else np.shape(X)[1]
    return cv_gen_lasso_path(X, y, difference_matrix(int(p), order), **kw)


def cv_constrained_lasso_path(X, y, C, d=None, *, nlambda: int = 50,
                              lambda_min_ratio: float = 1e-3,
                              intercept: bool = True, maxit: int = 10000,
                              eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                              rho: float = -1.0, device="cuda",
                              **kw) -> CVResult:
    """Cross-validated equality-constrained lasso path: every fold fit
    honors ``C b = d`` (same fold protocol as :func:`cv_lasso_path`, each
    fold the weighted batch path on the engine), plus ``device``."""
    from .conlasso import _conlasso_fold_etas, constrained_lasso_path

    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return constrained_lasso_path(
            Xf, yf, C, d, lambdas=lambdas, nlambda=nlambda,
            lambda_min_ratio=lambda_min_ratio, intercept=intercept,
            weights=wf, maxit=maxit, eps_abs=eps_abs, eps_rel=eps_rel,
            rho=rho, dtype=dtype, device=device)

    def fold_eta(Xf, yf, lams, masks, fid, mesh=None):
        C_t = torch.atleast_2d(_as_tensor(C, Xf.dtype, Xf.device))
        d_t = (torch.zeros((C_t.shape[0],), dtype=Xf.dtype,
                           device=Xf.device) if d is None
               else _as_tensor(d, Xf.dtype, Xf.device).reshape(-1))
        return _conlasso_fold_etas(Xf, yf, C_t, d_t, lams, masks, fid, rho,
                                   maxit, eps_abs, eps_rel,
                                   intercept=intercept, mesh=mesh)

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         intercept=intercept, _path_fn=path_fn,
                         _fold_eta_fn=fold_eta, device=device, **kw)


def cv_zerosum_lasso_path(X, y, **kw) -> CVResult:
    """Cross-validated zero-sum lasso (the one-row constrained case)."""
    p = X.shape[1] if hasattr(X, "shape") else np.shape(X)[1]
    return cv_constrained_lasso_path(X, y, np.ones((1, p)), **kw)


def cv_slope_path(X, y, *, lam_seq=None, q: float = 0.1, nlambda: int = 30,
                  lambda_min_ratio: float = 1e-2, standardize: bool = True,
                  intercept: bool = True, maxit: int = 10000,
                  eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                  rho: float = -1.0, device="cuda", **kw) -> CVResult:
    """Cross-validated SLOPE path over the sequence scale t: the sorted-l1
    sequence (BH at level ``q`` by default) is fixed and the CV selects its
    multiplier, t in glmnet's lambda role (same fold protocol as
    :func:`cv_lasso_path`, each fold the weighted batch path on the
    engine), plus ``device``."""
    from .slope import _check_lam_seq, _slope_path_dev, slope_path

    p = X.shape[1] if hasattr(X, "shape") else np.shape(X)[1]
    lam_np = _check_lam_seq(lam_seq, q, p)
    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return slope_path(Xf, yf, lam_seq=lam_np, lambdas=lambdas,
                          nlambda=nlambda, lambda_min_ratio=lambda_min_ratio,
                          standardize=standardize, intercept=intercept,
                          weights=wf, maxit=maxit, eps_abs=eps_abs,
                          eps_rel=eps_rel, rho=rho, dtype=dtype,
                          device=device)

    def fold_eta(Xf, yf, lams, masks, fid, mesh=None):
        lam_t = torch.as_tensor(lam_np, dtype=Xf.dtype, device=Xf.device)
        return _fold_sweep(Xf, masks, fid, mesh, lambda mask: _slope_path_dev(
            Xf, yf, lam_t, 2, 1e-2, lams, rho, maxit, eps_abs, eps_rel, mask,
            standardize_x=standardize, intercept=intercept,
            path_mode="batch"))

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta,
                         device=device, **kw)


def cv_sqrt_lasso_path(X, y, *, nlambda: int = 30,
                       lambda_min_ratio: float = 1e-2,
                       standardize: bool = True, intercept: bool = True,
                       maxit: int = 10000, eps_abs: float = 1e-6,
                       eps_rel: float = 1e-6, rho: float = -1.0,
                       device="cuda", **kw) -> CVResult:
    """Cross-validated square-root-lasso path, scored by held-out MSE with
    the glmnet fold protocol (each fold the weighted concomitant batch path:
    weight-0 rows drop out of the weighted l2-norm loss exactly), plus
    ``device``."""
    from .sqrtlasso import _sqrt_path_dev, sqrt_lasso_path

    dtype = kw.get("dtype") or torch.float32

    def path_fn(Xf, yf, lambdas, wf=None):
        return sqrt_lasso_path(Xf, yf, lambdas=lambdas, nlambda=nlambda,
                               lambda_min_ratio=lambda_min_ratio,
                               standardize=standardize, intercept=intercept,
                               weights=wf, maxit=maxit, eps_abs=eps_abs,
                               eps_rel=eps_rel, rho=rho, dtype=dtype,
                               device=device)

    def fold_eta(Xf, yf, lams, masks, fid, mesh=None):
        return _fold_sweep(Xf, masks, fid, mesh, lambda mask: _sqrt_path_dev(
            Xf, yf, 2, 1e-2, lams, rho, maxit, eps_abs, eps_rel, mask,
            standardize_x=standardize, intercept=intercept,
            path_mode="batch"))

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta,
                         device=device, **kw)


def _matrix_eta(res, X_rows):
    """A multitask or multinomial fold's (n_f, L, K) linear predictors."""
    return res.beta0[None, :, :] + torch.einsum("np,lpk->nlk", X_rows,
                                                res.coef)


def _matrix_cv_setup(n, nfolds, seed, foldid, path_kw):
    """The shared front of the matrix-response CV drivers: ``(weights,
    foldid, nfolds, fold_mesh)``, the first two as numpy."""
    fold_mesh = path_kw.pop("fold_mesh", None)
    w = path_kw.pop("weights", None)
    w = None if w is None else np.asarray(to_numpy(w), np.float64).ravel()
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)
    return w, foldid, nfolds, fold_mesh


def _onepass(cv_mode, path_kw):
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    onepass = cv_mode != "loop" and not any(
        path_kw.get(k) is not None for k in ("trace_len", "data_mesh"))
    if cv_mode == "onepass" and not onepass:
        raise ValueError("cv_mode='onepass' does not support "
                         "trace_len/data_mesh")
    return onepass


def _fold_masks(foldid, nfolds, w, dtype, device):
    masks = (foldid[None, :] != np.arange(nfolds)[:, None]).astype(np.float64)
    if w is not None:
        masks = masks * w[None, :]
    return torch.as_tensor(masks, dtype=dtype, device=device)


def _select(lams, cvm, cvsd):
    i_min = int(np.argmin(cvm))
    within = cvm <= cvm[i_min] + cvsd[i_min]
    return float(lams[i_min]), float(lams[np.flatnonzero(within)[0]])


def cv_multitask_lasso_path(X, Y, *, nfolds: int = 10, seed: int = 0,
                            foldid: Optional[np.ndarray] = None,
                            nlambda: int = 50, cv_mode: str = "auto",
                            keep: bool = False, device="cuda",
                            **path_kw) -> CVResult:
    """Cross-validated multi-task Lasso path, scored by the per-observation
    squared error summed over tasks.  Same arguments and defaults as
    ``admm_tpu.cv_multitask_lasso_path``, plus ``device``; ``path_kw``
    forwards to :func:`~admm_tpu_torch.models.multitask.
    multitask_lasso_path`.  ``cv_mode``: "onepass" (the default through
    "auto") fits fold f as the weighted batch path with weight 0 on its
    rows, fold after fold on the device; "loop" refits each training
    subset.  ``keep`` returns the (n, L, K) prevalidated predictors."""
    from .multitask import _keep_mask, _mt_path, multitask_lasso_path

    onepass = _onepass(cv_mode, path_kw)
    dtype = path_kw.pop("dtype", None) or torch.float32
    X = _as_tensor(X, dtype, device)
    Y_np = np.asarray(to_numpy(Y), np.float64)
    n, p = X.shape
    off = path_kw.pop("offset", None)
    if off is not None:
        off = np.asarray(to_numpy(off), np.float64)
        if off.shape != Y_np.shape:
            raise ValueError("offset must match Y's (n, K) shape")
    w, foldid, nfolds, fold_mesh = _matrix_cv_setup(n, nfolds, seed,
                                                    foldid, path_kw)
    full = multitask_lasso_path(X, Y_np, nlambda=nlambda, offset=off,
                                weights=w, dtype=dtype, device=X.device,
                                **path_kw)
    path_kw.pop("lambdas", None)   # the fold fits take the shared grid
    with profile.span("pack"):
        lams = to_numpy(full.lambdas).astype(np.float64)
    Yf = Y_np if off is None else Y_np - off        # the fits see Y - off
    if onepass:
        pf, _ = validate_pf_limits(path_kw.get("penalty_factor"), None, None,
                                   None, p, dtype, X.device)
        keep_m = _keep_mask(path_kw.get("exclude"), p, dtype, X.device)
        Yt = torch.as_tensor(Yf, dtype=dtype, device=X.device)
        eta_all = to_numpy(_fold_sweep(
            X, _fold_masks(foldid, nfolds, w, dtype, X.device),
            np.clip(foldid, 0, None), fold_mesh, lambda mask: _mt_path(
                X, Yt, 2, 1e-2, full.lambdas, path_kw.get("rho", -1.0),
                path_kw.get("maxit", 10000), path_kw.get("eps_abs", 1e-5),
                path_kw.get("eps_rel", 1e-5), mask, pf, keep_m,
                float(path_kw.get("alpha", 1.0)),
                standardize_x=path_kw.get("standardize", True),
                intercept=path_kw.get("intercept", True), path_mode="batch",
                standardize_y=bool(path_kw.get("standardize_response",
                                               False)),
                penalty=path_kw.get("penalty", "rows")),
            _matrix_eta)).astype(np.float64)
        if off is not None:
            eta_all = eta_all + off[:, None, :]
        err = ((eta_all - Y_np[:, None, :]) ** 2).sum(axis=2)
    else:
        X_np = to_numpy(X).astype(np.float64)
        err = np.full((n, lams.shape[0]), np.nan)
        eta_all = np.full((n, lams.shape[0], Y_np.shape[1]), np.nan)
        for f in range(nfolds):
            tr, va = foldid != f, foldid == f
            res = multitask_lasso_path(
                X[torch.as_tensor(np.flatnonzero(tr), device=X.device)],
                Y_np[tr], lambdas=lams, weights=None if w is None else w[tr],
                offset=None if off is None else off[tr], dtype=dtype,
                device=X.device, **path_kw)
            pred = (to_numpy(res.beta0).astype(np.float64)[:, None, :]
                    + np.einsum("vp,lpk->lvk", X_np[va],
                                to_numpy(res.coef).astype(np.float64)))
            if off is not None:
                pred = pred + off[va][None, :, :]
            eta_all[va] = np.moveaxis(pred, 0, 1)
            err[va] = ((pred - Y_np[va][None]) ** 2).sum(axis=2).T
    cvm, cvsd = _cv_curve(err, foldid, w)
    lambda_min, lambda_1se = _select(lams, cvm, cvsd)
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd, lambda_min=lambda_min,
                    lambda_1se=lambda_1se, fit=full, foldid=foldid,
                    fit_preval=eta_all if keep else None)


def cv_multinomial_path(X, y, *, nfolds: int = 10, seed: int = 0,
                        foldid: Optional[np.ndarray] = None,
                        nlambda: int = 50, type_measure: str = "deviance",
                        cv_mode: str = "auto", keep: bool = False,
                        device="cuda", **path_kw) -> CVResult:
    """Cross-validated sparse multinomial path, scored by the multinomial
    deviance ``-2 log p_{i, y_i}`` or by ``type_measure`` 'class'
    (misclassification of the argmax), 'mse'/'mae' (over the class
    probabilities against the indicators).  Same arguments and defaults as
    ``admm_tpu.cv_multinomial_path``, plus ``device``; ``path_kw``
    forwards to :func:`~admm_tpu_torch.models.multinomial.
    multinomial_lasso_path`.  ``cv_mode`` as in
    :func:`cv_multitask_lasso_path`."""
    from .multinomial import _mn_path, multinomial_lasso_path
    from .multitask import _keep_mask

    if type_measure not in ("deviance", "default", "class", "mse", "mae"):
        raise ValueError("multinomial type_measure must be 'deviance',"
                         " 'class', 'mse' or 'mae'")
    onepass = _onepass(cv_mode, path_kw)
    dtype = path_kw.pop("dtype", None) or torch.float32
    X = _as_tensor(X, dtype, device)
    y = np.asarray(to_numpy(y)).ravel().astype(np.int64)
    n, p = X.shape
    C = int(y.max()) + 1
    path_kw.setdefault("nclass", C)
    off = path_kw.pop("offset", None)
    if off is not None:
        off = np.asarray(to_numpy(off), np.float64)
        if off.shape != (n, C):
            raise ValueError("offset must be (n, nclass)")
    w, foldid, nfolds, fold_mesh = _matrix_cv_setup(n, nfolds, seed,
                                                    foldid, path_kw)
    full = multinomial_lasso_path(X, y, nlambda=nlambda, offset=off,
                                  weights=w, dtype=dtype, device=X.device,
                                  **path_kw)
    path_kw.pop("lambdas", None)   # the fold fits take the shared grid
    with profile.span("pack"):
        lams = to_numpy(full.lambdas).astype(np.float64)
    if onepass:
        pf, _ = validate_pf_limits(path_kw.get("penalty_factor"), None, None,
                                   None, p, dtype, X.device)
        keep_p = _keep_mask(path_kw.get("exclude"), p, dtype, X.device)
        off_t = (None if off is None
                 else torch.as_tensor(off, dtype=dtype, device=X.device))
        y_t = torch.as_tensor(y, device=X.device)
        eta_all = to_numpy(_fold_sweep(
            X, _fold_masks(foldid, nfolds, w, dtype, X.device),
            np.clip(foldid, 0, None), fold_mesh, lambda mask: _mn_path(
                X, y_t, 2, 1e-2, full.lambdas, path_kw.get("rho", -1.0),
                path_kw.get("maxit", 10000), path_kw.get("eps_abs", 1e-5),
                path_kw.get("eps_rel", 1e-5), path_kw.get("alpha", 1.0),
                mask, pf, keep_p, off_t, nclass=C,
                standardize_x=path_kw.get("standardize", True),
                intercept=path_kw.get("intercept", True), path_mode="batch",
                grouped=bool(path_kw.get("grouped", False)),
                newton_steps=int(path_kw.get("newton_steps", 2))),
            _matrix_eta)).astype(np.float64)                  # (n, L, C)
        if off is not None:
            eta_all = eta_all + off[:, None, :]
    else:
        X_np = to_numpy(X).astype(np.float64)
        eta_all = np.full((n, lams.shape[0], C), np.nan)
        for f in range(nfolds):
            tr, va = foldid != f, foldid == f
            res = multinomial_lasso_path(
                X[torch.as_tensor(np.flatnonzero(tr), device=X.device)],
                y[tr], lambdas=lams, weights=None if w is None else w[tr],
                offset=None if off is None else off[tr], dtype=dtype,
                device=X.device, **path_kw)
            eta = (to_numpy(res.beta0).astype(np.float64)[:, None, :]
                   + np.einsum("vp,lpc->lvc", X_np[va],
                               to_numpy(res.coef).astype(np.float64)))
            if off is not None:
                eta = eta + off[va][None, :, :]
            eta_all[va] = np.moveaxis(eta, 0, 1)
    # Stable log-softmax scoring over every scored row at once.
    scored = foldid >= 0
    ev = eta_all[scored]
    ev = ev - ev.max(axis=2, keepdims=True)
    logp = ev - np.log(np.exp(ev).sum(axis=2, keepdims=True))
    ys = y[scored]
    dev = np.full((n, lams.shape[0]), np.nan)
    if type_measure == "class":
        dev[scored] = (np.argmax(logp, axis=2) != ys[:, None]).astype(float)
    elif type_measure in ("mse", "mae"):
        ind = np.zeros((ys.size, C))
        ind[np.arange(ys.size), ys] = 1.0
        d = np.exp(logp) - ind[:, None, :]
        dev[scored] = (np.abs(d).sum(axis=2) if type_measure == "mae"
                       else (d ** 2).sum(axis=2))
    else:
        dev[scored] = -2.0 * logp[np.arange(ys.size), :, ys]
    cvm, cvsd = _cv_curve(dev, foldid, w)
    lambda_min, lambda_1se = _select(lams, cvm, cvsd)
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd, lambda_min=lambda_min,
                    lambda_1se=lambda_1se, fit=full, foldid=foldid,
                    fit_preval=eta_all if keep else None)
