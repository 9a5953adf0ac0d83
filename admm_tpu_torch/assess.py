"""Model assessment on held-out data, glmnet's ``assess.glmnet``,
``roc.glmnet``, ``confusion.glmnet`` and ``Cindex`` (counterpart of
``admm_tpu/assess.py``).

Runs on finished gaussian and GLM ``PathResult``s, multinomial,
multi-task and Cox results and on CV results, in
float64 on the device of the fit's coefficients (of ``eta=`` where that
is given instead), and returns numpy, as the JAX package does; the
measures are those the CV drivers score
(:mod:`admm_tpu_torch.models.cv`), so ``assess(fit, Xte, yte)['deviance']``
is what ``cv_*_path`` cross-validates.

* :func:`assess`: every applicable measure per path point (deviance,
  mse, mae; class and auc for binomial).
* :func:`roc`: the (FPR, TPR) curve of a binomial fit at one lambda.
* :func:`confusion`: the true-by-predicted count table of a binomial fit
  at one lambda.
* :func:`c_index`: Harrell's concordance of risk scores.

Like glmnet's, :func:`assess` also scores the prevalidated predictors of
``cv_*_path(..., keep=True)`` through ``eta=`` (``result=None, X=None``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .interop import to_numpy
from .predict import _f64, _family_object, _predict, _resolve_cv


def _own_device(a) -> torch.device:
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def _eta_matrix(result, X, eta, offset=None):
    """The (L, m) float64 linear predictors of a path result on ``X`` or a
    given ``eta`` (e.g. a ``keep=True`` ``fit_preval`` transposed), on the
    fit's device (``eta``'s own); ``offset`` is glmnet's ``newoffset``."""
    if eta is not None:
        eta = _f64(eta, _own_device(eta))
        if eta.ndim != 2:
            raise ValueError("eta must be (nlambda, n) — transpose a "
                             "keep=True fit_preval (n, nlambda) first")
        return eta
    if result is None or X is None:
        raise ValueError("pass either (result, X) or eta=")
    return _predict(result, X, None, "link", "gaussian", offset, None)


def _binomial_dev(eta, y):
    return 2.0 * (torch.logaddexp(torch.zeros_like(eta), eta)
                  - y[None, :] * eta)


def assess(result, X, y, *, family: str = "gaussian",
           weights: Optional[np.ndarray] = None, lam=None, eta=None,
           offset=None, time=None, event=None, strata=None,
           start=None) -> dict:
    """Every applicable performance measure of a fitted path on test data
    (glmnet's ``assess.glmnet``): a dict of measure -> (nlambda,) array,
    or scalars when ``lam`` picks one grid point (the nearest).

    * gaussian: ``deviance`` (= mse), ``mse``, ``mae``
    * binomial: ``deviance``, ``class``, ``auc``, ``mse``/``mae`` on the
      probability scale
    * poisson: ``deviance`` (against the saturated model), ``mse``/``mae``
      on the mean scale
    * a :class:`GLMFamily`: its ``cv_loss`` as the deviance, ``mse``/
      ``mae`` through its ``mean_eta``, ``class``/``auc`` for binomial
      links
    * a multinomial result: ``deviance`` (-2 log p_y), ``class``,
      ``mse``/``mae`` over the probability simplex
    * a multi-task result (``y`` (m, K)): ``deviance`` = ``mse``, the
      squared error summed over tasks, and ``mae``, as the multi-task CV
      scores them

    * a cox result: ``deviance`` (-2 Breslow log partial likelihood, on
      the host in float64 numpy, as the CV driver scores it) and ``C``
      (Harrell's concordance, not under left truncation): pass
      ``time=``/``event=`` (with ``strata=``/``start=`` as fitted) or
      ``y`` as an (n, 2) [time, event] or (n, 3) [start, stop, event]
      array

    ``eta=`` scores a given (nlambda, n) predictor matrix instead.  A CV
    result assesses its full-data fit at ``lam="lambda.1se"`` by default.
    """
    from .models.cox import CoxPathResult
    from .models.multinomial import MNPathResult
    from .models.multitask import MTPathResult
    from .models.svm import SVMResult

    result, lam = _resolve_cv(result, lam)
    if isinstance(result, CoxPathResult):
        return _assess_cox(result, X, y, weights, lam, offset, time, event,
                           strata, start)
    if isinstance(result, SVMResult):
        raise TypeError("assess takes no SVMResult: score "
                        "predict(fit, X, type='class') against the labels")
    etam = _eta_matrix(result, X, eta, offset)
    device = etam.device
    w = None if weights is None else _f64(weights, device).ravel()

    def agg(per_obs):
        # weighted mean over observations, per path point
        if w is None:
            return per_obs.mean(dim=-1)
        return (per_obs * w).sum(dim=-1) / w.sum()

    y = _f64(y, device)
    if etam.dim() == 2:
        y = y.ravel()
    yr = y[None]
    fam_obj = None if isinstance(family, str) else _family_object(family)
    if isinstance(result, MNPathResult):
        # Multinomial deviance -2 log p_y, argmax class error, and the
        # Brier-style mse/mae over the probability simplex.
        yi = y.ravel().to(torch.int64)
        logp = torch.log_softmax(etam, dim=2)
        logp_y = torch.gather(
            logp, 2, yi[None, :, None].expand(etam.shape[0], -1, 1))[..., 0]
        P = torch.softmax(etam, dim=2)
        Y1 = torch.nn.functional.one_hot(yi, etam.shape[2]).to(etam.dtype)
        out = {"deviance": agg(-2.0 * logp_y),
               "class": agg((torch.argmax(etam, dim=2) != yi[None, :])
                            .to(etam.dtype)),
               "mse": agg(((P - Y1[None]) ** 2).sum(dim=2)),
               "mae": agg(torch.abs(P - Y1[None]).sum(dim=2))}
    elif isinstance(result, MTPathResult):
        # The error summed over tasks, per observation: what
        # cv_multitask_lasso_path scores (the JAX package's assess leaves
        # the task axis in place and returns per-observation arrays).
        r = etam - yr
        out = {"deviance": agg((r * r).sum(dim=2)),
               "mse": agg((r * r).sum(dim=2)),
               "mae": agg(torch.abs(r).sum(dim=2))}
    elif fam_obj is not None:
        mu = (etam if fam_obj.mean_eta is None
              else fam_obj.mean_eta(etam))
        out = {"deviance": agg(fam_obj.cv_loss(etam, y)),
               "mse": agg((mu - yr) ** 2),
               "mae": agg(torch.abs(mu - yr))}
        if fam_obj.name.startswith("binomial"):
            out["class"] = agg(((mu > 0.5) != (yr > 0.5)).to(etam.dtype))
            out["auc"] = _auc_rows(etam, y, w)
    elif family == "gaussian":
        se = (etam - yr) ** 2
        out = {"deviance": agg(se), "mse": agg(se),
               "mae": agg(torch.abs(etam - yr))}
    elif family == "binomial":
        p = 1.0 / (1.0 + torch.exp(-etam))
        out = {"deviance": agg(_binomial_dev(etam, y)),
               "class": agg(((etam > 0.0) != (yr > 0.5)).to(etam.dtype)),
               "auc": _auc_rows(etam, y, w),
               "mse": agg((p - yr) ** 2),
               "mae": agg(torch.abs(p - yr))}
    elif family == "poisson":
        mu = torch.exp(etam)
        ylogy = torch.where(y > 0, y * torch.log(torch.clamp(y, min=1e-300)),
                            torch.zeros_like(y))
        out = {"deviance": agg(2.0 * (ylogy[None, :] - yr * etam
                                      - (yr - mu))),
               "mse": agg((mu - yr) ** 2),
               "mae": agg(torch.abs(mu - yr))}
    else:
        raise ValueError("family must be 'gaussian', 'binomial' or "
                         "'poisson' (multinomial/cox dispatch on the "
                         "result type)")
    out = {k: to_numpy(v) for k, v in out.items()}
    if lam is None:
        return out
    lams = (np.asarray(to_numpy(result.lambdas)) if result is not None
            else np.arange(etam.shape[0]))
    i = int(np.argmin(np.abs(lams - float(lam))))
    return {k: v[i] for k, v in out.items()}


def _assess_cox(result, X, y, weights, lam, offset, time, event, strata,
                start):
    """:func:`assess` of a Cox path: the Breslow deviance per path point
    (``models.cox._breslow_pl``, float64 numpy) and, without ``start``,
    Harrell's C of ``X coef (+ offset)`` (:func:`c_index`, on the fit's
    device)."""
    from .models.cox import _breslow_pl

    if time is None:
        yz = np.asarray(to_numpy(y), np.float64)
        if yz.ndim == 2 and yz.shape[1] == 3:
            start, time, event = yz[:, 0], yz[:, 1], yz[:, 2]
        elif yz.ndim == 2 and yz.shape[1] == 2:
            time, event = yz[:, 0], yz[:, 1]
        else:
            raise ValueError("cox assess needs time=/event= or y as an "
                             "(n, 2) [time, event] or (n, 3) [start, stop, "
                             "event] array")
    t = np.asarray(to_numpy(time), np.float64).ravel()
    d = np.asarray(to_numpy(event), np.float64).ravel()
    Xh = np.asarray(to_numpy(X), np.float64)
    C = np.asarray(to_numpy(result.coef), np.float64)
    host = lambda v: None if v is None else np.asarray(to_numpy(v))
    # glmnet's newoffset: a fit made with offset= is scored at Xb + offset.
    out = {"deviance": -2.0 * _breslow_pl(Xh, t, d, C, host(weights),
                                          host(offset), host(strata),
                                          host(start))}
    if start is None:
        # Harrell's C is undefined under left truncation.
        etam = _predict(result, X, None, "link", "gaussian", offset, None)
        out["C"] = np.atleast_1d(c_index(etam, t, d, weights))
    if lam is None:
        return out
    lams = np.asarray(to_numpy(result.lambdas), np.float64)
    i = int(np.argmin(np.abs(lams - float(lam))))
    return {k: v[i] for k, v in out.items()}


def _auc_rows(etam, y, w=None):
    """Row-wise Mann-Whitney AUC of an (L, n) score matrix against binary
    ``y``: each positive counts the weight of the negatives scored below
    it and half that of those tied with it (the average-rank rule; with
    weights, sklearn's weighted ``roc_auc_score``), read off each row's
    sorted negative scores and their running weight."""
    pos = y > 0.5
    npos = int(pos.sum())
    nneg = y.numel() - npos
    if w is None:
        if npos == 0 or nneg == 0:
            raise ValueError("AUC needs both classes present")
        w = torch.ones_like(y)
    wp, wn = w[pos], w[~pos]
    neg_sorted, order = torch.sort(etam[:, ~pos], dim=1)
    run = torch.cumsum(wn[order], dim=1)
    run = torch.cat([torch.zeros_like(run[:, :1]), run], dim=1)
    scores = etam[:, pos].contiguous()
    below = torch.gather(run, 1, torch.searchsorted(neg_sorted, scores))
    upto = torch.gather(run, 1, torch.searchsorted(neg_sorted, scores,
                                                   right=True))
    u = ((below + 0.5 * (upto - below)) * wp[None, :]).sum(dim=1)
    return u / (wp.sum() * wn.sum())


def roc(result, X, y, *, lam: Optional[float] = None, eta=None):
    """The ROC curve of a binomial fit at one path point (glmnet's
    ``roc.glmnet``): ``(fpr, tpr)`` stepping through the sorted unique
    scores from (0, 0) to (1, 1).  ``lam`` defaults to the smallest grid
    point; ``eta=`` scores a given (n,) score vector instead."""
    if eta is None:
        if lam is None:
            lam = float(np.asarray(to_numpy(result.lambdas))[-1])
        eta = _predict(result, X, lam, "link", "gaussian", None, None)
    eta = _f64(eta, _own_device(eta)).ravel()
    y = _f64(y, eta.device).ravel()
    pos, neg = y > 0.5, y <= 0.5
    npos, nneg = float(pos.sum()), float(neg.sum())
    if npos == 0 or nneg == 0:
        raise ValueError("ROC needs both classes present")
    order = torch.argsort(-eta, stable=True)
    tp = torch.cumsum(pos[order].to(eta.dtype), dim=0)
    fp = torch.cumsum(neg[order].to(eta.dtype), dim=0)
    # Tied thresholds collapse: keep the last index of each tied block.
    ranked = eta[order]
    keep = torch.cat([ranked[1:] != ranked[:-1],
                      torch.ones(1, dtype=torch.bool, device=eta.device)])
    zero = torch.zeros(1, dtype=eta.dtype, device=eta.device)
    fpr = torch.cat([zero, fp[keep] / nneg])
    tpr = torch.cat([zero, tp[keep] / npos])
    return to_numpy(fpr), to_numpy(tpr)


def confusion(result, X, y, *, lam: Optional[float] = None):
    """True-by-predicted class counts at one path point (glmnet's
    ``confusion.glmnet``): a (C, C) array, rows the true class, columns the
    predicted one; binomial fits predict at a mean of 1/2, multinomial
    fits the softmax argmax.  ``lam`` defaults to the smallest grid
    point."""
    from .models.multinomial import MNPathResult

    if lam is None:
        lam = float(np.asarray(to_numpy(result.lambdas))[-1])
    pred = _predict(result, X, lam, "class", "binomial", None,
                    None).ravel()
    C = result.beta0.shape[-1] if isinstance(result, MNPathResult) else 2
    yi = _f64(y, pred.device).to(torch.int64).ravel()
    return to_numpy(torch.bincount(C * yi + pred, minlength=C * C)
                    .reshape(C, C))


def c_index(eta, time, event, weights=None):
    """Harrell's concordance index of risk scores (glmnet's ``Cindex``;
    a higher score should mean an earlier event), on ``eta``'s device.

    ``eta``: (n,) or (L, n) scores.  A pair (i, j) is comparable when
    ``t_i < t_j`` and subject i had an event, and concordant when ``eta_i
    > eta_j`` (ties count 1/2); rows with tied times are not comparable.
    ``weights``: pair (i, j) carries ``w_i * w_j``.
    """
    device = _own_device(eta)
    eta = _f64(eta, device)
    one = eta.ndim == 1
    E = eta[None, :] if one else eta            # (L, n)
    t = _f64(time, device).ravel()
    d = _f64(event, device).ravel()
    comp = ((t[:, None] < t[None, :])
            & (d[:, None] > 0)).to(eta.dtype)              # (n, n)
    if weights is not None:
        w = _f64(weights, device).ravel()
        comp = comp * torch.outer(w, w)
    ncomp = float(comp.sum())
    if ncomp == 0:
        raise ValueError("no comparable pairs (need an event with a "
                         "later follow-up)")
    diff = E[:, :, None] - E[:, None, :]        # (L, n, n) eta_i - eta_j
    conc = (diff > 0).to(eta.dtype) + 0.5 * (diff == 0).to(eta.dtype)
    out = to_numpy((conc * comp[None]).sum(dim=(1, 2)) / ncomp)
    return float(out[0]) if one else out
