"""Prediction from fitted lambda paths, glmnet's ``predict`` (counterpart of
``admm_tpu/predict.py``)::

    res = admm_tpu_torch.logistic_lasso_path(X, y)
    eta = admm_tpu_torch.predict(res, Xnew)                   # (L, m) link
    p   = admm_tpu_torch.predict(res, Xnew, type="response",
                                 family="binomial")           # probabilities
    cv  = admm_tpu_torch.cv_lasso_path(X, y)
    yhat = admm_tpu_torch.predict(cv, Xnew, lam="lambda.min")

Covers the port's path results and the CV results of its ``cv_*``
drivers; another result type raises ``TypeError``:

* ``PathResult`` (gaussian, GLM and the Lasso's relatives): (L, m)
  linear predictors; ``type="response"`` applies the inverse link named
  by ``family`` ("binomial" -> sigmoid, "poisson" -> exp, gaussian the
  identity), or a :class:`GLMFamily`'s own ``mean_eta``;
* ``QuantilePathResult``: the lane picked by ``tau=``, as a gaussian path;
* ``SVMResult``: decision values (``"link"``) or the original labels
  (``"class"``), on the C grid (CV results select ``"C_min"``/``"C_1se"``);
* ``MTPathResult``: (L, m, K) linear predictors;
* ``MNPathResult``: (L, m, C) linear predictors, softmax probabilities
  (``"response"``) or the argmax class (``"class"``);
* ``CoxPathResult``: (L, m) linear predictors ``X coef`` (no intercept:
  the baseline hazard absorbs it) or the relative risk ``exp`` of them
  (``"response"``); ``"coefficients"`` has no intercept row.

``lam`` (glmnet's ``s=``, ``exact=FALSE``) drops the leading lambda
axis: an ``s`` on the grid is exact, an off-grid ``s`` interpolates the
coefficients linearly between its bracketing grid points on the lambda
scale, clamped to the grid's range.  ``type="coefficients"`` returns the
intercept-prepended coefficients and ``type="nonzero"`` the indices of the
nonzero ones (``X`` unused for both).

The work runs in float64 on the device of the fit's coefficients (the
card for a fit made there; ``X`` goes there at its own dtype and is cast
on arrival) and the results come back as numpy arrays, as the JAX
package returns them.
"""
from __future__ import annotations

import numpy as np
import torch

from .interop import to_numpy


def _device_of(result) -> torch.device:
    """Where a result's post-processing runs: its coefficients' device."""
    coef = result.coef
    return coef.device if isinstance(coef, torch.Tensor) \
        else torch.device("cpu")


def _f64(a, device) -> torch.Tensor:
    """A tensor, numpy array or scalar as a float64 tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if not a.flags.writeable:     # e.g. a JAX array's buffer
            a = a.copy()
        a = torch.as_tensor(a, device=device)
    return a.to(device=device, dtype=torch.float64)


def _at_lam(result, lam):
    """glmnet's ``lambda.interp``: the coefficients at ``s`` linearly
    interpolated between the bracketing grid points (clamped to the grid
    range; exact on the grid), on the lambda grid or an SVM's C grid.
    Returns a one-point result of the same type, its coefficients float64
    on the fit's device."""
    grid = "lambdas" if hasattr(result, "lambdas") else "Cs"
    lams = np.asarray(to_numpy(getattr(result, grid)), np.float64)  # decr.
    s = float(np.clip(float(lam), lams.min(), lams.max()))
    right = int(np.searchsorted(-lams, -s))     # first i with lams[i] <= s
    left = max(right - 1, 0)
    frac = 0.0 if right == left else \
        float((lams[left] - s) / max(lams[left] - lams[right], 1e-300))
    device = _device_of(result)

    def mix(a):
        a = _f64(a, device)
        return ((1.0 - frac) * a[left] + frac * a[right])[None]

    out = {grid: np.array([s]), "coef": mix(result.coef)}
    icpt = "intercept" if grid == "Cs" else "beta0"
    if hasattr(result, icpt):        # a Cox path has no intercept
        out[icpt] = mix(getattr(result, icpt))
    return result._replace(**out)


def _resolve_cv(result, lam):
    """glmnet's ``predict.cv.glmnet`` / ``coef.cv.glmnet``: a CV result
    predicts through its full-data fit at ``"lambda.1se"`` by default,
    ``"lambda.min"``, or a number.  Returns ``(fit, lam)``; a plain path
    result passes through unchanged."""
    if hasattr(result, "fit") and hasattr(result, "C_1se"):
        # SVM CV results select on the C grid (the one-SE point at the
        # smaller C, stronger regularization).
        if lam is None:
            lam = "C_1se"
        if isinstance(lam, str):
            key = lam.replace(".", "_").replace("lambda", "C")
            if key not in ("C_1se", "C_min"):
                raise ValueError("lam must be numeric, 'C_min' or "
                                 "'C_1se' for SVM CV results")
            lam = getattr(result, key)
        return result.fit, float(lam)
    if not (hasattr(result, "fit") and hasattr(result, "lambda_1se")):
        if isinstance(lam, str):
            raise ValueError("string lam selectors need a CV result")
        return result, lam
    if lam is None:
        lam = "lambda_1se"
    if isinstance(lam, str):
        key = lam.replace(".", "_")
        if key not in ("lambda_1se", "lambda_min"):
            raise ValueError("lam must be numeric, 'lambda.min' or "
                             "'lambda.1se' for CV results")
        lam = getattr(result, key)
    return result.fit, float(lam)


def _family_object(family):
    """A :class:`GLMFamily` instance for ``family`` when it is one (or a
    zero-argument factory of one, e.g. ``binomial_probit``), else None
    (the family is then named by a string)."""
    from .models.glm import GLMFamily

    if isinstance(family, GLMFamily):
        return family
    if callable(family):
        fam = family()
        if not isinstance(fam, GLMFamily):
            raise ValueError("family factory must return a GLMFamily")
        return fam
    return None


def _inverse_link(eta, family, fam_obj):
    """glmnet's ``type="response"`` of a linear predictor tensor."""
    if fam_obj is not None:
        return eta if fam_obj.mean_eta is None else fam_obj.mean_eta(eta)
    if family == "binomial":
        return 1.0 / (1.0 + torch.exp(-eta))
    if family == "poisson":
        return torch.exp(eta)
    if family != "gaussian":
        raise ValueError(f"unknown family {family!r}")
    return eta


def _linear_predictor(result, X, offset):
    """The (L, m) float64 linear predictors of a path result on the fit's
    device: ``beta0 + X coef`` (plus glmnet's ``newoffset``)."""
    device = _device_of(result)
    eta = (_f64(result.beta0, device)[:, None]
           + _f64(result.coef, device) @ _f64(X, device).T)
    if offset is not None:
        eta = eta + _f64(offset, device)[None, :]
    return eta


def _quantile_lane(result, lam, tau):
    """A quantile fit (or ``cv_quantile_lasso_path``'s dict) at one tau, as
    a gaussian ``PathResult`` on that tau's grid; a CV dict resolves string
    selectors per tau (``"lambda.min"`` by default).  Returns ``(result,
    lam)``."""
    from .models.lasso import PathResult

    cv = result if isinstance(result, dict) else None
    fit = result["fit"] if cv is not None else result
    taus = np.asarray(to_numpy(fit.taus), np.float64)
    if tau is None:
        if taus.shape[0] != 1:
            raise ValueError("this quantile fit has a tau grid; "
                             "pass tau= to pick a lane")
        ti = 0
    else:
        # float32 fits store tau at single precision.
        close = np.isclose(taus, float(tau), rtol=0, atol=1e-6)
        if not close.any():
            raise ValueError(f"tau={tau} is not on the fitted grid "
                             f"{taus.tolist()}")
        ti = int(np.argmax(close))
    lane = PathResult(lambdas=fit.lambdas[ti], beta0=fit.beta0[ti],
                      coef=fit.coef[ti], niter=fit.niter[ti])
    if cv is not None:
        if lam is None:
            lam = "lambda_min"
        if isinstance(lam, str):
            key = lam.replace(".", "_")
            if key not in ("lambda_min", "lambda_1se"):
                raise ValueError("lam must be numeric, 'lambda.min' or "
                                 "'lambda.1se' for quantile CV results")
            lam = float(np.asarray(cv[key])[ti])
    return lane, lam


def _predict(result, X, lam, type, family, offset, tau):
    """:func:`predict` with the result left on the fit's device: a
    tensor, or a list of numpy index arrays for ``type="nonzero"``."""
    from .models.cox import CoxPathResult
    from .models.lasso import PathResult
    from .models.multinomial import MNPathResult
    from .models.multitask import MTPathResult
    from .models.quantile import QuantilePathResult
    from .models.svm import SVMResult

    if isinstance(result, QuantilePathResult) or (
            isinstance(result, dict)
            and isinstance(result.get("fit"), QuantilePathResult)):
        result, lam = _quantile_lane(result, lam, tau)
    elif tau is not None:
        raise ValueError("tau= applies to quantile path results only")
    result, lam = _resolve_cv(result, lam)
    if not isinstance(result, (PathResult, SVMResult, MTPathResult,
                               MNPathResult, CoxPathResult)):
        raise TypeError(f"predict does not take "
                        f"{result.__class__.__name__} results in "
                        "admm_tpu_torch yet")
    squeeze = lam is not None
    if squeeze:
        result = _at_lam(result, lam)

    if type not in ("link", "response", "class", "coefficients",
                    "nonzero"):
        raise ValueError("type must be 'link', 'response', 'class', "
                         "'coefficients' or 'nonzero'")
    device = _device_of(result)
    svm = isinstance(result, SVMResult)
    cox = isinstance(result, CoxPathResult)
    if type == "nonzero":
        # Matrix families: the rows with any nonzero entry.
        nz = result.coef != 0.0
        nz = to_numpy(nz if nz.dim() == 2 else torch.any(nz, dim=-1))
        if squeeze:
            return np.flatnonzero(nz[0])
        return [np.flatnonzero(m) for m in nz]
    if type == "coefficients":
        coef = _f64(result.coef, device)
        out = coef if cox else torch.cat(
            [_f64(result.intercept if svm else result.beta0,
                  device)[:, None], coef], dim=1)
        return out[0] if squeeze else out
    if cox:
        eta = _f64(result.coef, device) @ _f64(X, device).T       # (L, m)
        if offset is not None:
            # glmnet's newoffset, added before exp for "response".
            eta = eta + _f64(offset, device).reshape(-1)[None, :]
        if type == "response":
            eta = torch.exp(eta)
        elif type == "class":
            raise ValueError("cox predictions are 'link' (linear "
                             "predictor) or 'response' (relative risk)")
        return eta[0] if squeeze else eta
    beta0 = _f64(result.intercept if svm else result.beta0, device)
    if svm:
        # 'link' = decision values; 'class' maps back through the original
        # labels (the hinge losses have no probability scale).
        if type == "response":
            raise ValueError("SVM predictions are 'link' (decision "
                             "values) or 'class'")
        eta = beta0[:, None] + _f64(result.coef, device) @ _f64(X, device).T
        if type == "class":
            cls = result.classes or (-1, 1)
            eta = np.where(to_numpy(eta) > 0, cls[1], cls[0])
        return eta[0] if squeeze else eta
    if isinstance(result, (MNPathResult, MTPathResult)):
        # (L, m, K) = beta0 (L, K) + X (m, p) coef (L, p, K)
        eta = beta0[:, None, :] + torch.einsum(
            "mp,lpc->lmc", _f64(X, device), _f64(result.coef, device))
        if offset is not None:
            # (m,) broadcasts across classes, (m, C) applies per class.
            off = _f64(offset, device)
            eta = eta + (off[None, :, None] if off.dim() == 1
                         else off[None, :, :])
        if isinstance(result, MNPathResult):
            if type == "response":
                eta = torch.softmax(eta, dim=2)
            elif type == "class":
                eta = torch.argmax(eta, dim=2)
        elif type != "link":
            raise ValueError("multi-task predictions are 'link' only")
        return eta[0] if squeeze else eta
    fam_obj = None if isinstance(family, str) else _family_object(family)
    is_binom = (family == "binomial" if fam_obj is None
                else fam_obj.name.startswith("binomial"))
    if type == "class" and not is_binom:
        raise ValueError("type='class' needs a binomial family "
                         "(or a multinomial result)")
    eta = _linear_predictor(result, X, offset)
    if type in ("response", "class"):
        eta = _inverse_link(eta, family, fam_obj)
        if type == "class":
            eta = (eta > 0.5).to(torch.int64)
    return eta[0] if squeeze else eta


def predict(result, X, *, lam=None, type: str = "link",
            family: str = "gaussian", offset=None, tau=None):
    """Predict from a fitted path result or a CV result (module
    docstring).  ``offset`` is glmnet's ``newoffset``.  ``tau`` selects
    the lane of a quantile fit (one of its fitted levels; optional for a
    single tau), which then predicts as a gaussian path on that tau's
    grid."""
    out = _predict(result, X, lam, type, family, offset, tau)
    return to_numpy(out) if isinstance(out, torch.Tensor) else out


def coef(result, *, lam=None):
    """The intercept-prepended coefficients at ``lam`` (or the whole
    path), glmnet's ``coef(fit, s=)``: ``predict(result, None,
    type="coefficients", lam=lam)``.  CV results default to
    ``lam="lambda.1se"``."""
    return predict(result, None, type="coefficients", lam=lam)
