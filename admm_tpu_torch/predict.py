"""Prediction from fitted lambda paths, glmnet's ``predict`` (counterpart of
``admm_tpu/predict.py``)::

    res = admm_tpu_torch.logistic_lasso_path(X, y)
    eta = admm_tpu_torch.predict(res, Xnew)                   # (L, m) link
    p   = admm_tpu_torch.predict(res, Xnew, type="response",
                                 family="binomial")           # probabilities
    cv  = admm_tpu_torch.cv_lasso_path(X, y)
    yhat = admm_tpu_torch.predict(cv, Xnew, lam="lambda.min")

Covers the port's path results (``PathResult`` of the gaussian and GLM
paths) and the CV results of :mod:`admm_tpu_torch.models.cv`; another
result type raises ``TypeError``.  ``type="response"`` applies the
inverse link named by ``family`` ("binomial" -> sigmoid, "poisson" -> exp,
gaussian the identity), or a :class:`GLMFamily`'s own ``mean_eta``.

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
    range; exact on the grid).  Returns a one-point result of the same
    type, its coefficients float64 on the fit's device."""
    lams = np.asarray(to_numpy(result.lambdas), np.float64)   # decreasing
    s = float(np.clip(float(lam), lams.min(), lams.max()))
    right = int(np.searchsorted(-lams, -s))     # first i with lams[i] <= s
    left = max(right - 1, 0)
    frac = 0.0 if right == left else \
        float((lams[left] - s) / max(lams[left] - lams[right], 1e-300))
    device = _device_of(result)

    def mix(a):
        a = _f64(a, device)
        return ((1.0 - frac) * a[left] + frac * a[right])[None]

    return result._replace(lambdas=np.array([s]), coef=mix(result.coef),
                           beta0=mix(result.beta0))


def _resolve_cv(result, lam):
    """glmnet's ``predict.cv.glmnet`` / ``coef.cv.glmnet``: a CV result
    predicts through its full-data fit at ``"lambda.1se"`` by default,
    ``"lambda.min"``, or a number.  Returns ``(fit, lam)``; a plain path
    result passes through unchanged."""
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


def _predict(result, X, lam, type, family, offset, tau):
    """:func:`predict` with the result left on the fit's device: a
    tensor, or a list of numpy index arrays for ``type="nonzero"``."""
    from .models.lasso import PathResult

    if tau is not None:
        raise ValueError("tau= applies to quantile path results only")
    result, lam = _resolve_cv(result, lam)
    if not isinstance(result, PathResult):
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
    if type == "nonzero":
        nz = to_numpy(result.coef != 0.0)
        if squeeze:
            return np.flatnonzero(nz[0])
        return [np.flatnonzero(m) for m in nz]
    if type == "coefficients":
        out = torch.cat([_f64(result.beta0, device)[:, None],
                         _f64(result.coef, device)], dim=1)
        return out[0] if squeeze else out
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
    docstring).  ``offset`` is glmnet's ``newoffset``.  ``tau`` selects a
    quantile lane in the JAX package; the quantile results are not ported
    yet, so it must stay None."""
    out = _predict(result, X, lam, type, family, offset, tau)
    return to_numpy(out) if isinstance(out, torch.Tensor) else out


def coef(result, *, lam=None):
    """The intercept-prepended coefficients at ``lam`` (or the whole
    path), glmnet's ``coef(fit, s=)``: ``predict(result, None,
    type="coefficients", lam=lam)``.  CV results default to
    ``lam="lambda.1se"``."""
    return predict(result, None, type="coefficients", lam=lam)
