"""The glmnet front door: ``glmnet(X, y, family=...)``, ``cv_glmnet(...)``
and ``big_glm(...)`` dispatching every family to the port's path driver
(counterpart of ``admm_tpu/glmnet.py``).

For users arriving from glmnet, where one ``glmnet()`` call with a
``family=`` string reaches every model: ``gaussian`` (lasso / elastic net
on ``alpha``), ``binomial``, ``poisson``, ``multinomial``, ``mgaussian``
(the multi-task driver), ``cox`` (``y`` as glmnet's ``Surv``: an (n, 2)
``[time, status]`` or (n, 3) ``[start, stop, status]`` array, or
``time=``/``event=``) and the ``huber`` extension, or a
:class:`~admm_tpu_torch.models.glm.GLMFamily` (glmnet 4.x family
objects).  Every other keyword (``device``, ``dtype``, ``weights``, ...)
passes through to the driver, which keeps its own defaults; each returns
the driver's result type.  The front end adds no work of its own: the
kernels a call launches are its driver's (the gaussian paths' tall
kernels, the binomial and huber GLM kernel).
"""
from __future__ import annotations

import numpy as np

from .predict import _family_object

_FAMILIES = ("gaussian", "binomial", "poisson", "multinomial",
             "mgaussian", "cox", "huber")


def _cox_args(y, time, event):
    """``(time, event, start)`` from glmnet's Surv-style ``y`` (an (n, 2)
    ``[time, status]`` or (n, 3) ``[start, stop, status]`` array) or the
    explicit keywords."""
    if time is not None:
        if event is None:
            raise ValueError("pass event= together with time=")
        return time, event, None
    yz = np.asarray(y.detach().cpu().numpy() if hasattr(y, "detach") else y,
                    np.float64)
    if yz.ndim == 2 and yz.shape[1] == 2:
        return yz[:, 0], yz[:, 1], None
    if yz.ndim == 2 and yz.shape[1] == 3:
        return yz[:, 1], yz[:, 2], yz[:, 0]
    raise ValueError("family='cox' needs y as an (n, 2) [time, status]"
                     " or (n, 3) [start, stop, status] array, or "
                     "time=/event=")


def _check_family(family, relax):
    """The family object (or None for a string family), after glmnet's
    argument checks."""
    fam_obj = _family_object(family)
    if fam_obj is None and family not in _FAMILIES:
        raise ValueError(f"family must be one of {_FAMILIES} or a "
                         "GLMFamily instance (admm_tpu_torch.models.glm)")
    if relax and (fam_obj is not None or family != "gaussian"):
        raise ValueError("relax=True is implemented for family='gaussian'")
    return fam_obj


def _grouped(type_multinomial):
    if type_multinomial not in ("ungrouped", "grouped"):
        raise ValueError("type_multinomial must be 'ungrouped' or "
                         "'grouped'")
    return type_multinomial == "grouped"


def glmnet(X, y=None, family: str = "gaussian", *, alpha: float = 1.0,
           type_multinomial: str = "ungrouped", relax: bool = False,
           time=None, event=None, **kw):
    """Fit a regularization path for any family (glmnet's ``glmnet()``).

    Same arguments as ``admm_tpu.glmnet``: ``family`` picks the driver and
    every other keyword passes through to it, so each family keeps its
    own defaults and argument surface.  ``relax=True`` (gaussian only) is
    the relaxed lasso on the same lambda sequence.
    """
    from .models.cox import cox_lasso_path
    from .models.glm import glm_lasso_path, huber_lasso_path, \
        poisson_lasso_path
    from .models.lasso import enet_path, lasso_path
    from .models.logistic import logistic_lasso_path
    from .models.multinomial import multinomial_lasso_path
    from .models.multitask import multitask_lasso_path
    from .models.relaxed import relaxed_lasso_path

    fam_obj = _check_family(family, relax)
    if fam_obj is not None:
        return glm_lasso_path(X, y, fam_obj, alpha=alpha, **kw)
    if relax:
        return relaxed_lasso_path(X, y, alpha=alpha,
                                  _enet_scale=alpha != 1.0, **kw)
    if family == "gaussian":
        if alpha == 1.0:
            return lasso_path(X, y, **kw)
        return enet_path(X, y, alpha=alpha, **kw)
    if family in ("binomial", "poisson", "huber"):
        # The family wrappers carry each family's own defaults (e.g.
        # poisson's newton_steps=1).
        fn = {"binomial": logistic_lasso_path,
              "poisson": poisson_lasso_path,
              "huber": huber_lasso_path}[family]
        return fn(X, y, alpha=alpha, **kw)
    if family == "multinomial":
        return multinomial_lasso_path(X, y, alpha=alpha,
                                      grouped=_grouped(type_multinomial),
                                      **kw)
    if family == "mgaussian":
        return multitask_lasso_path(X, y, alpha=alpha, **kw)
    t, d, st = _cox_args(y, time, event)
    if st is not None:
        kw.setdefault("start", st)
    return cox_lasso_path(X, t, d, alpha=alpha, **kw)


def big_glm(X, y=None, family: str = "gaussian", *, weights=None,
            offset=None, lower_limits=None, upper_limits=None,
            intercept: bool = True, time=None, event=None, **kw):
    """One UNPENALIZED fit (glmnet's ``bigGlm``) as a one-point path
    (``lambdas == [0.0]``) that ``predict``/``assess``/``coef`` take.

    The lambda = 0 point runs on the same engines; the gaussian auto-rho
    is zero at lambda = 0, so rho is pinned to 1 there (any positive rho
    reaches the same optimum).  Coefficient limits are refused for the
    multinomial and multi-task families, as in glmnet.
    """
    is_glm_obj = _family_object(family) is not None
    if family in ("gaussian", "mgaussian") and "rho" not in kw:
        kw["rho"] = 1.0
    if offset is not None:
        kw["offset"] = offset
    if is_glm_obj or family in ("gaussian", "binomial", "poisson", "huber",
                                "cox"):
        kw["lower_limits"] = lower_limits
        kw["upper_limits"] = upper_limits
    elif lower_limits is not None or upper_limits is not None:
        raise ValueError("coefficient limits are not supported for "
                         f"family {family!r} (glmnet's own multinomial "
                         "restriction)")
    if family != "cox":
        kw["intercept"] = intercept
    if weights is not None:
        kw["weights"] = weights
    return glmnet(X, y, family, lambdas=np.zeros(1), time=time, event=event,
                  **kw)


def cv_glmnet(X, y=None, family: str = "gaussian", *, alpha: float = 1.0,
              type_multinomial: str = "ungrouped", relax: bool = False,
              time=None, event=None, **kw):
    """Cross-validate any family's path (glmnet's ``cv.glmnet()``).

    The dispatch of :func:`glmnet`; every CV keyword (``nfolds``,
    ``foldid``, ``type_measure``, ``keep``, ``seed``, ...) passes through
    to the family's CV driver, whose result it returns.
    """
    from .models import glm
    from .models.cox import cv_cox_path
    from .models.cv import (cv_enet_path, cv_glm_path, cv_lasso_path,
                            cv_multinomial_path, cv_multitask_lasso_path)
    from .models.relaxed import cv_relaxed_lasso_path

    fam_obj = _check_family(family, relax)
    if fam_obj is not None:
        return cv_glm_path(X, y, fam_obj, alpha=alpha, **kw)
    if relax:
        return cv_relaxed_lasso_path(X, y, alpha=alpha,
                                     _enet_scale=alpha != 1.0, **kw)
    if family == "gaussian":
        if alpha == 1.0:
            return cv_lasso_path(X, y, **kw)
        return cv_enet_path(X, y, alpha=alpha, **kw)
    if family in ("binomial", "poisson", "huber"):
        fam = {"binomial": glm.binomial, "poisson": glm.poisson,
               "huber": glm.huber}[family]()
        return cv_glm_path(X, y, fam, alpha=alpha, **kw)
    if family == "multinomial":
        return cv_multinomial_path(X, y, alpha=alpha,
                                   grouped=_grouped(type_multinomial), **kw)
    if family == "mgaussian":
        return cv_multitask_lasso_path(X, y, alpha=alpha, **kw)
    t, d, st = _cox_args(y, time, event)
    if st is not None:
        kw.setdefault("start", st)
    return cv_cox_path(X, t, d, alpha=alpha, **kw)
