"""Chainable builders mirroring the reference's five exports (counterpart
of ``admm_tpu/api.py``; reference: NAMESPACE:9-13, R/30_admm_lasso.R)::

    fit = admm_lasso(x, y).penalty(nlambda=50).opts(eps_rel=1e-3).fit()
    fit.beta     # scipy.sparse CSC, (p+1) x nlambda, intercept in row 0

Validation follows the JAX package's builders line by line.  ``device``
says where numpy inputs go (default ``"cuda"``); a tensor input stays on
its own device.  ``admm_lad`` and ``admm_bp`` also take ``dtype``: None
means ``torch.float32`` (the JAX package reads its global x64 flag there,
which torch does not have), ``torch.float64`` the reference's double.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .diag import profile
from .interop import to_numpy
from .models.bp import bp_fit
from .models.dantzig import dantzig_path
from .models.lad import lad_fit
from .models.lasso import enet_path, lasso_path
from .parallel.consensus import (parallel_bp_fit, parallel_enet_path,
                                 parallel_lasso_path)


@profile.spanned("validate")
def _check_xy(x, y):
    """Shape and finiteness checks; numpy inputs stay numpy, tensors stay
    tensors (on their device)."""
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        x = torch.as_tensor(x)
        y = torch.as_tensor(y, device=x.device).reshape(-1)
        if not x.is_floating_point():
            x = x.to(torch.float64)
        if not y.is_floating_point():
            y = y.to(torch.float64)
        finite = lambda t: bool(torch.isfinite(t).all())
    else:
        x = np.asarray(x)
        y = np.asarray(y).ravel()
        if not np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float64)
        if not np.issubdtype(y.dtype, np.floating):
            y = y.astype(np.float64)
        finite = lambda a: bool(np.isfinite(a).all())
    if x.ndim != 2:
        raise ValueError("x must be a 2-D matrix")
    if x.shape[0] != y.shape[0]:
        raise ValueError("nrow(x) should be equal to length(y)")
    # NaN/Inf inputs would spin the solvers to maxit: fail loudly.
    if not finite(x):
        raise ValueError("x contains NaN or Inf")
    if not finite(y):
        raise ValueError("y contains NaN or Inf")
    return x, y


def _sparse_beta(beta0, coef):
    """Pack a dense (nlambda, p) path and its intercepts into the
    reference's sparse (p+1) x nlambda layout, intercept in row 0
    (reference: src/Lasso.cpp:22-30, :91-92), with the native host packer
    where it builds (:mod:`admm_tpu_torch._native`)."""
    from ._native import pack_beta_csc

    return pack_beta_csc(beta0.detach().cpu().numpy(),
                         coef.detach().cpu().numpy())


def _trace_array(trace):
    return None if trace is None else trace.detach().cpu().numpy()


class _FitResult:
    #: (nlambda, trace_len, 5) or (trace_len, 5) numpy array of the
    #: per-iteration (eps_pri, r_pri, eps_dua, r_dua, rho), or None when
    #: tracing was off: the reference's (dead) residual printers as data
    #: (reference: src/ADMMBase.h:111-146).
    trace = None

    def format_trace(self, i: int = 0) -> str:
        """Render one solve's recorded trace as the reference's debug
        table (reference: src/ADMMBase.h:111-146).  ``i`` indexes the
        lambda for path fits; ignored for single-solve fits."""
        if self.trace is None:
            raise ValueError(
                "no trace recorded — fit with .opts(trace=True)")
        from .diag.trace import format_trace, trace_from_buffer

        buf = self.trace if self.trace.ndim == 2 else self.trace[i]
        title = ("ADMM iterations" if self.trace.ndim == 2
                 else f"ADMM iterations (lambda index {i})")
        return format_trace(trace_from_buffer(buf), title=title)


class ADMMLassoFit(_FitResult):
    """Lasso/Enet/Dantzig path fit (reference: R/30_admm_lasso.R:18-22).

    Attributes: ``lambda_`` (nlambda,), ``beta`` sparse (p+1) x nlambda
    with intercepts in row 0, ``niter`` (nlambda,), ``trace``
    (per-iteration residuals when requested via ``.opts(trace=True)``).
    """

    def __init__(self, lambda_, beta, niter, trace=None):
        self.lambda_ = np.asarray(lambda_)
        self.beta = beta
        self.niter = np.asarray(niter)
        self.trace = _trace_array(trace)

    def __repr__(self):
        return (f"{type(self).__name__}(lambda_={self.lambda_!r}, "
                f"niter={self.niter!r})")

    def plot(self, ax=None):
        """Solution-path plot (reference: R/30_admm_lasso.R:189-214)."""
        from .plotting import plot_solution_path
        return plot_solution_path(self.lambda_, self.beta, ax=ax)


@profile.spanned("pack")
def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class ADMMLADFit(_FitResult):
    """LAD fit (reference: R/20_admm_lad.R): dense ``beta``, intercept
    first, ``niter`` and ``trace``; ``x`` and ``y`` are kept, as host
    arrays, for the plot."""

    def __init__(self, beta, niter, x, y, trace=None):
        self.beta = np.asarray(beta)
        self.niter = int(niter)
        self.trace = _trace_array(trace)
        self._x, self._y = to_numpy(x), to_numpy(y)

    def __repr__(self):
        return f"{type(self).__name__}(niter={self.niter!r})"

    def plot(self, ax=None):
        """Fitted-vs-observed scatter (reference: R/20_admm_lad.R:87-100)."""
        from .plotting import plot_fitted_vs_observed
        fitted = self.beta[0] + self._x @ self.beta[1:]
        return plot_fitted_vs_observed(fitted, self._y, ax=ax)


class ADMMBPFit(_FitResult):
    """Basis-Pursuit fit (reference: R/10_admm_bp.R): sparse (p, 1)
    ``beta``, ``niter`` and ``trace``."""

    def __init__(self, beta, niter, trace=None):
        from scipy import sparse

        self.beta = sparse.csc_matrix(np.asarray(beta)[:, None])
        self.niter = int(niter)
        self.trace = _trace_array(trace)

    def __repr__(self):
        return f"{type(self).__name__}(niter={self.niter!r})"

    def plot(self, ax=None):
        """Coefficient stem plot (reference: R/10_admm_bp.R:152-163)."""
        from .plotting import plot_stem
        return plot_stem(np.asarray(self.beta.todense()).ravel(), ax=ax)


class ADMMLasso:
    """Builder for the Lasso (reference: R/30_admm_lasso.R:2-15).

    minimize 1/(2n) ||y - X beta||^2 + lambda ||beta||_1
    """

    _eps_default = 1e-5
    _rho_default = -1.0

    def __init__(self, x, y, intercept: bool = True,
                 standardize: bool = True, device="cuda"):
        self.x, self.y = _check_xy(x, y)
        self.intercept = bool(intercept)
        self.standardize = bool(standardize)
        self.device = device
        self.lambdas: Optional[np.ndarray] = None
        self.nlambda = 100
        n, p = self.x.shape
        self.lambda_min_ratio = 0.01 if n < p else 1e-4
        self.nthread = 1
        self.maxit = 10000
        self.eps_abs = self._eps_default
        self.eps_rel = self._eps_default
        self.rho = self._rho_default
        self.path_mode = "batch"
        self.trace = False
        self.penalty_factor = None
        self.lower_limits = None
        self.upper_limits = None

    # -- chainable setters ------------------------------------------------
    def penalty(self, lambda_=None, nlambda: int = 100,
                lambda_min_ratio: Optional[float] = None,
                penalty_factor=None, lower_limits=None,
                upper_limits=None, **kw):
        """(reference: R/30_admm_lasso.R:72-96).  ``penalty_factor``
        (glmnet's ``penalty.factor``: nonnegative per-coefficient
        multipliers, 0 = unpenalized) and ``lower_limits``/``upper_limits``
        (glmnet's coefficient box; ``lower_limits=0`` is the nonnegative
        lasso) go to ``lasso_path``."""
        self.penalty_factor = (None if penalty_factor is None
                               else np.asarray(penalty_factor,
                                               np.float64).ravel())
        self.lower_limits = lower_limits
        self.upper_limits = upper_limits
        if lambda_ is not None:
            lam = np.sort(np.asarray(lambda_, dtype=np.float64).ravel())[::-1]
            if np.any(lam <= 0):
                raise ValueError("lambda must be positive")
            self.lambdas = lam
        if nlambda <= 0:
            raise ValueError("nlambda must be a positive integer")
        if lambda_min_ratio is None:
            n, p = self.x.shape
            lambda_min_ratio = 0.01 if n < p else 1e-4
        if not (0.0 < lambda_min_ratio < 1.0):
            raise ValueError("lambda_min_ratio must be within (0, 1)")
        self.nlambda = int(nlambda)
        self.lambda_min_ratio = float(lambda_min_ratio)
        return self

    def parallel(self, nthread: int = 2, **kw):
        """(reference: R/30_admm_lasso.R:99-112).  ``nthread > 1`` fits
        by consensus ADMM over that many row blocks on the one device
        (:mod:`admm_tpu_torch.parallel.consensus`)."""
        nthread = max(int(nthread), 1)
        if nthread >= self.x.shape[1] / 5:
            raise ValueError("nthread cannot exceed ncol(x)/5")
        self.nthread = nthread
        return self

    def opts(self, maxit: int = 10000, eps_abs: Optional[float] = None,
             eps_rel: Optional[float] = None,
             rho: Optional[float] = None, path_mode: str = "batch",
             trace=False, **kw):
        """(reference: R/30_admm_lasso.R:115-133).  ``path_mode``:
        "batch" (default), "scan" or "activeset" (the wide regime's
        gathered active set; ``fit()`` raises ``ValueError`` for it on
        tall data).  ``trace``: ``True`` records the first 512 iterations'
        residuals per lambda in ``fit.trace``, an int that many (at most
        ``maxit``); a traced fit runs on the engine."""
        if maxit <= 0:
            raise ValueError("maxit should be positive")
        eps_abs = self._eps_default if eps_abs is None else eps_abs
        eps_rel = self._eps_default if eps_rel is None else eps_rel
        if eps_abs < 0 or eps_rel < 0:
            raise ValueError("eps_abs and eps_rel should be nonnegative")
        if rho is not None and rho <= 0:
            raise ValueError("rho should be positive")
        if path_mode not in ("batch", "scan", "activeset"):
            raise ValueError(
                "path_mode must be 'batch', 'scan' or 'activeset'")
        if trace is not False and trace is not True and int(trace) <= 0:
            raise ValueError("trace must be a bool or a positive int")
        self.maxit = int(maxit)
        self.eps_abs = float(eps_abs)
        self.eps_rel = float(eps_rel)
        self.rho = -1.0 if rho is None else float(rho)
        self.path_mode = path_mode
        self.trace = trace
        return self

    def _trace_len(self) -> Optional[int]:
        if self.trace is False:
            return None
        n = 512 if self.trace is True else int(self.trace)
        return min(n, self.maxit)

    # -- fitting ----------------------------------------------------------
    def _path_kwargs(self):
        return dict(lambdas=self.lambdas, nlambda=self.nlambda,
                    lambda_min_ratio=self.lambda_min_ratio,
                    standardize=self.standardize, intercept=self.intercept,
                    maxit=self.maxit, eps_abs=self.eps_abs,
                    eps_rel=self.eps_rel, rho=self.rho,
                    path_mode=self.path_mode, trace_len=self._trace_len(),
                    device=self.device)

    def _option_kwargs(self):
        return dict(penalty_factor=self.penalty_factor,
                    lower_limits=self.lower_limits,
                    upper_limits=self.upper_limits)

    @profile.spanned("pack")
    def _fit_result(self, res) -> ADMMLassoFit:
        return ADMMLassoFit(res.lambdas.detach().cpu().numpy(),
                            _sparse_beta(res.beta0, res.coef),
                            res.niter.detach().cpu().numpy(),
                            trace=res.trace)

    def _consensus_kwargs(self):
        """The consensus drivers' arguments: no path mode, and glmnet's
        per-coordinate options are refused."""
        if any(v is not None for v in self._option_kwargs().values()):
            raise NotImplementedError(
                "penalty_factor / coefficient limits are not "
                "supported by the consensus solver; use nthread=1")
        kw = self._path_kwargs()
        del kw["path_mode"]
        return dict(kw, nworkers=self.nthread)

    @profile.spanned("fit")
    def fit(self) -> ADMMLassoFit:
        """(reference: R/30_admm_lasso.R:136-160, which dispatches the
        serial or the consensus solver on nthread)"""
        if self.nthread > 1:
            return self._fit_result(parallel_lasso_path(
                self.x, self.y, **self._consensus_kwargs()))
        return self._fit_result(lasso_path(self.x, self.y,
                                           **self._option_kwargs(),
                                           **self._path_kwargs()))

    def __repr__(self):
        n, p = self.x.shape
        return (f"{type(self).__name__}(x=<{n} x {p}>, "
                f"nlambda={self.nlambda}, nthread={self.nthread}, "
                f"maxit={self.maxit}, eps_abs={self.eps_abs}, "
                f"eps_rel={self.eps_rel}, rho={self.rho})")


class ADMMEnet(ADMMLasso):
    """Elastic-Net builder (reference: R/40_admm_enet.R:2-23).

    minimize 1/(2n)||y - X b||^2 + lambda(alpha||b||_1 + (1-alpha)/2||b||_2^2)
    """

    def __init__(self, x, y, intercept: bool = True,
                 standardize: bool = True, device="cuda"):
        super().__init__(x, y, intercept, standardize, device)
        self.alpha = 1.0

    def penalty(self, lambda_=None, nlambda: int = 100,
                lambda_min_ratio: Optional[float] = None,
                alpha: float = 1.0, penalty_factor=None,
                lower_limits=None, upper_limits=None, **kw):
        """(reference: R/40_admm_enet.R:35-47)"""
        if not (0.0 <= alpha <= 1.0):
            raise ValueError("alpha must be within [0,1]")
        super().penalty(lambda_, nlambda, lambda_min_ratio,
                        penalty_factor=penalty_factor,
                        lower_limits=lower_limits,
                        upper_limits=upper_limits)
        self.alpha = float(alpha)
        return self

    @profile.spanned("fit")
    def fit(self) -> ADMMLassoFit:
        """``parallel()`` works here too, an extension (the reference has
        no ``admm_parenet``): the Lasso's consensus with the Enet prox."""
        if self.nthread > 1:
            return self._fit_result(parallel_enet_path(
                self.x, self.y, alpha=self.alpha,
                **self._consensus_kwargs()))
        return self._fit_result(enet_path(self.x, self.y, alpha=self.alpha,
                                          **self._option_kwargs(),
                                          **self._path_kwargs()))


class ADMMDantzig(ADMMLasso):
    """Dantzig-selector builder (reference: R/50_admm_dantzig.R:2, which
    extends ADMM_Lasso unchanged)."""

    def parallel(self, nthread: int = 2, **kw):
        raise NotImplementedError(
            "parallel computing is not supported for the Dantzig selector")

    def opts(self, maxit: int = 10000, eps_abs: Optional[float] = None,
             eps_rel: Optional[float] = None, rho: Optional[float] = None,
             path_mode: str = "batch", trace=False, **kw):
        if path_mode == "activeset":
            # The gathered-column active set exists only for the wide
            # Lasso/Enet x-update.
            raise ValueError(
                "path_mode='activeset' is not available for the "
                "Dantzig selector; use 'batch' or 'scan'")
        return super().opts(maxit, eps_abs, eps_rel, rho, path_mode, trace)

    @profile.spanned("fit")
    def fit(self) -> ADMMLassoFit:
        if any(v is not None for v in self._option_kwargs().values()):
            raise NotImplementedError(
                "penalty_factor / coefficient limits are not supported "
                "for the Dantzig selector")
        return self._fit_result(dantzig_path(self.x, self.y,
                                             **self._path_kwargs()))


class ADMMBP:
    """Basis-Pursuit builder (reference: R/10_admm_bp.R:2-41).

    minimize ||beta||_1  s.t.  X beta = y;  requires p > n.
    """

    def __init__(self, x, y, device="cuda", dtype=None):
        self.x, self.y = _check_xy(x, y)
        n, p = self.x.shape
        if p <= n:
            raise ValueError("ncol(x) must be greater than nrow(x)")
        self._init_opts(device, dtype)

    def _init_opts(self, device, dtype):
        self.device = device
        self.dtype = dtype
        self.nthread = 1
        self.maxit = 10000
        self._eps_abs = None
        self._eps_rel = None
        # None = the solver's own default (5.0; see models/lad.py);
        # .opts(rho=1.0) restores the reference's literal default.
        self.rho = None
        self.trace = False

    def _eps_default(self) -> float:
        """The reference's 1e-4 is a float64 tolerance (reference:
        src/LAD.cpp:16, src/BP.cpp:20); float32, which ``dtype=None``
        means, tightens it to 2e-5 (models/lad.py)."""
        return 1e-4 if self.dtype == torch.float64 else 2e-5

    # Resolved at access time, so the default follows ``dtype`` at fit.
    @property
    def eps_abs(self) -> float:
        return self._eps_default() if self._eps_abs is None else self._eps_abs

    @eps_abs.setter
    def eps_abs(self, v):
        self._eps_abs = None if v is None else float(v)

    @property
    def eps_rel(self) -> float:
        return self._eps_default() if self._eps_rel is None else self._eps_rel

    @eps_rel.setter
    def eps_rel(self, v):
        self._eps_rel = None if v is None else float(v)

    def parallel(self, nthread: int = 2, **kw):
        """(reference: R/10_admm_bp.R:66-75).  The reference dispatches
        ``nthread > 1`` to ``admm_parbp``, whose native side was never
        compiled; here it is the consensus Basis Pursuit
        (:func:`admm_tpu_torch.parallel.consensus.parallel_bp_fit`)."""
        self.nthread = max(int(nthread), 1)
        return self

    def opts(self, maxit: int = 10000, eps_abs: Optional[float] = None,
             eps_rel: Optional[float] = None,
             rho: Optional[float] = None, trace=False, **kw):
        """(reference: R/10_admm_bp.R:80-97).  eps defaults follow the
        precision and are resolved at fit time; ``rho=None`` keeps the
        solver's default.  ``trace`` as in :meth:`ADMMLasso.opts`."""
        if maxit <= 0:
            raise ValueError("maxit should be positive")
        if eps_abs is not None and eps_abs < 0:
            raise ValueError("eps_abs and eps_rel should be nonnegative")
        if eps_rel is not None and eps_rel < 0:
            raise ValueError("eps_abs and eps_rel should be nonnegative")
        if rho is not None and rho <= 0:
            raise ValueError("rho should be positive")
        if trace is not False and trace is not True and int(trace) <= 0:
            raise ValueError("trace must be a bool or a positive int")
        self.maxit = int(maxit)
        self.eps_abs = eps_abs
        self.eps_rel = eps_rel
        self.rho = None if rho is None else float(rho)
        self.trace = trace
        return self

    _trace_len = ADMMLasso._trace_len

    def _fit_kwargs(self):
        return dict(maxit=self.maxit, eps_abs=self.eps_abs,
                    eps_rel=self.eps_rel, rho=self.rho, dtype=self.dtype,
                    trace_len=self._trace_len(), device=self.device)

    @profile.spanned("fit")
    def fit(self) -> ADMMBPFit:
        """(reference: R/10_admm_bp.R:100-120, which dispatches the serial
        or the consensus solver on nthread)"""
        if self.nthread > 1:
            res = parallel_bp_fit(self.x, self.y, nworkers=self.nthread,
                                  **self._fit_kwargs())
        else:
            res = bp_fit(self.x, self.y, **self._fit_kwargs())
        return ADMMBPFit(_to_numpy(res.coef), res.niter, trace=res.trace)

    def __repr__(self):
        n, p = self.x.shape
        return (f"{type(self).__name__}(x=<{n} x {p}>, maxit={self.maxit}, "
                f"eps_abs={self.eps_abs}, eps_rel={self.eps_rel}, "
                f"rho={self.rho})")


class ADMMLAD(ADMMBP):
    """LAD (median regression) builder (reference: R/20_admm_lad.R:2-31).

    minimize ||y - X beta||_1;  requires n > p.
    """

    def __init__(self, x, y, intercept: bool = True, device="cuda",
                 dtype=None):
        self.x, self.y = _check_xy(x, y)
        n, p = self.x.shape
        if n <= p:
            raise ValueError("nrow(x) must be greater than ncol(x)")
        self.intercept = bool(intercept)
        self._init_opts(device, dtype)

    def parallel(self, nthread: int = 2, **kw):
        raise NotImplementedError(
            "parallel computing is not supported for LAD (the reference "
            "accepts nthread but silently runs serial; failing loudly "
            "is kinder)")

    @profile.spanned("fit")
    def fit(self) -> ADMMLADFit:
        res = lad_fit(self.x, self.y, intercept=self.intercept,
                      **self._fit_kwargs())
        beta = np.concatenate([np.atleast_1d(_to_numpy(res.beta0)),
                               _to_numpy(res.coef)])
        return ADMMLADFit(beta, res.niter, self.x, self.y, trace=res.trace)


# -- the reference's five exported constructors --------------------------

def admm_lasso(x, y, intercept: bool = True, standardize: bool = True,
               device="cuda") -> ADMMLasso:
    """Fit a Lasso model by ADMM (reference: R/30_admm_lasso.R:377-380)."""
    return ADMMLasso(x, y, intercept, standardize, device)


def admm_enet(x, y, intercept: bool = True, standardize: bool = True,
              device="cuda") -> ADMMEnet:
    """Fit an Elastic-Net model by ADMM (reference: R/40_admm_enet.R)."""
    return ADMMEnet(x, y, intercept, standardize, device)


def admm_lad(x, y, intercept: bool = True, device="cuda",
             dtype=None) -> ADMMLAD:
    """Fit a LAD (median) regression by ADMM (reference: R/20_admm_lad.R)."""
    return ADMMLAD(x, y, intercept, device, dtype)


def admm_bp(x, y, device="cuda", dtype=None) -> ADMMBP:
    """Solve Basis Pursuit by ADMM (reference: R/10_admm_bp.R)."""
    return ADMMBP(x, y, device, dtype)


def admm_dantzig(x, y, intercept: bool = True, standardize: bool = True,
                 device="cuda") -> ADMMDantzig:
    """Fit a Dantzig selector by ADMM (reference: R/50_admm_dantzig.R)."""
    return ADMMDantzig(x, y, intercept, standardize, device)
