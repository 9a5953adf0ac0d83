"""``admm_tpu_torch.cv_lasso_path(X, y, nfolds=..., seed=...)``: how lambda
is chosen (cv.glmnet's defaults), with the folds drawn from the call's
own seed.  Its full fit and every fold are batch paths."""
from __future__ import annotations

import numpy as np

from port_bench import checks, peaks
from port_bench.reference import lasso as ref_lasso


def arguments(cfg: dict, mix: dict) -> dict:
    """The configuration's grid, stated to both sides, and the mix's
    number of folds."""
    return {"nlambda": cfg["nlambda"],
            "lambda_min_ratio": cfg["lambda_min_ratio"],
            **mix.get("kwargs", {})}


def call(port, prob, device, **kw) -> dict:
    cv = port.cv_lasso_path(prob["X"], prob["y"], seed=prob["seed"],
                            device=device, **kw)
    return {"lambdas": np.asarray(cv.lambdas), "cvm": np.asarray(cv.cvm),
            "cvsd": np.asarray(cv.cvsd), "lambda_min": float(cv.lambda_min),
            "fit": {"lambdas": cv.fit.lambdas.cpu().numpy(),
                    "beta0": cv.fit.beta0.cpu().numpy(),
                    "coef": cv.fit.coef.cpu().numpy(),
                    "niter": cv.fit.niter.cpu().numpy()}}


def reference(prob, precision, device, **kw) -> dict:
    return ref_lasso.cv_lasso_path(prob["X"], prob["y"], seed=prob["seed"],
                                   precision=precision, device=device, **kw)


def compare(out: dict, ref: dict) -> dict:
    """The full fit as a path; the CV curve (relative); and what the
    chosen lambda costs by the reference's own curve, relative to its
    minimum (0 at the same grid point)."""
    nums = checks.path_numbers(out["fit"], ref["fit"])
    nums["cvm_gap"] = checks.rel_gap(out["cvm"], ref["cvm"])
    i_out = int(np.argmin(np.abs(ref["lambdas"] - out["lambda_min"])))
    cvm = ref["cvm"]
    nums["lambda_min_excess"] = float((cvm[i_out] - cvm.min()) / cvm.min())
    return nums


def iterations(out: dict) -> int:
    return int(np.sum(out["fit"]["niter"]))


def flops(out: dict, cfg: dict, kw: dict, kernel_ops: float):
    """The full fit's and the folds' set-up, the held-out predictors
    (2 n p per lambda) and the operations of every solve, the full fit's
    and each fold's, as the kernel launches of the call counted them (the
    result reports no fold's iterations).  None where no launch was
    seen."""
    if kernel_ops <= 0:
        return None
    n, p = cfg["n"], cfg["p"]
    return ((kw.get("nfolds", 10) + 1) * peaks.path_setup_flops(n, p)
            + 2.0 * n * p * len(out["lambdas"]) + kernel_ops)
