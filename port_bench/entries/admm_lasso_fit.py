"""``admm_tpu_torch.admm_lasso(X, y).fit()``: the reference's R-style
constructor in batch mode (every lambda at once from a cold start), with
the configuration's grid stated through ``.penalty()`` (the values of its
defaults), returning the packed sparse (p+1) x nlambda ``beta``."""
from __future__ import annotations

import numpy as np

from port_bench import checks, peaks
from port_bench.reference import lasso as ref_lasso


def arguments(cfg: dict, mix: dict) -> dict:
    """The configuration's grid, stated to both sides."""
    return {"nlambda": cfg["nlambda"],
            "lambda_min_ratio": cfg["lambda_min_ratio"],
            **mix.get("kwargs", {})}


def call(port, prob, device, nlambda, lambda_min_ratio) -> dict:
    fit = (port.admm_lasso(prob["X"], prob["y"], device=device)
           .penalty(nlambda=nlambda, lambda_min_ratio=lambda_min_ratio)
           .fit())
    beta = fit.beta.toarray() if hasattr(fit.beta, "toarray") else fit.beta
    beta = np.asarray(beta)
    return {"lambdas": np.asarray(fit.lambda_), "beta0": beta[0],
            "coef": beta[1:].T, "niter": np.asarray(fit.niter)}


def reference(prob, precision, device, **kw) -> dict:
    return ref_lasso.lasso_path(prob["X"], prob["y"], precision=precision,
                                device=device, path_mode="batch", **kw)


def compare(out: dict, ref: dict) -> dict:
    return checks.path_numbers(out, ref)


def iterations(out: dict) -> int:
    return int(np.sum(out["niter"]))


def flops(out: dict, cfg: dict, kw: dict, kernel_ops: float) -> float:
    """The set-up and every lane-iteration the result reports."""
    n, p = cfg["n"], cfg["p"]
    return (peaks.path_setup_flops(n, p)
            + iterations(out) * peaks.path_iteration_flops(n, p))
