"""``admm_tpu_torch.lasso_path(X, y)``: glmnet-style path, scan mode.

The tall regime runs the tall scan kernel; the wide one (n < p < 20000)
runs the engine's host loop (``models/lasso.py::_solve_path_wide``).
"""
from __future__ import annotations

import numpy as np

from port_bench import checks, peaks
from port_bench.reference import lasso as ref_lasso


def arguments(cfg: dict, mix: dict) -> dict:
    """The configuration's grid, stated to both sides, and the mix's own
    keyword arguments."""
    return {"nlambda": cfg["nlambda"],
            "lambda_min_ratio": cfg["lambda_min_ratio"],
            **mix.get("kwargs", {})}


def call(port, prob, device, **kw) -> dict:
    res = port.lasso_path(prob["X"], prob["y"], device=device, **kw)
    return {"lambdas": res.lambdas.cpu().numpy(),
            "beta0": res.beta0.cpu().numpy(),
            "coef": res.coef.cpu().numpy(),
            "niter": res.niter.cpu().numpy()}


def reference(prob, precision, device, **kw) -> dict:
    return ref_lasso.lasso_path(prob["X"], prob["y"], precision=precision,
                                device=device, path_mode="scan", **kw)


def compare(out: dict, ref: dict) -> dict:
    return checks.path_numbers(out, ref)


def iterations(out: dict) -> int:
    return int(np.sum(out["niter"]))


def flops(out: dict, cfg: dict, kw: dict, kernel_ops: float) -> float:
    """The set-up and every iteration the result reports (kernel or
    engine alike, so ``kernel_ops`` is not needed)."""
    n, p = cfg["n"], cfg["p"]
    return (peaks.path_setup_flops(n, p)
            + iterations(out) * peaks.path_iteration_flops(n, p))
