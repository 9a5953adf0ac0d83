"""``admm_tpu_torch.admm_lad(X, y, intercept=False).fit()``: the
reference's R-style LAD (median regression) constructor, with the
configuration's solver settings stated through ``.opts()`` (the values of
the port's float32 defaults), returning the dense ``beta`` (its intercept
row, 0, first).

The check holds it to the plain reference (``reference/lad.py``, float64,
a hundredth of the program's tolerance, no intercept) on the user's
scale: the L1 objective, relative, and the coefficients, absolute.
``niter`` is not compared: LAD is path-dependent."""
from __future__ import annotations

import math

import numpy as np

from port_bench import checks
from port_bench.reference import lad as ref_lad
from port_bench.roofline.lad_solve import iteration_flops


def arguments(cfg: dict, mix: dict) -> dict:
    """The configuration's solver settings, stated to the program (the
    reference takes rho; its tolerance is its own)."""
    if cfg["intercept"]:
        raise ValueError("the LAD reference fits no intercept")
    return {"rho": cfg["rho"], "eps_abs": cfg["eps_abs"],
            "eps_rel": cfg["eps_rel"], "maxit": cfg["maxit"],
            **mix.get("kwargs", {})}


def call(port, prob, device, rho, eps_abs, eps_rel, maxit) -> dict:
    fit = (port.admm_lad(prob["X"], prob["y"], intercept=False,
                         device=device)
           .opts(maxit=maxit, eps_abs=eps_abs, eps_rel=eps_rel, rho=rho)
           .fit())
    beta = np.asarray(fit.beta)
    return {"beta0": float(beta[0]), "coef": beta[1:], "niter": int(fit.niter)}


def reference(prob, precision, device, rho, **_) -> dict:
    out = ref_lad.lad_fit(prob["X"], prob["y"], precision=precision,
                          device=device, rho=rho)
    out.update(beta0=0.0, X=prob["X"], y=prob["y"])
    return out


def compare(out: dict, ref: dict) -> dict:
    """``objective_gap``: the program's ||y - Xb||_1 over the reference's,
    less 1; ``coef_gap``: the largest absolute gap of the intercept (0 in
    the reference) and the coefficients.  inf where the program's answer
    is not finite."""
    beta = np.r_[out["beta0"], out["coef"]]
    beta_ref = np.r_[ref["beta0"], ref["coef"]]
    best = ref_lad.objective(ref["X"], ref["y"], ref["coef"])
    got = ref_lad.objective(ref["X"], ref["y"] - out["beta0"], out["coef"])
    gap = (got - best) / best
    return {"objective_gap": gap if math.isfinite(gap) else math.inf,
            "coef_gap": checks.abs_gap(beta, beta_ref)}


def iterations(out: dict) -> int:
    return int(out["niter"])


def flops(out: dict, cfg: dict, kw: dict, kernel_ops: float) -> float:
    """The problem's work: the Gram matrix (2np^2), its Cholesky factor
    and inverse (p^3), every iteration the result reports at 2 min(n^2,
    2np + p^2), and the recovery (X'v and the inverse: 2np + 2p^2).  The
    hat matrix's product is a route's cost, not the problem's."""
    n, p = cfg["n"], cfg["p"]
    return (2.0 * n * p * p + p ** 3 + iterations(out) * iteration_flops(n, p)
            + 2.0 * n * p + 2.0 * p * p)
