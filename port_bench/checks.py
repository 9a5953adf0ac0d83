"""The numbers that decide ``correct``, and the check that the run loaded
no JAX.

Every number is a gap between what the program returned and what the
plain reference (``reference/``) computes from the same inputs; a run's
number is the largest over the answers it checks, and the run is correct
when each is at or under its limit (``limits/<cell>.json``).
"""
from __future__ import annotations

import sys

import numpy as np

#: Top-level module names that no run may hold once its window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "admm_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``admm_tpu_torch`` is allowed."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def rel_gap(a, r) -> float:
    """max |a - r| / |r| (r nonzero)."""
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    if a.shape != r.shape:
        return float("inf")
    return float(np.max(np.abs(a - r) / np.abs(r)))


def abs_gap(a, r) -> float:
    """max |a - r|; inf where the shapes differ or a value is not finite."""
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    if a.shape != r.shape or not np.all(np.isfinite(a)):
        return float("inf")
    return float(np.max(np.abs(a - r)))


def path_numbers(out: dict, ref: dict) -> dict:
    """A lambda path against the reference's: the grid (relative), the
    coefficients with the intercepts (absolute, the user's scale) and the
    iterations each lambda took."""
    beta = np.column_stack([out["beta0"], out["coef"]])
    beta_ref = np.column_stack([ref["beta0"], ref["coef"]])
    return {"lambda_gap": rel_gap(out["lambdas"], ref["lambdas"]),
            "coef_gap": abs_gap(beta, beta_ref),
            "niter_gap": abs_gap(out["niter"], ref["niter"])}


def worst(numbers: list) -> dict:
    """Each number's largest value over the checked answers."""
    out = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out
