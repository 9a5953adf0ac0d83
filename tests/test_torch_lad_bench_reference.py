"""The LAD fit against the benchmark's plain reference
(``port_bench/reference/lad.py``), on the CPU at 200 x 40.

The reference is held to the exact optimum of the linear programme
(SciPy's HiGHS), and the port to the reference, on the README's
generator (X ~ N(0, 2^2), b ~ U(0, 1), y = Xb + N(0, 1)).  ``niter`` is
never compared: LAD is path-dependent.  A recorded fit opens the set-up
spans that the benchmark's per-layer metrics read.
"""
import functools

import numpy as np
import pytest
import torch
from scipy import sparse
from scipy.optimize import linprog

import admm_tpu_torch as port
from admm_tpu_torch.diag import profile
from port_bench.reference import lad as ref

torch.set_num_threads(1)

N, P = 200, 40


def _problem(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(scale=2.0, size=(N, P))
    y = X @ rng.uniform(size=P) + rng.normal(size=N)
    return X.astype(np.float32), y.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(seed):
    X, y = _problem(seed)
    return ref.lad_fit(X, y, device="cpu")


def _gaps(X, y, coef, want):
    """(objective_gap, coef_gap) as the benchmark's check computes them."""
    best = ref.objective(X, y, want)
    got = ref.objective(X, y, coef)
    return (got - best) / best, float(np.abs(coef - want).max())


def _lp(X, y):
    """min ||y - Xb||_1 as y = Xb + u - v, u, v >= 0, solved exactly."""
    X = np.asarray(X, np.float64)
    n, p = X.shape
    A = sparse.hstack([sparse.csr_matrix(X), sparse.eye(n), -sparse.eye(n)])
    res = linprog(np.r_[np.zeros(p), np.ones(2 * n)], A_eq=A,
                  b_eq=np.asarray(y, np.float64),
                  bounds=[(None, None)] * p + [(0, None)] * (2 * n),
                  method="highs")
    assert res.status == 0, res.message
    return res.x[:p]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_reaches_the_lp_optimum(seed):
    """The reference stops at 2e-7, which leaves its objective within 2e-6
    of the optimum's (relative) and its coefficients within 7e-5 at this
    size; the bars are five and three times those."""
    X, y = _problem(seed)
    got = _reference(seed)
    assert got["converged"]
    obj, gap = _gaps(X, y, got["coef"], _lp(X, y))
    assert -1e-8 < obj < 1e-5
    assert gap < 2e-4


def _lad_fit(X, y, dtype):
    res = port.lad_fit(X, y, intercept=False, device="cpu", dtype=dtype)
    return float(res.beta0), res.coef.numpy()


def _admm_lad(X, y, dtype):
    beta = port.admm_lad(X, y, intercept=False, device="cpu",
                         dtype=dtype).fit().beta
    return float(beta[0]), beta[1:]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fit,dtype", [
    (_lad_fit, torch.float32),      # the LAD kernel's plain form
    (_admm_lad, torch.float32),     # the R-style constructor, the same route
    (_lad_fit, torch.float64),      # the engine, at the reference's eps
], ids=["lad_fit", "admm_lad", "lad_fit_float64_engine"])
def test_port_against_the_reference(fit, dtype, seed):
    """The port stops at eps 2e-5 (float32) or 1e-4 (float64), short of
    the optimum: its objective reads 1-5e-4 above the reference's and its
    coefficients up to 2.5e-3 from them at this size.  The bars, 0.1% and
    5e-3, are the ones the port's LAD parity tests hold."""
    X, y = _problem(seed)
    beta0, coef = fit(X, y, dtype)
    assert beta0 == 0.0
    obj, gap = _gaps(X, y, coef, _reference(seed)["coef"])
    assert -1e-5 < obj < 1e-3
    assert gap < 5e-3


def test_recorded_lad_fit_spans_its_set_up_and_counts_its_iterations():
    X, y = _problem(1)
    with profile.record() as rec:
        res = port.lad_fit(X, y, intercept=False, device="cpu")
    parts = [s.attrs.get("part") for s in rec.spans if s.name == "setup"]
    assert parts == ["gram", None, "hat"]
    solve = [s for s in rec.spans if s.name == "solve"]
    assert [s.attrs for s in solve] == [{"kernel": "lad_solve"}]
    assert rec.total("solve.iterations") == int(res.niter) > 0


def test_recorded_fit_spans_the_set_up_and_one_solve():
    X, y = _problem(0)
    with profile.record() as rec:
        fit = port.admm_lad(X, y, intercept=False, device="cpu").fit()
    byid = {s.id: s for s in rec.spans}
    gram = [s for s in rec.spans if s.attrs.get("part") == "gram"]
    hat = [s for s in rec.spans if s.attrs.get("part") == "hat"]
    solve = [s for s in rec.spans if s.name == "solve"]
    assert len(gram) == len(hat) == len(solve) == 1
    assert gram[0].name == hat[0].name == "setup"
    assert solve[0].attrs == {"kernel": "lad_solve"}
    # Both set-up spans and the solve sit directly under the call's fit;
    # standardization is inside the Gram set-up.
    fit_span = next(s for s in rec.spans if s.name == "fit")
    for s in gram + hat + solve:
        assert s.parent == fit_span.id and s.request == fit_span.request
    std = [s for s in rec.spans
           if s.name == "setup" and not s.attrs]
    assert len(std) == 1 and byid[std[0].parent] is gram[0]
    assert gram[0].t1 <= hat[0].t0 and hat[0].t1 <= solve[0].t0
    assert rec.total("solve.iterations") == fit.niter > 0
