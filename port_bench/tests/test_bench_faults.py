"""A run whose timed path is broken underneath comes out not correct.

Each case drives a tiny cell through :func:`port_bench.run.run_cell` on
the CPU (the card's look is the only step skipped), with the port's
solve broken where it produces its answer; the same run unbroken is
correct.  The faults a one-chip Lasso cell can have: a solve that
returns its starting state; half of the lambdas (CV: half of the scored
rows) left out, the rest standing in for them; one coefficient altered.
"""
import pytest
import torch

from admm_tpu_torch.kernels import tall_path, wide_path
from admm_tpu_torch.models import cv as cv_mod
from admm_tpu_torch.models import lasso as lasso_mod
from port_bench.run import run_cell

CELLS = ["lasso_flagship.path", "lasso_wide.fit", "lasso_wide.path",
         "lasso_flagship.cv"]


def _unchanged(out):
    coef, niter = out
    return torch.zeros_like(coef), torch.zeros_like(niter)


def _half(out):
    coef, niter = out
    k = coef.shape[0] // 2
    coef, niter = coef.clone(), niter.clone()
    coef[k:] = coef[:coef.shape[0] - k]
    niter[k:] = niter[:niter.shape[0] - k]
    return coef, niter


def _altered(out):
    coef, niter = out
    coef = coef.clone()
    coef[-1, 0] += 1e-2
    return coef, niter


def _break_solvers(monkeypatch, fault):
    """Every solve the cells reach: the kernels' plain forms and the
    wide engine's path loop."""
    for mod, name in ((tall_path, "tall_path_scan_reference"),
                      (tall_path, "tall_path_batch_reference"),
                      (wide_path, "wide_path_batch_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _fn=fn, **k: fault(_fn(*a, **k)))
    scan = lasso_mod._scan_path

    def broken_scan(*a, **k):
        st, coefs, niter, traces = scan(*a, **k)
        coefs, niter = fault((coefs, niter))
        return st, coefs, niter, traces
    monkeypatch.setattr(lasso_mod, "_scan_path", broken_scan)


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_run_is_correct(tiny_registry, cell):
    res = run_cell(tiny_registry, cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(tiny_registry, monkeypatch, cell, fault):
    _break_solvers(monkeypatch, fault)
    res = run_cell(tiny_registry, cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert not res["correct"], res["checks"]


def test_half_the_scored_rows(tiny_registry, monkeypatch):
    """CV: the curve's mean over half of the held-out rows."""
    score = cv_mod._score_reduce_dev

    def half(eta, y, ws, n_sc, kind):
        ws = ws.clone()
        ws[: ws.shape[0] // 2] = 0
        return score(eta, y, ws, n_sc, kind)
    monkeypatch.setattr(cv_mod, "_score_reduce_dev", half)
    res = run_cell(tiny_registry, "lasso_flagship.cv", 2 ** 31 + 11, 0.3,
                   False, "cpu")
    assert not res["correct"], res["checks"]
