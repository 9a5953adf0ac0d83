"""The plain reference against the port, on the CPU at a tiny size (the
port's kernels run their plain forms there)."""
import numpy as np
import pytest

import admm_tpu_torch as port
from port_bench.reference import lasso as ref


def _problem(n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[rng.choice(p, 8, replace=False)] = rng.uniform(-1, 1, 8)
    return X, (5 + X @ b + rng.normal(size=n)).astype(np.float32)


def _np(res):
    return {k: getattr(res, k).numpy() for k in
            ("lambdas", "beta0", "coef", "niter")}


@pytest.mark.parametrize("n,p,mode,coef_bar,niter_bar", [
    (300, 40, "scan", 1e-5, 2),        # tall scan kernel's plain form
    (300, 40, "batch", 1e-5, 2),       # tall batch kernel's plain form
    (40, 80, "scan", 5e-4, 10),        # the wide engine
    (40, 80, "batch", 2e-3, 40),       # wide kernel's plain form
])
def test_path_against_the_port(n, p, mode, coef_bar, niter_bar):
    X, y = _problem(n, p)
    got = _np(port.lasso_path(X, y, path_mode=mode, device="cpu"))
    want = ref.lasso_path(X, y, path_mode=mode, device="cpu")
    assert np.allclose(got["lambdas"], want["lambdas"], rtol=1e-5)
    assert np.max(np.abs(got["coef"] - want["coef"])) < coef_bar
    assert np.max(np.abs(got["beta0"] - want["beta0"])) < coef_bar
    assert np.max(np.abs(got["niter"] - want["niter"])) <= niter_bar


def test_cv_against_the_port():
    X, y = _problem(300, 40, seed=1)
    got = port.cv_lasso_path(X, y, nfolds=5, seed=9, device="cpu")
    want = ref.cv_lasso_path(X, y, nfolds=5, seed=9, device="cpu")
    assert np.array_equal(got.foldid, ref.fold_ids(300, 5, 9))
    assert np.allclose(got.cvm, want["cvm"], rtol=1e-4)
    assert np.allclose(got.cvsd, want["cvsd"], rtol=1e-3)
    assert got.lambda_min == pytest.approx(want["lambda_min"], rel=1e-5)


def test_tf32_rounding():
    import torch
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.0000002])
    r = ref._round_tf32(x)
    assert r.tolist() == [1.0, 1.0, 1 + 2 ** -10, -3.0]
