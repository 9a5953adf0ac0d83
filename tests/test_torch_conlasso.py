"""The port's constrained and zero-sum Lasso
(``admm_tpu_torch.models.conlasso``) and their CV drivers against the JAX
package's, on the same seeded numpy inputs and ``device="cpu"``.

Bars: coefficients within 1e-5 in float32 and 1e-9 in float64, ``niter``
within 1 per lambda, at an explicit rho; the constraint ``C b = d`` holds
to solver tolerance.  Float32 runs take a user grid (on the auto grid the
weighted case's float32 stopping iteration moves by 5 at one lambda with
the last bits of the grid, a coefficient gap of 7e-6); float64 runs the
auto grid.  CV: cvm rtol 1e-4, ``lambda_min`` as a grid index, the full
fit (auto grid, float32) within 1e-5 plus rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch

torch.set_num_threads(1)

RHO = 5.0
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "f64": (jnp.float64, torch.float64, 1e-9)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, p = 120, 12
    X = rng.normal(size=(n, p))
    b = np.r_[1.0, -1.0, 0.5, -0.5, np.zeros(p - 4)]
    return X, X @ b + 0.2 * rng.normal(size=n)


CASES = {
    "zerosum": {},
    "general": dict(C=np.vstack([np.ones(12), np.r_[1.0, -1.0, np.zeros(10)]]),
                    d=np.array([0.5, 0.0])),
    "weights": dict(weights="obs"),
    "no_intercept": dict(intercept=False),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["batch", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_constrained_lasso_path_matches_jax(data, case, mode, dt):
    X, y = data
    jdt, tdt, atol = DTYPES[dt]
    kw = dict(CASES[case], path_mode=mode, rho=RHO)
    if dt == "f32":
        kw["lambdas"] = np.geomspace(0.5, 0.005, 5)
    else:
        kw["nlambda"] = 5
    if kw.get("weights") == "obs":
        kw["weights"] = np.random.default_rng(3).uniform(0.5, 2.0, len(y))
    C = kw.pop("C", np.ones((1, X.shape[1])))
    d = kw.pop("d", None)
    ref = admm_tpu.constrained_lasso_path(X, y, C, d, dtype=jdt, **kw)
    got = admm_tpu_torch.constrained_lasso_path(X, y, C, d, dtype=tdt,
                                                device="cpu", **kw)
    rtol = 1e-5 if dt == "f32" else 1e-7
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-6)
    gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
    assert gap.max() <= 1
    dd = np.zeros(C.shape[0]) if d is None else d
    assert np.abs(got.coef.numpy() @ C.T - dd).max() < 1e-3
    if case == "zerosum":
        zs = admm_tpu_torch.zerosum_lasso_path(X, y, dtype=tdt, device="cpu",
                                               **kw)
        np.testing.assert_array_equal(zs.coef.numpy(), got.coef.numpy())


def test_trace_len_forces_the_traced_scan(data):
    X, y = data
    res = admm_tpu_torch.zerosum_lasso_path(X, y, nlambda=3, trace_len=8,
                                            device="cpu")
    assert res.trace.shape == (3, 8, 5)
    assert np.isfinite(res.trace.numpy()[:, 0]).all()


@pytest.mark.parametrize("case", ["C_columns", "too_many_rows", "d_length",
                                  "path_mode"])
def test_conlasso_validation_like_jax(case):
    """The JAX package's ValueErrors (tests/test_conlasso.py:133)."""
    rng = np.random.default_rng(1)
    X, y = rng.normal(size=(40, 6)), rng.normal(size=40)
    args, kw = {"C_columns": ((np.ones((1, 5)),), {}),
                "too_many_rows": ((np.eye(6),), {}),
                "d_length": ((np.ones((1, 6)),), dict(d=np.ones(2))),
                "path_mode": ((np.ones((1, 6)),), dict(path_mode="x"))}[case]
    with pytest.raises(ValueError) as ref:
        admm_tpu.constrained_lasso_path(X, y, *args, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.constrained_lasso_path(X, y, *args, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["zerosum_onepass", "zerosum_loop",
                                  "general_weights"])
def test_cv_constrained_lasso_matches_jax(data, case):
    X, y = data
    kw = dict(foldid=np.arange(len(y)) % 4, nlambda=5, rho=RHO,
              cv_mode="loop" if case == "zerosum_loop" else "onepass")
    if case == "general_weights":
        C, d = np.ones((1, X.shape[1])), np.array([1.0])
        kw["weights"] = np.random.default_rng(4).uniform(0.5, 2.0, len(y))
        ref = admm_tpu.cv_constrained_lasso_path(X, y, C, d, **kw)
        got = admm_tpu_torch.cv_constrained_lasso_path(X, y, C, d,
                                                       device="cpu", **kw)
    else:
        ref = admm_tpu.cv_zerosum_lasso_path(X, y, **kw)
        got = admm_tpu_torch.cv_zerosum_lasso_path(X, y, device="cpu", **kw)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-4)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-4)
    for key in ("lambda_min", "lambda_1se"):
        assert (int(np.argmin(np.abs(got.lambdas - getattr(got, key))))
                == int(np.argmin(np.abs(np.asarray(ref.lambdas)
                                        - getattr(ref, key)))))
    np.testing.assert_allclose(got.fit.coef.numpy(), np.asarray(ref.fit.coef),
                               atol=1e-5, rtol=1e-4)
