"""The port's generalized / fused Lasso (``admm_tpu_torch.models.genlasso``)
and its CV drivers against the JAX package's, on the same seeded numpy
inputs and ``device="cpu"``.

Bars: coefficients within 1e-5 in float32 and 1e-9 in float64, ``niter``
within 1 per lambda, at an explicit rho.  Float32 runs take a user grid:
the auto grid's top is the least-squares certificate of ``D'v = X'y``,
where the fused solution is nearly flat and the float32 stopping
iteration moves with the last bits of ``(X'X + rho D'D)^-1`` (23 apart at
the top lambda, equal below it); float64 runs take the auto grid, except
with the 2-D TV operator, whose m > p rows make DD' singular: the
jittered certificate is then any of many, and the two packages' grid tops
part by 1e-4 (the same grid below it agrees to 1e-9).  CV:
cvm rtol 1e-4, ``lambda_min`` as a grid index.
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
LAMS = np.geomspace(0.3, 0.003, 5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, p = 100, 15
    X = rng.normal(size=(n, p))
    b = np.r_[np.full(5, 1.0), np.zeros(5), np.full(5, -0.5)]
    return X, X @ b + 0.2 * rng.normal(size=n)


def _check(got, ref, atol):
    rtol = 1e-5 if atol >= 1e-5 else 1e-7
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-6)
    gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
    assert gap.max() <= 1


def test_difference_operators_match_jax():
    for p, order in ((6, 1), (9, 2), (12, 3)):
        np.testing.assert_array_equal(
            admm_tpu_torch.difference_matrix(p, order),
            admm_tpu.difference_matrix(p, order))
    for shape in ((3, 4), (1, 5), (4, 1)):
        np.testing.assert_array_equal(
            admm_tpu_torch.difference_matrix_2d(shape),
            admm_tpu.difference_matrix_2d(shape))


CASES = {
    "fused": dict(order=1),
    "trend": dict(order=2),
    "weights": dict(order=1, weights="obs"),
    "no_intercept": dict(order=1, intercept=False),
    "tv_2d": dict(D=(3, 5)),
}


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("mode", ["batch", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_gen_lasso_path_matches_jax(data, case, mode, dt):
    X, y = data
    kw = dict(CASES[case], path_mode=mode, rho=RHO)
    if kw.get("weights") == "obs":
        kw["weights"] = np.random.default_rng(3).uniform(0.5, 2.0, len(y))
    if dt == "f32" or "D" in kw:
        kw["lambdas"] = LAMS
    else:
        kw["nlambda"] = 5
    jdt, tdt, atol = DTYPES[dt]
    if "D" in kw:
        D = admm_tpu.difference_matrix_2d(kw.pop("D"))
        ref = admm_tpu.gen_lasso_path(X, y, D, dtype=jdt, **kw)
        got = admm_tpu_torch.gen_lasso_path(X, y, D, dtype=tdt,
                                            device="cpu", **kw)
    else:
        ref = admm_tpu.fused_lasso_path(X, y, dtype=jdt, **kw)
        got = admm_tpu_torch.fused_lasso_path(X, y, dtype=tdt,
                                              device="cpu", **kw)
    _check(got, ref, atol)


def test_trace_and_rank_deficient_grid(data):
    """``trace_len`` forces the traced scan; with the stacked [I; D] the
    grid top's DD' is singular and the float64 grid stays finite (the
    factorization's failure falls back on the device)."""
    X, y = data
    D = admm_tpu.difference_matrix(15, 1)
    res = admm_tpu_torch.gen_lasso_path(X, y, D, nlambda=3, trace_len=8,
                                        device="cpu")
    assert res.trace.shape == (3, 8, 5)
    D2 = np.vstack([np.eye(15), D])
    for dt in (torch.float32, torch.float64):
        res = admm_tpu_torch.gen_lasso_path(X, y, D2, nlambda=4, maxit=500,
                                            dtype=dt, device="cpu")
        assert np.isfinite(res.lambdas.numpy()).all()
        assert np.isfinite(res.coef.numpy()).all()


@pytest.mark.parametrize("case", ["D_shape", "path_mode"])
def test_genlasso_validation_like_jax(case):
    """The JAX package's ValueErrors (tests/test_genlasso.py:130)."""
    X, y = np.ones((10, 3)), np.ones(10)
    args, kw = {"D_shape": ((np.ones((2, 5)),), {}),
                "path_mode": ((np.ones((2, 3)),),
                              dict(path_mode="activeset"))}[case]
    with pytest.raises(ValueError) as ref:
        admm_tpu.gen_lasso_path(X, y, *args, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.gen_lasso_path(X, y, *args, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["fused_onepass", "fused_loop",
                                  "gen_weights"])
def test_cv_gen_lasso_matches_jax(data, case):
    X, y = data
    kw = dict(foldid=np.arange(len(y)) % 4, nlambda=5, rho=RHO,
              cv_mode="loop" if case == "fused_loop" else "onepass")
    if case == "gen_weights":
        D = admm_tpu.difference_matrix(15, 2)
        kw["weights"] = np.random.default_rng(4).uniform(0.5, 2.0, len(y))
        ref = admm_tpu.cv_gen_lasso_path(X, y, D, **kw)
        got = admm_tpu_torch.cv_gen_lasso_path(X, y, D, device="cpu", **kw)
    else:
        ref = admm_tpu.cv_fused_lasso_path(X, y, **kw)
        got = admm_tpu_torch.cv_fused_lasso_path(X, y, device="cpu", **kw)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-4)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-4)
    for key in ("lambda_min", "lambda_1se"):
        assert (int(np.argmin(np.abs(got.lambdas - getattr(got, key))))
                == int(np.argmin(np.abs(np.asarray(ref.lambdas)
                                        - getattr(ref, key)))))
    np.testing.assert_allclose(got.fit.coef.numpy(), np.asarray(ref.fit.coef),
                               atol=1e-4)


def test_float32_error_is_the_jax_packages():
    """The float32 path is only as close to the float64 one as the JAX
    package's own float32 path is: on this 1000 x 100 fused problem both
    packages' float32 coefficients sit 9.5e-4 from their float64 ones (at
    the default eps, past the 5e-4 of the Lasso paths), and the port's gap
    is the JAX package's to 5%: the error is the algorithm's in float32,
    not the port's."""
    rng = np.random.default_rng(123)
    n, p = 1000, 100
    b = np.zeros(p)
    b[rng.choice(p, 10, replace=False)] = rng.uniform(-1, 1, 10)
    X = rng.normal(size=(n, p))
    y = 5.0 + X @ b + rng.normal(size=n)
    kw = dict(nlambda=20)
    ref = [np.asarray(admm_tpu.fused_lasso_path(X, y, dtype=d, **kw).coef)
           for d in (jnp.float32, jnp.float64)]
    got = [admm_tpu_torch.fused_lasso_path(X, y, dtype=d, device="cpu",
                                           **kw).coef.numpy()
           for d in (torch.float32, torch.float64)]
    gap_ref = np.abs(ref[0] - ref[1]).max()
    gap_got = np.abs(got[0] - got[1]).max()
    assert abs(gap_got / gap_ref - 1.0) <= 0.05
    np.testing.assert_allclose(got[1], ref[1], atol=2e-4)
