"""The port's sparse multinomial path
(``admm_tpu_torch.models.multinomial``), its CV driver and its
``predict``/``assess``/``confusion`` branches against the JAX package's,
on the same seeded numpy inputs and ``device="cpu"``.

Each lane's (q, C) block travels flattened through the engine, so its
residual norms are Frobenius as in the JAX package's vmapped engine:
``niter`` is held within 1 per lambda in float64.  Bars: float64
coefficients and intercepts within 1e-6 (plus rtol 1e-7); float32 within
2e-4, niter in float64 only.  CV: cvm rtol 1e-4 and ``lambda_min`` as a
grid index.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu_torch.interop import from_reference, to_reference

from _torch_parity import assert_cv_close, assert_path_close

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "f64": (jnp.float64, torch.float64, 1e-6)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, p, C = 90, 8, 3
    X = rng.normal(size=(n, p))
    B = np.zeros((p, C))
    B[:3] = rng.normal(size=(3, C)) * 1.5
    eta = X @ B
    P = np.exp(eta - eta.max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    y = np.array([rng.choice(C, p=pr) for pr in P])
    return X, y


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("mode", ["batch", "scan"])
def test_multinomial_path_matches_jax(data, mode, grouped, dt):
    X, y = data
    jdt, tdt, atol = DTYPES[dt]
    kw = dict(nlambda=5, path_mode=mode, grouped=grouped)
    ref = admm_tpu.multinomial_lasso_path(X, y, dtype=jdt, **kw)
    got = admm_tpu_torch.multinomial_lasso_path(X, y, dtype=tdt,
                                                device="cpu", **kw)
    assert got.coef.shape == (5, X.shape[1], 3) and got.coef.dtype == tdt
    assert_path_close(got, ref, atol, niter=dt == "f64")


CASES = {
    "alpha": dict(alpha=0.5),
    "weights": "weights",
    "penalty_factor": dict(penalty_factor=np.r_[0.0, np.ones(7)]),
    "exclude": dict(exclude=[2, 5]),
    "offset": "offset",
    "offset_no_intercept": "offset_ni",
    "no_intercept": dict(intercept=False),
    "no_standardize": dict(standardize=False),
    "newton_steps": dict(newton_steps=1, rho=0.3),
    "nclass": dict(nclass=4),
    "user_grid": dict(lambdas=[0.1, 0.01, 0.03]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multinomial_options_match_jax(data, case):
    X, y = data
    kw = CASES[case]
    rng = np.random.default_rng(6)
    if kw == "weights":
        kw = dict(weights=rng.uniform(0.5, 2.0, X.shape[0]))
    elif kw in ("offset", "offset_ni"):
        kw = dict(offset=0.4 * rng.normal(size=(X.shape[0], 3)),
                  intercept=kw == "offset")
    kw = dict(dict(nlambda=4), **kw)
    ref = admm_tpu.multinomial_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.multinomial_lasso_path(X, y, dtype=torch.float64,
                                                device="cpu", **kw)
    assert_path_close(got, ref, 1e-6)


def test_multinomial_trace_matches_jax(data):
    X, y = data
    kw = dict(nlambda=3, trace_len=20)
    ref = admm_tpu.multinomial_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.multinomial_lasso_path(X, y, dtype=torch.float64,
                                                device="cpu", **kw)
    assert got.trace.shape == (3, 20, 5)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-7, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("case", ["one_class", "alpha", "path_mode",
                                  "offset_shape", "penalty_factor"])
def test_multinomial_refusals_like_jax(data, case):
    """The JAX package's ValueErrors (tests/test_multinomial.py:81-83),
    with the same messages."""
    X, y = data
    kw = {"one_class": dict(y=np.zeros(X.shape[0], int)),
          "alpha": dict(alpha=1.5), "path_mode": dict(path_mode="lanes"),
          "offset_shape": dict(offset=np.zeros((X.shape[0], 2))),
          "penalty_factor": dict(penalty_factor=-np.ones(X.shape[1]))}[case]
    yy = kw.pop("y", y)
    with pytest.raises(ValueError) as ref:
        admm_tpu.multinomial_lasso_path(X, yy, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.multinomial_lasso_path(X, yy, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["deviance", "class", "mse", "mae",
                                  "loop", "options"])
def test_cv_multinomial_path_matches_jax(data, case):
    X, y = data
    kw = dict(foldid=np.arange(X.shape[0]) % 3, nlambda=4,
              dtype=jnp.float64)
    if case in ("class", "mse", "mae"):
        kw["type_measure"] = case
    elif case == "loop":
        kw["cv_mode"] = "loop"
    elif case == "options":
        rng = np.random.default_rng(8)
        kw.update(weights=rng.uniform(0.5, 2.0, X.shape[0]),
                  offset=0.3 * rng.normal(size=(X.shape[0], 3)),
                  grouped=True, exclude=[1], keep=True)
    ref = admm_tpu.cv_multinomial_path(X, y, **kw)
    got = admm_tpu_torch.cv_multinomial_path(X, y, device="cpu",
                                             **dict(kw, dtype=torch.float64))
    assert_cv_close(got, ref)
    assert_path_close(got.fit, ref.fit, 1e-6)
    if case == "options":
        np.testing.assert_allclose(got.fit_preval, ref.fit_preval,
                                   atol=1e-6)


def test_cv_multinomial_refusals(data):
    X, y = data
    for kw in (dict(type_measure="auc"), dict(cv_mode="folds")):
        with pytest.raises(ValueError) as ref:
            admm_tpu.cv_multinomial_path(X, y, **kw)
        with pytest.raises(ValueError) as got:
            admm_tpu_torch.cv_multinomial_path(X, y, device="cpu", **kw)
        assert str(got.value) == str(ref.value)
    # fold_mesh: the CV on a 2-position CPU mesh is the CV without one.
    got = admm_tpu_torch.cv_multinomial_path(
        X, y, fold_mesh=torch_mesh(2, devices=["cpu"] * 2), device="cpu")
    ref = admm_tpu_torch.cv_multinomial_path(X, y, device="cpu")
    np.testing.assert_array_equal(got.cvm, ref.cvm)


def test_predict_assess_confusion_multinomial_like_jax(data):
    """Linear predictors, softmax probabilities and argmax classes (with a
    per-class offset), coefficients and nonzero rows; ``assess``'s
    multinomial deviance, class error and simplex mse/mae; the (C, C)
    confusion table; a CV result at its default ``lambda.1se``."""
    X, y = data
    ref = admm_tpu.multinomial_lasso_path(X, y, nlambda=4, dtype=jnp.float64)
    got = admm_tpu_torch.multinomial_lasso_path(X, y, nlambda=4,
                                                dtype=torch.float64,
                                                device="cpu")
    Xn = X[:7]
    off = np.random.default_rng(9).normal(size=(7, 3))
    for lam in (None, 0.02):
        for typ in ("link", "response", "class", "coefficients"):
            a = admm_tpu_torch.predict(got, Xn, lam=lam, type=typ)
            b = admm_tpu.predict(ref, Xn, lam=lam, type=typ)
            if typ == "class":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_allclose(
            admm_tpu_torch.predict(got, Xn, lam=lam, offset=off),
            admm_tpu.predict(ref, Xn, lam=lam, offset=off), atol=1e-6)
    for a, b in zip(admm_tpu_torch.predict(got, None, type="nonzero"),
                    admm_tpu.predict(ref, None, type="nonzero")):
        np.testing.assert_array_equal(a, b)
    for kw in (dict(), dict(lam=0.02),
               dict(weights=np.arange(X.shape[0]) % 2 + 1.0)):
        a = admm_tpu_torch.assess(got, X, y, **kw)
        b = admm_tpu.assess(ref, X, y, **kw)
        assert set(a) == set(b) == {"deviance", "class", "mse", "mae"}
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-9)
    for lam in (None, 0.02):
        np.testing.assert_array_equal(
            admm_tpu_torch.confusion(got, X, y, lam=lam),
            admm_tpu.confusion(ref, X, y, lam=lam))
    kw = dict(foldid=np.arange(X.shape[0]) % 3, nlambda=4)
    cv_ref = admm_tpu.cv_multinomial_path(X, y, dtype=jnp.float64, **kw)
    cv_got = admm_tpu_torch.cv_multinomial_path(X, y, dtype=torch.float64,
                                                device="cpu", **kw)
    for sel in (None, "lambda.min"):
        np.testing.assert_array_equal(
            admm_tpu_torch.predict(cv_got, Xn, lam=sel, type="class"),
            admm_tpu.predict(cv_ref, Xn, lam=sel, type="class"))


def test_multinomial_result_round_trip(data):
    X, y = data
    ref = admm_tpu.multinomial_lasso_path(X, y, nlambda=2,
                                          dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, admm_tpu_torch.MNPathResult)
    back = to_reference(port, type(ref))
    for a, b in zip(back, ref):
        if b is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
