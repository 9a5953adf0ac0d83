"""The port's (sparse-)group Lasso (``admm_tpu_torch.models.grouplasso``)
and its CV driver against the JAX package's, on the same seeded numpy
inputs and ``device="cpu"``.

Bars: coefficients within 1e-5 (plus rtol 1e-5) in float32 and 1e-9 in
float64, ``niter`` within 1 per lambda, at an explicit rho; the wide
regime's step is 1/sprad whatever rho is, so power iteration starts from
the JAX package's vector there.  The wide regime in float32 keeps the
port's wide bar, 2e-4 (``tests/test_torch_cv.py``): its adaptive-rho
ladder turns last-bit differences of the products into gaps of up to
1.4e-4 here and moves the stopping iteration (by 20 at one lambda), which
float64 shows to be rounding (coefficients 1e-9, niter within 1); so, as
in ``tests/test_torch_lasso.py``, wide float32 niter is not compared.
CV: cvm rtol 1e-4 and ``lambda_min`` as a grid index.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models.grouplasso import normalize_groups as jnormalize
from admm_tpu_torch.models.grouplasso import normalize_groups

from _torch_parity import jax_start_vector  # noqa: F401  (a fixture)

torch.set_num_threads(1)

TALL_RHO, WIDE_RHO = 20.0, 1.0
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "f64": (jnp.float64, torch.float64, 1e-9)}


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[:6] = rng.uniform(0.5, 1.5, 6) * rng.choice([-1, 1], 6)
    X = rng.normal(size=(n, p))
    return X, X @ b + 0.3 * rng.normal(size=n), np.arange(p) // 4


@pytest.fixture(scope="module")
def tall():
    return _problem(100, 24, 0)


@pytest.fixture(scope="module")
def wide():
    return _problem(30, 40, 1)


def _check(got, ref, atol, niter=True):
    rtol = 1e-5 if atol >= 1e-5 else 1e-7
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-6)
    gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
    assert gap.max() <= 1 or not niter


CASES = {
    "plain": {},
    "sparse_group": dict(l1_ratio=0.3),
    "lasso_limit": dict(l1_ratio=1.0),
    "group_weights": dict(weights=np.r_[0.0, np.full(5, 2.0)]),
    "obs_weights": "obs",
    "user_grid": dict(lambdas=np.geomspace(0.5, 0.01, 5)),
    "no_standardize": dict(standardize=False, intercept=False),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("regime", ["tall", "wide"])
@pytest.mark.parametrize("case", list(CASES))
def test_group_lasso_path_matches_jax(tall, wide, jax_start_vector, case,
                                      regime, dt):
    X, y, groups = tall if regime == "tall" else wide
    jdt, tdt, atol = DTYPES[dt]
    wide_f32 = regime == "wide" and dt == "f32"
    if wide_f32:
        atol = 2e-4
    kw = CASES[case]
    if kw == "obs":
        kw = dict(obs_weights=np.random.default_rng(5).uniform(
            0.5, 2.0, X.shape[0]))
    if regime == "wide" and "weights" in kw:
        kw = dict(weights=np.r_[0.0, np.full(9, 2.0)])
    kw = dict(kw, nlambda=5, rho=TALL_RHO if regime == "tall" else WIDE_RHO)
    ref = admm_tpu.group_lasso_path(X, y, groups, dtype=jdt, **kw)
    got = admm_tpu_torch.group_lasso_path(X, y, groups, dtype=tdt,
                                          device="cpu", **kw)
    _check(got, ref, atol, niter=not wide_f32)


def test_group_lasso_trace_and_labels(tall):
    """``trace_len`` records one trace per lambda; arbitrary group labels
    are relabelled as the JAX package relabels them."""
    X, y, groups = tall
    res = admm_tpu_torch.group_lasso_path(X, y, groups, nlambda=3,
                                          trace_len=16, device="cpu")
    assert res.trace.shape == (3, 16, 5)
    assert np.isfinite(res.trace.numpy()[:, 0]).all()
    for labels in (groups * 10 + 3, groups[::-1]):
        gj, wj = jnormalize(labels, X.shape[1], None, jnp.float64)
        gt, wt = normalize_groups(labels, X.shape[1], None, torch.float64,
                                  "cpu")
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("case", ["groups_length", "weights_length",
                                  "negative_weight", "l1_ratio"])
def test_group_validation_like_jax(tall, case):
    """The JAX package's ValueErrors (tests/test_grouplasso.py:113), with
    the same messages."""
    X, y, groups = tall
    kw = {"groups_length": dict(groups=groups[:-1]),
          "weights_length": dict(weights=np.ones(3)),
          "negative_weight": dict(weights=np.r_[-1.0, np.ones(5)]),
          "l1_ratio": dict(l1_ratio=1.5)}[case]
    kw = dict(dict(groups=groups), **kw)
    g = kw.pop("groups")
    with pytest.raises(ValueError) as ref:
        admm_tpu.group_lasso_path(X, y, g, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.group_lasso_path(X, y, g, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["onepass", "loop", "obs_weights"])
def test_cv_group_lasso_path_matches_jax(tall, case):
    X, y, groups = tall
    foldid = np.arange(X.shape[0]) % 4
    kw = dict(foldid=foldid, nlambda=5, rho=TALL_RHO, l1_ratio=0.2,
              cv_mode="loop" if case == "loop" else "onepass")
    if case == "obs_weights":
        kw["obs_weights"] = np.random.default_rng(2).uniform(0.5, 2.0,
                                                             X.shape[0])
    ref = admm_tpu.cv_group_lasso_path(X, y, groups, **kw)
    got = admm_tpu_torch.cv_group_lasso_path(X, y, groups, device="cpu",
                                             **kw)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-4)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-4)
    for key in ("lambda_min", "lambda_1se"):
        assert (int(np.argmin(np.abs(got.lambdas - getattr(got, key))))
                == int(np.argmin(np.abs(np.asarray(ref.lambdas)
                                        - getattr(ref, key)))))
    _check(got.fit, ref.fit, 1e-5)
    # A CV result predicts through its full fit (predict._resolve_cv).
    eta = admm_tpu_torch.predict(got, X[:5], lam="lambda.min")
    i = int(np.argmin(np.abs(got.lambdas - got.lambda_min)))
    np.testing.assert_allclose(
        eta, got.fit.beta0.numpy()[i] + X[:5] @ got.fit.coef.numpy()[i],
        rtol=1e-6)
