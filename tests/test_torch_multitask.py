"""The port's multi-task Lasso and nuclear-norm path
(``admm_tpu_torch.models.multitask``), its CV driver, ``svt`` and its
``predict`` branch against the JAX package's, on the same seeded numpy
inputs and ``device="cpu"``.

The JAX package vmaps a single-lane engine whose norms reduce over the
whole (p, K) matrix; the port's engine reduces over the last axis, so
each lane travels flattened (``_flat``) and its norms are Frobenius: the
helper is held against the vmapped ``l2norm``, and ``niter`` against the
JAX package's within 1 per lambda in float64, which a column-wise norm
would miss by far more.

Bars: float64 coefficients within 1e-6 (plus rtol 1e-7) and ``niter``
within 1, at an explicit rho (2 tall, 1 wide) with power iteration
started from the JAX package's vector; float32 within 2e-4 (niter in
float64 only), in the wide regime within the larger of 2e-4 and the JAX
package's own float32 gap to its float64 path.  CV: cvm rtol 1e-4 and
``lambda_min`` as a grid index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu.core.prox import l2norm as jl2norm
from admm_tpu.models.rpca import svt as jsvt
from admm_tpu_torch.core.prox import l2norm
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.models.multitask import _flat, _mat
from admm_tpu_torch.models.rpca import svt

from _torch_parity import (assert_cv_close, assert_path_close,  # noqa: F401
                           jax_start_vector)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "f64": (jnp.float64, torch.float64, 1e-6)}
RHO = {"tall": 2.0, "wide": 1.0}


def _problem(n, p, K, seed):
    rng = np.random.default_rng(seed)
    B = np.zeros((p, K))
    B[:4] = rng.uniform(0.5, 1.5, (4, K)) * rng.choice([-1, 1], (4, K))
    X = rng.normal(size=(n, p))
    return X, 0.3 + X @ B + 0.5 * rng.normal(size=(n, K))


@pytest.fixture(scope="module")
def tall():
    return _problem(60, 10, 3, 0)


@pytest.fixture(scope="module")
def wide():
    return _problem(25, 30, 3, 1)


def test_frobenius_norm_of_flattened_lanes_matches_vmapped_jax():
    """l2norm over a flattened (k, p, K) batch is each lane's Frobenius
    norm: the JAX package's vmapped ``l2norm``."""
    V = np.random.default_rng(3).normal(size=(4, 6, 3))
    got = l2norm(_flat(torch.as_tensor(V)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.vmap(jl2norm)(V)),
                               rtol=1e-14)
    np.testing.assert_array_equal(_mat(_flat(torch.as_tensor(V)), 3).numpy(),
                                  V)


def test_svt_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(7, 4))
    for tau in (0.0, 0.8, 2.5, 50.0):
        np.testing.assert_allclose(svt(torch.as_tensor(A), tau).numpy(),
                                   np.asarray(jsvt(A, tau)), atol=1e-13)
    # A batch of matrices, each with its own threshold, as the vmapped svt.
    As = rng.normal(size=(3, 7, 4))
    taus = np.array([0.1, 1.0, 3.0])
    got = svt(torch.as_tensor(As), torch.as_tensor(taus)[:, None])
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.vmap(jsvt)(As, taus)),
                               atol=1e-13)


@pytest.mark.parametrize("penalty", ["rows", "nuclear"])
@pytest.mark.parametrize("mode", ["batch", "scan"])
@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_multitask_path_matches_jax_f64(tall, wide, jax_start_vector, regime,
                                        mode, penalty):
    X, Y = tall if regime == "tall" else wide
    kw = dict(nlambda=5, path_mode=mode, penalty=penalty, rho=RHO[regime])
    ref = admm_tpu.multitask_lasso_path(X, Y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.multitask_lasso_path(X, Y, dtype=torch.float64,
                                              device="cpu", **kw)
    assert got.coef.shape == (5, X.shape[1], Y.shape[1])
    assert_path_close(got, ref, 1e-6)


@pytest.mark.parametrize("case", ["tall-batch-rows", "tall-scan-nuclear",
                                  "wide-batch-rows", "wide-scan-nuclear"])
def test_multitask_path_matches_jax_f32(tall, wide, jax_start_vector, case):
    regime, mode, penalty = case.split("-")
    X, Y = tall if regime == "tall" else wide
    kw = dict(nlambda=5, path_mode=mode, penalty=penalty, rho=RHO[regime])
    ref = admm_tpu.multitask_lasso_path(X, Y, dtype=jnp.float32, **kw)
    got = admm_tpu_torch.multitask_lasso_path(X, Y, dtype=torch.float32,
                                              device="cpu", **kw)
    if regime == "wide":
        ref64 = admm_tpu.multitask_lasso_path(X, Y, dtype=jnp.float64, **kw)
        own = np.abs(np.asarray(ref.coef) - np.asarray(ref64.coef)).max()
        assert_path_close(got, ref64, max(2e-4, own), niter=False)
        return
    assert_path_close(got, ref, 2e-4, niter=False)


CASES = {
    "auto_rho": {},
    "auto_rho_nuclear_scan": dict(penalty="nuclear", path_mode="scan"),
    "penalty_factor": dict(penalty_factor=np.r_[0.0, np.ones(9)]),
    "exclude": dict(exclude=[1, 4]),
    "alpha": dict(alpha=0.6),
    "standardize_response": dict(standardize_response=True),
    "weights": "weights",
    "offset": "offset",
    "user_grid": dict(lambdas=[0.5, 0.05, 0.2]),
    "no_intercept": dict(intercept=False, standardize=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multitask_options_match_jax(tall, jax_start_vector, case):
    X, Y = tall
    kw = CASES[case]
    rng = np.random.default_rng(6)
    if kw == "weights":
        kw = dict(weights=rng.uniform(0.5, 2.0, X.shape[0]))
    elif kw == "offset":
        kw = dict(offset=0.3 * rng.normal(size=Y.shape))
    kw = dict(dict(nlambda=4), **kw)
    ref = admm_tpu.multitask_lasso_path(X, Y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.multitask_lasso_path(X, Y, dtype=torch.float64,
                                              device="cpu", **kw)
    assert_path_close(got, ref, 1e-6)


def test_multitask_nuclear_path_and_trace_match_jax(tall, jax_start_vector):
    X, Y = tall
    ref = admm_tpu.multitask_nuclear_path(X, Y, nlambda=4, dtype=jnp.float64)
    got = admm_tpu_torch.multitask_nuclear_path(X, Y, nlambda=4,
                                                dtype=torch.float64,
                                                device="cpu")
    assert_path_close(got, ref, 1e-6)
    kw = dict(nlambda=3, trace_len=20, rho=2.0)
    ref = admm_tpu.multitask_lasso_path(X, Y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.multitask_lasso_path(X, Y, dtype=torch.float64,
                                              device="cpu", **kw)
    assert got.trace.shape == (3, 20, 5)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-7, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("case", ["single_response", "nrow", "alpha",
                                  "nuclear_pf", "penalty", "offset_shape",
                                  "path_mode", "exclude_range"])
def test_multitask_refusals_like_jax(tall, case):
    """The JAX package's ValueErrors (tests/test_multitask.py:84-86, :160,
    :214, :255, :339-343), with the same messages."""
    X, Y = tall
    kw = {"single_response": dict(Y=Y[:, 0]), "nrow": dict(Y=Y[:-1]),
          "alpha": dict(alpha=0.0),
          "nuclear_pf": dict(penalty="nuclear", exclude=[0]),
          "penalty": dict(penalty="trace"),
          "offset_shape": dict(offset=np.zeros(X.shape[0])),
          "path_mode": dict(path_mode="lanes"),
          "exclude_range": dict(exclude=[X.shape[1]])}[case]
    YY = kw.pop("Y", Y)
    with pytest.raises(ValueError) as ref:
        admm_tpu.multitask_lasso_path(X, YY, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.multitask_lasso_path(X, YY, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["onepass", "loop", "nuclear", "options"])
def test_cv_multitask_lasso_path_matches_jax(tall, jax_start_vector, case):
    X, Y = tall
    kw = dict(foldid=np.arange(X.shape[0]) % 3, nlambda=4, rho=2.0,
              dtype=jnp.float64)
    if case == "loop":
        kw["cv_mode"] = "loop"
    elif case == "nuclear":
        kw["penalty"] = "nuclear"
    elif case == "options":
        rng = np.random.default_rng(8)
        kw.update(weights=rng.uniform(0.5, 2.0, X.shape[0]),
                  offset=0.2 * rng.normal(size=Y.shape), exclude=[2],
                  keep=True)
    ref = admm_tpu.cv_multitask_lasso_path(X, Y, **kw)
    got = admm_tpu_torch.cv_multitask_lasso_path(
        X, Y, device="cpu", **dict(kw, dtype=torch.float64))
    assert_cv_close(got, ref)
    assert_path_close(got.fit, ref.fit, 1e-6)
    if case == "options":
        np.testing.assert_allclose(got.fit_preval, ref.fit_preval,
                                   atol=1e-6)


def test_cv_multitask_refusals(tall):
    X, Y = tall
    with pytest.raises(ValueError) as ref:
        admm_tpu.cv_multitask_lasso_path(X, Y, cv_mode="folds")
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.cv_multitask_lasso_path(X, Y, cv_mode="folds",
                                               device="cpu")
    assert str(got.value) == str(ref.value)
    # fold_mesh: the CV on a 2-position CPU mesh is the CV without one.
    got = admm_tpu_torch.cv_multitask_lasso_path(
        X, Y, fold_mesh=torch_mesh(2, devices=["cpu"] * 2), device="cpu")
    ref = admm_tpu_torch.cv_multitask_lasso_path(X, Y, device="cpu")
    np.testing.assert_array_equal(got.cvm, ref.cvm)


def test_predict_multitask_like_jax(tall):
    """(L, m, K) linear predictors, on the grid and between its points;
    coefficients with per-task intercepts; nonzero rows; 'link' only."""
    X, Y = tall
    ref = admm_tpu.multitask_lasso_path(X, Y, nlambda=4, dtype=jnp.float64)
    got = admm_tpu_torch.multitask_lasso_path(X, Y, nlambda=4,
                                              dtype=torch.float64,
                                              device="cpu")
    Xn = X[:5]
    for lam in (None, 0.1):
        a = admm_tpu_torch.predict(got, Xn, lam=lam)
        assert a.shape == ((4, 5, 3) if lam is None else (5, 3))
        np.testing.assert_allclose(a, admm_tpu.predict(ref, Xn, lam=lam),
                                   atol=1e-6)
        np.testing.assert_allclose(admm_tpu_torch.coef(got, lam=lam),
                                   admm_tpu.coef(ref, lam=lam), atol=1e-6)
    for a, b in zip(admm_tpu_torch.predict(got, None, type="nonzero"),
                    admm_tpu.predict(ref, None, type="nonzero")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="link"):
        admm_tpu_torch.predict(got, Xn, type="response")


def test_assess_multitask_scores_as_the_cv(tall):
    """``assess`` on a multi-task fit gives per-path-point measures, the
    squared error summed over tasks that ``cv_multitask_lasso_path``
    scores (the JAX package's ``assess`` keeps the task axis and returns
    per-observation arrays: not a measure to pin)."""
    X, Y = tall
    got = admm_tpu_torch.multitask_lasso_path(X, Y, nlambda=4,
                                              dtype=torch.float64,
                                              device="cpu")
    w = np.arange(X.shape[0]) % 3 + 1.0
    eta = admm_tpu_torch.predict(got, X)                    # (L, n, K)
    r = eta - Y[None]
    a = admm_tpu_torch.assess(got, X, Y, weights=w)
    np.testing.assert_allclose(a["mse"], ((r * r).sum(2) * w).sum(1)
                               / w.sum(), rtol=1e-12)
    np.testing.assert_allclose(a["deviance"], a["mse"])
    np.testing.assert_allclose(a["mae"], (np.abs(r).sum(2) * w).sum(1)
                               / w.sum(), rtol=1e-12)
    one = admm_tpu_torch.assess(got, X, Y, lam=float(got.lambdas[2]))
    assert one["mse"] == pytest.approx(float(((r[2] ** 2).sum(1)).mean()))


def test_multitask_result_round_trip(tall):
    X, Y = tall
    ref = admm_tpu.multitask_lasso_path(X, Y, nlambda=2, dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, admm_tpu_torch.MTPathResult)
    back = to_reference(port, type(ref))
    for a, b in zip(back, ref):
        if b is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
