"""The port's penalized quantile regression
(``admm_tpu_torch.models.quantile``), its CV driver and ``pinball_loss``
against the JAX package's, on the same seeded numpy inputs and
``device="cpu"``.

The problem is small (n = 50, p = 5, gaussian noise): the port's host
loop takes 0.2-0.3 ms an iteration here and quantile lanes run to
thousands of iterations.  The solver matrix runs at eps 1e-5, the rest at
eps 1e-4.  Bars: float64 coefficients within 1e-6 (plus rtol 1e-7) and
``niter`` within 1 per (tau, lambda) lane.  Float32 (on a given grid) is
held as LAD is (``chip_smoke.py``, tests/test_pallas_kernels.py): the
pinball objective within 0.1% of the JAX package's float64 path and the
coefficients within 5e-3 of it, or within 1.5 times the JAX package's own
float32 gap where that is larger (7.5e-3 in the batch case here; the
port's is 8.2e-3); niter is not compared (the check loss's flat pieces
make float32 stopping iterations rounding noise: hundreds apart here in
either package).  CV in float64 (the JAX driver's default float32 curves
are check-loss rounding noise at 3e-4): cvm rtol 1e-4 and each tau's
``lambda_min`` as a grid index.  ``predict`` picks a tau lane as the JAX
package does.

A trait of the method both packages share (ROADMAP.md, queue 3): a cold
batch lane can pass the Boyd test far from the optimum at rho 10 on a
small heavy-tailed problem, and which lane does is rounding: at n = 60,
p = 6 with t(3) noise and eps 1e-5 one lane stops at 18 iterations 0.35
from its optimum in the JAX package's 12-lane batch and at 449 alone,
and the port the other way round.  On the JAX package's own test problem
(n = 200, t(3) noise) the two packages agree to 4e-14 in float64, but a
scan takes 40 s here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models.quantile import _quantile_lam0 as j_lam0
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.models.quantile import _quantile_lam0

from _torch_parity import assert_path_close

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "f64": (jnp.float64, torch.float64, 1e-6)}
TAUS = [0.3, 0.7]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, p = 50, 5
    X = rng.normal(size=(n, p))
    return X, 0.5 + X[:, 0] - X[:, 1] + 0.5 * rng.normal(size=n)


def _objective(res, X, y, w=None):
    """(T, L) penalized check-loss objectives of a quantile path on the
    original scale (standardize=False)."""
    taus = np.asarray(res.taus, np.float64)
    coef = np.asarray(res.coef, np.float64)
    eta = np.asarray(res.beta0, np.float64)[..., None] + coef @ X.T
    r = y - eta
    loss = np.where(r > 0, taus[:, None, None] * r,
                    (taus[:, None, None] - 1.0) * r).mean(axis=-1)
    return loss + np.asarray(res.lambdas) * np.abs(coef).sum(axis=-1)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["batch", "scan"])
def test_quantile_lasso_path_matches_jax(data, mode, dt):
    X, y = data
    jdt, tdt, atol = DTYPES[dt]
    kw = dict(tau=TAUS, nlambda=3, path_mode=mode, eps_abs=1e-5,
              eps_rel=1e-5, standardize=False)
    if dt == "f32":
        # The float32 auto grid's top is the weighted tau-quantile's row,
        # which float32 rounding of tau * sum(w) can move by one row (1.5%
        # here, in either package): the solver is held on a given grid.
        kw["lambdas"] = [0.2, 0.05, 0.005]
    ref = admm_tpu.quantile_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.quantile_lasso_path(X, y, dtype=tdt, device="cpu",
                                             **kw)
    assert got.coef.shape == (2, 3, X.shape[1]) and got.coef.dtype == tdt
    np.testing.assert_allclose(got.taus.numpy(), np.asarray(ref.taus),
                               rtol=1e-7)
    if dt == "f64":
        assert_path_close(got, ref, atol)
        return
    ref32 = admm_tpu.quantile_lasso_path(X, y, dtype=jnp.float32, **kw)
    own = np.abs(np.asarray(ref32.coef) - np.asarray(ref.coef)).max()
    assert_path_close(got, ref, max(5e-3, 1.5 * own), niter=False)
    obj, obj_ref = _objective(got, X, y), _objective(ref, X, y)
    assert np.all(obj <= obj_ref * 1.001), np.max(obj / obj_ref)


CASES = {
    "scalar_tau": dict(tau=0.3),
    "weights": "weights",
    "user_grid": dict(tau=[0.2, 0.7], lambdas=[0.01, 0.1, 0.05]),
    "no_intercept": dict(intercept=False, standardize=False),
    "rho": dict(rho=3.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quantile_options_match_jax(data, case):
    X, y = data
    kw = CASES[case]
    if kw == "weights":
        kw = dict(tau=[0.3, 0.6], weights=np.arange(X.shape[0]) % 3 + 0.5)
    kw = dict(dict(nlambda=3, eps_abs=1e-4, eps_rel=1e-4), **kw)
    ref = admm_tpu.quantile_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.quantile_lasso_path(X, y, dtype=torch.float64,
                                             device="cpu", **kw)
    assert_path_close(got, ref, 1e-6)


def test_quantile_trace_matches_jax(data):
    X, y = data
    kw = dict(tau=[0.3, 0.7], nlambda=2, trace_len=30, eps_abs=1e-4,
              eps_rel=1e-4)
    ref = admm_tpu.quantile_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.quantile_lasso_path(X, y, dtype=torch.float64,
                                             device="cpu", **kw)
    assert got.trace.shape == (2, 2, 30, 5)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-7, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("tau", [0.1, 0.5, 0.75])
def test_quantile_null_threshold_with_tied_responses(tau):
    """The weighted tau-quantile takes a stable sort: with ties in y (and
    rows at the quantile) the grid top equals the JAX package's."""
    rng = np.random.default_rng(4)
    n = 40
    X = rng.normal(size=(n, 5))
    y = np.round(rng.normal(size=n), 1)          # many ties
    w = rng.uniform(0.5, 2.0, n)
    w = w * n / w.sum()
    for intercept in (True, False):
        got = _quantile_lam0(torch.as_tensor(X), torch.as_tensor(y),
                             torch.as_tensor(w),
                             torch.tensor(tau, dtype=torch.float64), n,
                             intercept)
        ref = j_lam0(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                     jnp.asarray(tau), n, intercept)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


@pytest.mark.parametrize("case", ["tau_low", "tau_high", "path_mode"])
def test_quantile_refusals_like_jax(data, case):
    """The JAX package's ValueErrors (tests/test_quantile.py:74-77), with
    the same messages."""
    X, y = data
    kw = {"tau_low": dict(tau=[0.0, 0.5]), "tau_high": dict(tau=1.0),
          "path_mode": dict(path_mode="lanes")}[case]
    with pytest.raises(ValueError) as ref:
        admm_tpu.quantile_lasso_path(X, y, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.quantile_lasso_path(X, y, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_pinball_loss_matches_jax():
    rng = np.random.default_rng(1)
    eta, y = rng.normal(size=(3, 9)), rng.normal(size=9)
    for tau in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            admm_tpu_torch.pinball_loss(eta, y, tau),
            admm_tpu.pinball_loss(eta, y, tau))


CV_KW = dict(tau=[0.3, 0.6], nlambda=3, eps_abs=1e-4, eps_rel=1e-4)


@pytest.fixture(scope="module")
def cv_pair(data):
    """The one-pass CV of both packages in float64, weighted."""
    X, y = data
    kw = dict(CV_KW, foldid=np.arange(X.shape[0]) % 3,
              weights=np.random.default_rng(2).uniform(0.5, 2.0, X.shape[0]))
    return (admm_tpu_torch.cv_quantile_lasso_path(
                X, y, device="cpu", dtype=torch.float64, **kw),
            admm_tpu.cv_quantile_lasso_path(X, y, dtype=jnp.float64, **kw))


def _assert_cv_dicts_close(got, ref):
    np.testing.assert_allclose(got["cvm"], ref["cvm"], rtol=1e-4)
    np.testing.assert_allclose(got["cvsd"], ref["cvsd"], rtol=1e-4)
    for key in ("lambda_min", "lambda_1se"):
        for t in range(2):
            i = np.argmin(np.abs(got["lambdas"][t] - got[key][t]))
            j = np.argmin(np.abs(ref["lambdas"][t] - ref[key][t]))
            assert i == j, (key, t)
    np.testing.assert_array_equal(got["foldid"], ref["foldid"])


def test_cv_quantile_lasso_path_matches_jax(cv_pair):
    _assert_cv_dicts_close(*cv_pair)


def test_cv_quantile_lasso_path_loop_matches_jax(data):
    X, y = data
    kw = dict(CV_KW, foldid=np.arange(X.shape[0]) % 2, cv_mode="loop")
    _assert_cv_dicts_close(
        admm_tpu_torch.cv_quantile_lasso_path(X, y, device="cpu",
                                              dtype=torch.float64, **kw),
        admm_tpu.cv_quantile_lasso_path(X, y, dtype=jnp.float64, **kw))


def test_cv_quantile_refuses_cv_mode_like_jax(data):
    X, y = data
    with pytest.raises(ValueError) as ref:
        admm_tpu.cv_quantile_lasso_path(X, y, cv_mode="folds")
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.cv_quantile_lasso_path(X, y, cv_mode="folds",
                                              device="cpu")
    assert str(got.value) == str(ref.value)


def test_predict_and_assess_pick_a_tau_lane_like_jax(data, cv_pair):
    """``predict(..., tau=)`` on a tau grid, the single-tau default, the
    refusals, and a CV dict at its per-tau ``lambda_min``."""
    X, y = data
    kw = dict(nlambda=3, eps_abs=1e-4, eps_rel=1e-4)
    ref = admm_tpu.quantile_lasso_path(X, y, tau=TAUS, dtype=jnp.float64,
                                       **kw)
    got = admm_tpu_torch.quantile_lasso_path(X, y, tau=TAUS,
                                             dtype=torch.float64,
                                             device="cpu", **kw)
    Xn = X[:5]
    for tau in TAUS:
        for lam in (None, 0.05):
            np.testing.assert_allclose(
                admm_tpu_torch.predict(got, Xn, tau=tau, lam=lam),
                admm_tpu.predict(ref, Xn, tau=tau, lam=lam), atol=1e-6)
    for kwp, msg in ((dict(), "tau grid"), (dict(tau=0.33), "not on")):
        with pytest.raises(ValueError, match=msg):
            admm_tpu_torch.predict(got, Xn, **kwp)
    one = admm_tpu_torch.quantile_lasso_path(X, y, tau=0.5, device="cpu",
                                             dtype=torch.float64, **kw)
    assert admm_tpu_torch.predict(one, Xn).shape == (3, 5)
    np.testing.assert_allclose(
        admm_tpu_torch.coef(one, lam=0.02),
        admm_tpu.coef(admm_tpu.quantile_lasso_path(
            X, y, tau=0.5, dtype=jnp.float64, **kw), lam=0.02), atol=1e-6)
    a = admm_tpu_torch.assess(one, X, y)
    assert a["mae"].shape == (3,) and np.isfinite(a["mae"]).all()
    cv_got, cv_ref = cv_pair
    for sel in ("lambda.min", "lambda.1se"):
        np.testing.assert_allclose(
            admm_tpu_torch.predict(cv_got, Xn, tau=0.6, lam=sel),
            admm_tpu.predict(cv_ref, Xn, tau=0.6, lam=sel), atol=1e-6)
    with pytest.raises(ValueError, match="lambda"):
        admm_tpu_torch.predict(cv_got, Xn, tau=0.3, lam="lambda.best")


def test_quantile_result_round_trip(data):
    X, y = data
    ref = admm_tpu.quantile_lasso_path(X, y, tau=[0.4, 0.6], nlambda=2,
                                       dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, admm_tpu_torch.QuantilePathResult)
    assert port.coef.shape == (2, 2, X.shape[1])
    back = to_reference(port, type(ref))
    for a, b in zip(back, ref):
        if b is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
