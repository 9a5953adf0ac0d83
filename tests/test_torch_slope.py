"""The port's SLOPE (``admm_tpu_torch.models.slope``), its sorted-l1 prox,
both isotonic projections and the CV driver against the JAX package's, on
the same seeded numpy inputs and ``device="cpu"``.

Bars: float64 coefficients within 1e-6 (plus rtol 1e-7) and ``niter``
within 1 per lambda, at an explicit rho (2 tall, 1 wide) with power
iteration started from the JAX package's vector; float32 within 2e-4
(niter compared in float64 only), and in the wide regime within the larger
of 2e-4 and the JAX package's own float32 gap to its float64 path.  The
projections and the prox: 1e-12 in float64, exact order of ties.  CV:
cvm rtol 1e-4 and ``lambda_min`` as a grid index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models import slope as jslope
from admm_tpu_torch.models import slope as tslope

from _torch_parity import (assert_cv_close, assert_path_close,  # noqa: F401
                           jax_start_vector)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "f64": (jnp.float64, torch.float64, 1e-6)}
RHO = {"tall": 2.0, "wide": 1.0}


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[:5] = [2.0, -1.5, 1.0, 1.0, -0.5]
    X = rng.normal(size=(n, p))
    return X, 0.5 + X @ b + 0.5 * rng.normal(size=n)


@pytest.fixture(scope="module")
def tall():
    return _problem(80, 16, 0)


@pytest.fixture(scope="module")
def wide():
    return _problem(30, 40, 1)


def _iso_inputs():
    rng = np.random.default_rng(7)
    return {
        "random": rng.normal(size=23),
        "ties": np.round(rng.normal(size=23), 0),
        "near_sorted": np.sort(rng.normal(size=23))[::-1]
        + 0.05 * rng.normal(size=23),
        "sorted": np.linspace(3.0, -1.0, 23),
        "increasing": np.linspace(-1.0, 3.0, 23),
        "constant": np.full(23, 0.7),
    }


@pytest.mark.parametrize("case", list(_iso_inputs()))
def test_isotonic_projections_match_jax_and_each_other(case):
    z = _iso_inputs()[case]
    zt = torch.as_tensor(z)
    dense = tslope.isotonic_nonincreasing(zt).numpy()
    pava = tslope.isotonic_nonincreasing_pava(zt).numpy()
    np.testing.assert_allclose(dense, pava, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        dense, np.asarray(jslope.isotonic_nonincreasing(jnp.asarray(z))),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        pava, np.asarray(jslope.isotonic_nonincreasing_pava(jnp.asarray(z))),
        rtol=1e-12, atol=1e-14)
    assert np.all(np.diff(dense) <= 1e-12)          # nonincreasing


def test_isotonic_projections_over_lanes_match_vmapped_jax():
    """A (k, p) batch projects lane by lane, as the JAX package's vmap."""
    Z = np.stack(list(_iso_inputs().values()))
    for port, ref in ((tslope.isotonic_nonincreasing,
                       jslope.isotonic_nonincreasing),
                      (tslope.isotonic_nonincreasing_pava,
                       jslope.isotonic_nonincreasing_pava)):
        np.testing.assert_allclose(port(torch.as_tensor(Z)).numpy(),
                                   np.asarray(jax.vmap(ref)(Z)),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["dense", "pava", "auto"])
def test_prox_sorted_l1_keeps_the_tie_order(method):
    """Tied magnitudes (and signs) are sorted stably, as ``jnp.argsort(-a)``
    sorts them: the prox equals the JAX package's to rounding, ties
    included."""
    v = np.array([1.0, -1.0, 0.5, 1.0, -0.5, 2.0, 0.0, -2.0, 0.5, 1.0])
    lam = np.linspace(1.2, 0.1, v.size)
    got = tslope.prox_sorted_l1(torch.as_tensor(v), torch.as_tensor(lam),
                                method).numpy()
    ref = np.asarray(jslope.prox_sorted_l1(jnp.asarray(v), jnp.asarray(lam),
                                           method))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    order = torch.argsort(-torch.abs(torch.as_tensor(v)), stable=True)
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.argsort(-jnp.abs(v))))


def test_bh_sequence_matches_jax():
    np.testing.assert_array_equal(admm_tpu_torch.bh_sequence(30, 0.2),
                                  admm_tpu.bh_sequence(30, 0.2))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["batch", "scan"])
@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_slope_path_matches_jax(tall, wide, jax_start_vector, regime, mode,
                                dt):
    X, y = tall if regime == "tall" else wide
    jdt, tdt, atol = DTYPES[dt]
    kw = dict(nlambda=5, path_mode=mode, rho=RHO[regime])
    ref = admm_tpu.slope_path(X, y, dtype=jdt, **kw)
    got = admm_tpu_torch.slope_path(X, y, dtype=tdt, device="cpu", **kw)
    if regime == "wide" and dt == "f32":
        ref64 = admm_tpu.slope_path(X, y, dtype=jnp.float64, **kw)
        own = np.abs(np.asarray(ref.coef) - np.asarray(ref64.coef)).max()
        assert_path_close(got, ref64, max(atol, own), niter=False)
        return
    assert_path_close(got, ref, atol, niter=dt == "f64")


CASES = {
    "auto_rho": {},
    "auto_rho_batch": dict(path_mode="batch"),
    "weights": "weights",
    "user_grid": dict(lambdas=[0.5, 0.05, 0.2]),
    "constant_sequence": "constant",
    "q": dict(q=0.3),
    "no_standardize": dict(standardize=False, intercept=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_slope_options_match_jax(tall, jax_start_vector, case):
    X, y = tall
    kw = CASES[case]
    if kw == "weights":
        kw = dict(weights=np.arange(X.shape[0]) % 3 + 1.0)
    elif kw == "constant":
        kw = dict(lam_seq=np.ones(X.shape[1]))
    kw = dict(dict(nlambda=4), **kw)
    ref = admm_tpu.slope_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.slope_path(X, y, dtype=torch.float64, device="cpu",
                                    **kw)
    assert_path_close(got, ref, 1e-6)


def test_slope_trace_matches_jax(tall, jax_start_vector):
    X, y = tall
    kw = dict(nlambda=3, trace_len=25, rho=2.0)
    ref = admm_tpu.slope_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.slope_path(X, y, dtype=torch.float64, device="cpu",
                                    **kw)
    assert got.trace.shape == (3, 25, 5)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-7, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("case", ["increasing", "length", "zero",
                                  "negative", "path_mode"])
def test_slope_refusals_like_jax(tall, case):
    """The JAX package's ValueErrors (tests/test_slope.py:160-170), with
    the same messages."""
    X, y = tall
    p = X.shape[1]
    kw = {"increasing": dict(lam_seq=np.linspace(0.1, 1.0, p)),
          "length": dict(lam_seq=np.ones(p - 1)),
          "zero": dict(lam_seq=np.zeros(p)),
          "negative": dict(lam_seq=np.r_[np.ones(p - 1), -1.0]),
          "path_mode": dict(path_mode="lanes")}[case]
    with pytest.raises(ValueError) as ref:
        admm_tpu.slope_path(X, y, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.slope_path(X, y, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["onepass", "loop", "weights"])
def test_cv_slope_path_matches_jax(tall, jax_start_vector, case):
    X, y = tall
    kw = dict(foldid=np.arange(X.shape[0]) % 4, nlambda=5, rho=2.0,
              cv_mode="loop" if case == "loop" else "onepass")
    if case == "weights":
        kw["weights"] = np.random.default_rng(3).uniform(0.5, 2.0,
                                                         X.shape[0])
    ref = admm_tpu.cv_slope_path(X, y, **kw)
    got = admm_tpu_torch.cv_slope_path(X, y, device="cpu", **kw)
    assert_cv_close(got, ref)
    assert_path_close(got.fit, ref.fit, 2e-4, niter=False)
