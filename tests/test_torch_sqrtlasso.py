"""The port's square-root lasso (``admm_tpu_torch.models.sqrtlasso``) and
its CV driver against the JAX package's, on the same seeded numpy inputs
and ``device="cpu"``.

Bars: float64 coefficients within 1e-6 (plus rtol 1e-7) and ``niter``
within 1 per lambda (the concomitant scan's niter is each lambda's total
over its sigma steps); float32 within 2e-4, niter compared in float64
only.  In the wide regime float32 rounding governs both packages (the
JAX package's float32 path is up to 3.1e-3 from its float64 one here,
the port's 2.6e-4), so there the port's float32 path is held to the JAX
float64 path within the larger of 2e-4 and the JAX package's own float32
gap.  Power iteration starts from the JAX package's vector
(``jax_start_vector``), so the auto rho of the tall inner engine and the
wide regime's 1/sprad step agree.  The solver matrix runs at an explicit
rho (2 tall, 1 wide), the option cases at the auto rho: at the auto rho
the wide stacked batch path's second lane parts by 3.6e-6 and 9
iterations in float64 although the two rhos and the grids agree to an
ulp (the residual traces agree to 5e-14 for three iterations and then
part), so that lane is a float64 rounding amplifier, not a port gap.
CV (float32 in both packages, as the JAX driver fits): cvm rtol 1e-4
and ``lambda_min`` as a grid index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu.models.sqrtlasso import l2_prox as jl2_prox
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.models.sqrtlasso import l2_prox

from _torch_parity import (assert_cv_close, assert_path_close,  # noqa: F401
                           jax_start_vector)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "f64": (jnp.float64, torch.float64, 1e-6)}


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[:4] = [1.0, -1.0, 0.5, 2.0]
    X = rng.normal(size=(n, p))
    return X, 1.0 + X @ b + 0.5 * rng.normal(size=n)


@pytest.fixture(scope="module")
def tall():
    return _problem(80, 12, 0)


@pytest.fixture(scope="module")
def wide():
    return _problem(30, 40, 1)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("algorithm", ["concomitant", "stacked"])
@pytest.mark.parametrize("mode", ["batch", "scan"])
@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_sqrt_lasso_path_matches_jax(tall, wide, jax_start_vector, regime,
                                     mode, algorithm, dt):
    X, y = tall if regime == "tall" else wide
    jdt, tdt, atol = DTYPES[dt]
    kw = dict(nlambda=5, path_mode=mode, algorithm=algorithm,
              rho=2.0 if regime == "tall" else 1.0,
              lambda_min_ratio=0.01 if regime == "tall" else 0.1)
    ref = admm_tpu.sqrt_lasso_path(X, y, dtype=jdt, **kw)
    got = admm_tpu_torch.sqrt_lasso_path(X, y, dtype=tdt, device="cpu", **kw)
    assert got.coef.device.type == "cpu" and got.coef.dtype == tdt
    if regime == "wide" and dt == "f32":
        # Held to float64 no worse than the JAX package's own float32.
        ref64 = admm_tpu.sqrt_lasso_path(X, y, dtype=jnp.float64, **kw)
        own = np.abs(np.asarray(ref.coef) - np.asarray(ref64.coef)).max()
        assert_path_close(got, ref64, max(atol, own), niter=False)
        return
    assert_path_close(got, ref, atol, niter=dt == "f64")


CASES = {
    "auto_rho_batch": lambda n: {},
    "auto_rho_scan": lambda n: dict(path_mode="scan"),
    "auto_rho_stacked": lambda n: dict(algorithm="stacked"),
    "weights": lambda n: dict(weights=np.random.default_rng(5).uniform(
        0.5, 2.0, n)),
    "user_grid": lambda n: dict(lambdas=[0.02, 0.3, 0.1]),
    "no_standardize": lambda n: dict(standardize=False, intercept=False),
    "rho": lambda n: dict(rho=2.0),
    "scan_weights": lambda n: dict(path_mode="scan", weights=np.arange(
        n) % 3 + 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sqrt_lasso_options_match_jax(tall, jax_start_vector, case):
    X, y = tall
    kw = dict(dict(nlambda=5), **CASES[case](X.shape[0]))
    ref = admm_tpu.sqrt_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.sqrt_lasso_path(X, y, dtype=torch.float64,
                                         device="cpu", **kw)
    assert_path_close(got, ref, 1e-6)


@pytest.mark.parametrize("algorithm", ["concomitant", "stacked"])
def test_sqrt_lasso_wide_scan_auto_rho_matches_jax(wide, jax_start_vector,
                                                   algorithm):
    X, y = wide
    kw = dict(nlambda=5, path_mode="scan", algorithm=algorithm,
              lambda_min_ratio=0.1)
    ref = admm_tpu.sqrt_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.sqrt_lasso_path(X, y, dtype=torch.float64,
                                         device="cpu", **kw)
    assert_path_close(got, ref, 1e-6)


def test_sqrt_lasso_trace_matches_jax(tall, jax_start_vector):
    """``trace_len`` takes the stacked scan, as in the JAX package: the
    same (nlambda, trace_len, 5) residual rows, NaN past convergence."""
    X, y = tall
    kw = dict(nlambda=3, trace_len=40)
    ref = admm_tpu.sqrt_lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.sqrt_lasso_path(X, y, dtype=torch.float64,
                                         device="cpu", **kw)
    assert got.trace.shape == (3, 40, 5)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-7, atol=1e-12, equal_nan=True)


def test_l2_prox_matches_jax():
    rng = np.random.default_rng(2)
    for v, tau in ((rng.normal(size=7), 0.5), (rng.normal(size=7), 9.0),
                   (np.zeros(7), 0.3)):
        got = l2_prox(torch.as_tensor(v), tau).numpy()
        np.testing.assert_allclose(got, np.asarray(jl2_prox(v, tau)),
                                   rtol=1e-12, atol=1e-15)
    # A batch of lanes, each with its own tau, equals the vmapped prox.
    V = rng.normal(size=(4, 6))
    taus = np.array([0.1, 1.0, 3.0, 10.0])
    got = l2_prox(torch.as_tensor(V), torch.as_tensor(taus)[:, None])
    ref = jax.vmap(jl2_prox)(V, taus)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("case", ["path_mode", "algorithm"])
def test_sqrt_lasso_refusals_like_jax(tall, case):
    """The JAX package's ValueErrors (tests/test_sqrtlasso.py:95,111),
    with the same messages."""
    X, y = tall
    kw = {"path_mode": dict(path_mode="warm"),
          "algorithm": dict(algorithm="newton")}[case]
    with pytest.raises(ValueError) as ref:
        admm_tpu.sqrt_lasso_path(X, y, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.sqrt_lasso_path(X, y, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_sqrt_lasso_data_mesh_not_ported(tall):
    """``data_mesh`` on a 4-position CPU mesh agrees with the path without
    one at the float32 bar (the JAX package's parity is
    ``tests/test_torch_mesh.py``)."""
    X, y = tall
    got = admm_tpu_torch.sqrt_lasso_path(
        X, y, data_mesh=torch_mesh(4, devices=["cpu"] * 4), device="cpu")
    ref = admm_tpu_torch.sqrt_lasso_path(X, y, device="cpu")
    np.testing.assert_allclose(got.coef.numpy(), ref.coef.numpy(),
                               atol=2e-4)


@pytest.mark.parametrize("case", ["onepass", "loop", "weights"])
def test_cv_sqrt_lasso_path_matches_jax(tall, jax_start_vector, case):
    X, y = tall
    kw = dict(foldid=np.arange(X.shape[0]) % 4, nlambda=6,
              cv_mode="loop" if case == "loop" else "onepass")
    if case == "weights":
        kw["weights"] = np.random.default_rng(3).uniform(0.5, 2.0,
                                                         X.shape[0])
    ref = admm_tpu.cv_sqrt_lasso_path(X, y, **kw)
    got = admm_tpu_torch.cv_sqrt_lasso_path(X, y, device="cpu", **kw)
    assert_cv_close(got, ref)
    assert_path_close(got.fit, ref.fit, 2e-4, niter=False)


def test_sqrt_lasso_result_round_trip(tall):
    """The JAX package's result carries across and back field by field."""
    X, y = tall
    ref = admm_tpu.sqrt_lasso_path(X, y, nlambda=3, dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, admm_tpu_torch.PathResult)
    back = to_reference(port, type(ref))
    for a, b in zip(back, ref):
        if b is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
