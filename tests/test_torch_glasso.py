"""The port's graphical lasso (``admm_tpu_torch.models.glasso``) against
the JAX package's, on the same seeded numpy inputs and ``device="cpu"``.

The Newton-Schulz square root of the JAX package is a ``while_loop``; the
port runs it in chunks with each matrix frozen at the JAX exit rule, so
the prox is held against the JAX prox on a batch whose members exit at
different steps, and the paths in both x-updates and both path modes.

Bars: float64 precision matrices within 1e-6 (plus rtol 1e-7) and
``niter`` within 1 per lambda; float32 against the JAX package's float64
path within the larger of 2e-4 and the JAX package's own float32 gap to
its float64 path on the same input (measured in the test), the
convention of the port's earlier parity tests: each float32 solve stops
within the solver's tolerance at an iteration that rounding picks (the
batch path here: JAX 4.1e-5, the port 5.0e-5 from float64).  The port's
float32 covariance is its float64 one rounded once: formed in float32 it
lay up to 4.5 times further from float64 than the JAX package's, and the
float32 paths up to 3.1 times (``tests/glasso_f32_gap.py``).  CV: cvm
rtol 1e-6 in float64 and ``lambda_min`` at the same grid point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models import glasso as jglasso
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.models import glasso

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    p = 10
    A = rng.normal(size=(p, p)) * (rng.random((p, p)) < 0.25)
    prec = A @ A.T + np.eye(p)
    L = np.linalg.cholesky(np.linalg.inv(prec))
    return rng.normal(size=(150, p)) @ L.T


def _close(got, ref, atol=1e-6):
    np.testing.assert_allclose(got.precision.numpy(),
                               np.asarray(ref.precision), atol=atol,
                               rtol=1e-7)
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-10)
    gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
    assert gap.max() <= 1, f"niter gap {gap.max()}"


@pytest.mark.parametrize("xupdate", ["newton", "eigh"])
@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_glasso_path_matches_jax_f64(data, path_mode, xupdate):
    got = admm_tpu_torch.glasso_path(data, nlambda=6, path_mode=path_mode,
                                     xupdate=xupdate, **F64)
    ref = admm_tpu.glasso_path(data, nlambda=6, path_mode=path_mode,
                               xupdate=xupdate, dtype=jnp.float64)
    _close(got, ref)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(ref.cov),
                               atol=1e-14)


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_glasso_path_f32_at_the_jax_float32_gap(data, path_mode):
    kw = dict(nlambda=6, path_mode=path_mode)
    got = admm_tpu_torch.glasso_path(data, dtype=torch.float32,
                                     device="cpu", **kw)
    ref64 = np.asarray(admm_tpu.glasso_path(data, dtype=jnp.float64,
                                            **kw).precision)
    ref32 = np.asarray(admm_tpu.glasso_path(data, dtype=jnp.float32,
                                            **kw).precision)
    bar = max(2e-4, np.abs(ref32 - ref64).max())
    assert np.abs(got.precision.numpy() - ref64).max() <= bar
    assert got.precision.dtype == torch.float32


def test_float32_covariance_is_rounded_once(data):
    """The float32 covariance is the float64 one of the float32 data
    rounded once, and no further from float64 than the JAX package's
    float32 covariance."""
    S64 = glasso.empirical_covariance(data, **F64)
    S32 = glasso.empirical_covariance(data, dtype=torch.float32,
                                      device="cpu")
    assert torch.equal(S32, glasso.empirical_covariance(
        data.astype(np.float32), **F64).float())
    jax32 = np.asarray(admm_tpu.empirical_covariance(data,
                                                     dtype=jnp.float32))
    gap = np.abs(S32.double().numpy() - S64.numpy()).max()
    assert gap <= np.abs(jax32 - S64.numpy()).max()


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_float32_path_is_as_near_float64_as_the_jax_packages(data,
                                                             path_mode):
    """On the rounded-once covariance the port's float32 path lies within
    1.5 times the JAX package's float32 gap to float64 (1.21 and 1.26
    here; on a covariance formed in float32 it was 1.75 and 3.11 times)."""
    kw = dict(nlambda=6, path_mode=path_mode)
    ref64 = np.asarray(admm_tpu.glasso_path(data, dtype=jnp.float64,
                                            **kw).precision)
    jgap = np.abs(np.asarray(admm_tpu.glasso_path(
        data, dtype=jnp.float32, **kw).precision) - ref64).max()
    got = admm_tpu_torch.glasso_path(data, dtype=torch.float32,
                                     device="cpu", **kw)
    assert np.abs(got.precision.double().numpy() - ref64).max() <= 1.5 * jgap


@pytest.mark.parametrize("case", ["cov", "weights", "diag", "lambdas",
                                  "centered"])
def test_glasso_path_options_match_jax(data, case):
    rng = np.random.default_rng(4)
    kw = {"cov": {}, "weights": {"weights": rng.uniform(0.5, 2, 150)},
          "diag": {"penalize_diagonal": True},
          "lambdas": {"lambdas": [0.02, 0.2, 0.08]},
          "centered": {"assume_centered": True}}[case]
    if case == "cov":
        S = np.cov(data.T, bias=True)
        got = admm_tpu_torch.glasso_path(cov=S, nlambda=5, **F64)
        ref = admm_tpu.glasso_path(cov=S, nlambda=5, dtype=jnp.float64)
    else:
        got = admm_tpu_torch.glasso_path(data, nlambda=5, **kw, **F64)
        ref = admm_tpu.glasso_path(data, nlambda=5, dtype=jnp.float64, **kw)
    _close(got, ref)


def test_glasso_traced_path_matches_jax(data):
    got = admm_tpu_torch.glasso_path(data, nlambda=4, trace_len=64,
                                     path_mode="batch", **F64)
    ref = admm_tpu.glasso_path(data, nlambda=4, trace_len=64,
                               dtype=jnp.float64)
    _close(got, ref)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-6, atol=1e-12)


def test_newton_prox_matches_jax_per_matrix_exit(data):
    """A batch whose matrices exit the Newton-Schulz loop at different
    steps (the rho scale moves the exit): each equals the JAX prox of that
    matrix alone, and the eigh form."""
    rng = np.random.default_rng(7)
    G = rng.normal(size=(3, 12, 12))
    G = 0.5 * (G + np.transpose(G, (0, 2, 1)))
    rho = np.array([0.05, 1.0, 40.0])
    got = glasso._logdet_prox_newton(torch.as_tensor(G), torch.as_tensor(rho))
    for i in range(3):
        ref = jglasso._logdet_prox_newton(jnp.asarray(G[i]),
                                          jnp.asarray(rho[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   atol=1e-12)
    eig = glasso._logdet_prox_eigh(torch.as_tensor(G), torch.as_tensor(rho))
    np.testing.assert_allclose(got.numpy(), eig.numpy(), atol=1e-10)


def test_newton_prox_f32_matches_jax_f32():
    rng = np.random.default_rng(8)
    G = rng.normal(size=(20, 20))
    G = (0.5 * (G + G.T)).astype(np.float32)
    got = glasso._logdet_prox_newton(torch.as_tensor(G),
                                     torch.tensor(0.7, dtype=torch.float32))
    ref = jglasso._logdet_prox_newton(jnp.asarray(G), jnp.float32(0.7))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


def test_cv_glasso_path_matches_jax(data):
    got = admm_tpu_torch.cv_glasso_path(data, nfolds=3, nlambda=5, **F64)
    ref = admm_tpu.cv_glasso_path(data, nfolds=3, nlambda=5,
                                  dtype=jnp.float64)
    np.testing.assert_array_equal(got.foldid, ref.foldid)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-6)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-6)
    assert np.isclose(got.lambda_min, ref.lambda_min, rtol=1e-10)
    assert np.isclose(got.lambda_1se, ref.lambda_1se, rtol=1e-10)
    _close(got.fit, ref.fit)


def test_cv_glasso_path_weights_and_foldid_match_jax(data):
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 2.0, data.shape[0])
    foldid = np.arange(data.shape[0]) % 3
    foldid[:5] = -1                   # train-only rows are never scored
    got = admm_tpu_torch.cv_glasso_path(data, foldid=foldid, weights=w,
                                        nlambda=4, **F64)
    ref = admm_tpu.cv_glasso_path(data, foldid=foldid, weights=w, nlambda=4,
                                  dtype=jnp.float64)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-6)


def test_empirical_covariance_and_partial_correlations_match_jax(data):
    w = np.random.default_rng(6).uniform(0.5, 2.0, data.shape[0])
    for kw in ({}, {"weights": w}, {"assume_centered": True}):
        got = admm_tpu_torch.empirical_covariance(data, **kw, **F64)
        ref = admm_tpu.empirical_covariance(data, dtype=jnp.float64, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-14)
    fit = admm_tpu_torch.glasso_path(data, nlambda=3, **F64)
    np.testing.assert_allclose(
        admm_tpu_torch.partial_correlations(fit.precision).numpy(),
        np.asarray(admm_tpu.partial_correlations(fit.precision.numpy())),
        atol=1e-14)


def test_glasso_result_round_trips_through_interop(data):
    ref = admm_tpu.glasso_path(data, nlambda=3, dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, glasso.GlassoResult)
    back = to_reference(port, type(ref))
    np.testing.assert_array_equal(back.precision, np.asarray(ref.precision))


@pytest.mark.parametrize("kw,err", [
    ({"xupdate": "cholesky"}, ValueError), ({"path_mode": "wide"}, ValueError),
    ({"cov": np.eye(3)}, ValueError), ({"data_mesh": object()},
                                        NotImplementedError)])
def test_glasso_path_errors(data, kw, err):
    with pytest.raises(err):
        admm_tpu_torch.glasso_path(data, **kw, **F64)
    if err is ValueError and "cov" not in kw:
        with pytest.raises(err):
            jax.block_until_ready(admm_tpu.glasso_path(data, **kw))
