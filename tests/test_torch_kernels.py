"""The port's path kernels, in their plain PyTorch form on the CPU, against
the JAX package's Pallas kernels in interpret mode.

Both sides get the same inputs, built once by the JAX package and handed
across with ``admm_tpu_torch.interop`` (the same Minv, X'y, rho, sprad,
lambda0 and lambda grid), so a kernel is compared with a kernel and not
with a power-iteration rounding.  Shapes and bars are those of
``tests/test_pallas_kernels.py``: coefficients within 1e-5 in float32;
niter within 1 per lane for the batched kernels (the two sides accumulate
their matrix products in different orders); scan niter totals within
max(3, 10%) (a one-iteration shift at one lambda moves the next warm
start); and the wide lane above lambda0 exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.data.standardize import standardize
from admm_tpu.linalg import dot, gram, ridge_inverse, spectral_radius_sym
from admm_tpu.models.lasso import _wide_setup
from admm_tpu.ops.tall_path import (tall_path_batch_pallas,
                                    tall_path_scan_pallas)
from admm_tpu.ops.wide_path import wide_path_batch_pallas
from admm_tpu_torch import kernels
from admm_tpu_torch.interop import to_torch
from admm_tpu_torch.kernels import tall_path, wide_path
from admm_tpu_torch.models import lasso as tlasso

torch.set_num_threads(1)

MAXIT = 2000


@pytest.fixture(scope="module")
def tall_inputs():
    """n = 200, p = 40, k = 10 (test_pallas_kernels.py::problem)."""
    rng = np.random.default_rng(3)
    n, p, k = 200, 40, 10
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.4)
    y = 1.0 + X @ b + 0.3 * rng.normal(size=n)
    Xs, ys, _ = standardize(jnp.asarray(X, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            standardize_x=True, intercept=True)
    lam0 = float(jnp.max(jnp.abs(dot(Xs.T, ys))))
    ilams = jnp.asarray(np.geomspace(lam0, lam0 * 1e-3, k), jnp.float32)
    XtX = gram(Xs)
    Xty = dot(Xs.T, ys)
    rho = jnp.cbrt(spectral_radius_sym(XtX)) * ilams[0] ** (2.0 / 3.0)
    Minv = ridge_inverse(XtX, rho)
    return dict(jax=(Minv, Xty, ilams, rho), p=p,
                torch=tuple(to_torch(a) for a in (Minv, Xty, ilams, rho)))


@pytest.fixture(scope="module")
def wide_inputs():
    """n = 60, p = 150, k = 9, first lambda above lambda0
    (test_pallas_kernels.py::wide_problem)."""
    rng = np.random.default_rng(11)
    n, p, k = 60, 150, 9
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:12] = rng.normal(size=12)
    y = X @ b + 0.2 * rng.normal(size=n)
    Xs, ys, _ = standardize(jnp.asarray(X, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            standardize_x=True, intercept=True)
    lam0 = float(jnp.max(jnp.abs(dot(Xs.T, ys))))
    ilams = jnp.asarray(np.geomspace(lam0 * 1.1, lam0 * 1e-2, k),
                        jnp.float32)
    return dict(Xs=Xs, ys=ys, ilams=ilams, n=n, p=p)


def _pallas_wide(w, alpha):
    lambda0, sprad, rho = _wide_setup(w["Xs"], w["ys"], w["ilams"], -1.0,
                                      alpha, False)
    out = wide_path_batch_pallas(w["Xs"], w["ys"], w["ilams"], rho, sprad,
                                 lambda0, 1e-5, 1e-5, alpha, MAXIT,
                                 true_n=w["n"], true_p=w["p"], interpret=True)
    return out, tuple(to_torch(a) for a in (w["Xs"], w["ys"], w["ilams"],
                                            rho, sprad, lambda0))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_batch_plain_matches_pallas(tall_inputs, alpha):
    Minv, Xty, ilams, rho = tall_inputs["jax"]
    z_ref, n_ref = tall_path_batch_pallas(Minv, Xty, ilams, rho, 1e-5, 1e-5,
                                          alpha, MAXIT,
                                          true_p=tall_inputs["p"],
                                          interpret=True)
    z, niter = tall_path.tall_path_batch_reference(
        *tall_inputs["torch"], 1e-5, 1e-5, alpha, MAXIT)
    assert z.dtype == torch.float32 and niter.dtype == torch.int32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    assert np.max(np.abs(niter.numpy() - np.asarray(n_ref))) <= 1


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_scan_plain_matches_pallas(tall_inputs, alpha):
    Minv, Xty, ilams, rho = tall_inputs["jax"]
    z_ref, n_ref = tall_path_scan_pallas(Minv, Xty, ilams, rho, 1e-5, 1e-5,
                                         alpha, MAXIT,
                                         true_p=tall_inputs["p"],
                                         interpret=True)
    z, niter = tall_path.tall_path_scan_reference(
        *tall_inputs["torch"], 1e-5, 1e-5, alpha, MAXIT)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    total = int(np.asarray(n_ref).sum())
    assert abs(int(niter.sum()) - total) <= max(3, int(0.1 * total))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_wide_batch_plain_matches_pallas(wide_inputs, alpha):
    (x_ref, n_ref), args = _pallas_wide(wide_inputs, alpha)
    x, niter = wide_path.wide_path_batch_reference(*args, 1e-5, 1e-5, alpha,
                                                   MAXIT)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-5)
    assert np.max(np.abs(niter.numpy() - np.asarray(n_ref))) <= 1
    # The first lambda is above lambda0: the all-zero exit is exact.
    assert torch.abs(x[0]).max().item() == 0.0


def test_wrappers_run_plain_form_on_cpu_without_launching(tall_inputs):
    """On CPU tensors each wrapper returns exactly its plain form's result
    and counts no launch."""
    kernels.reset_launch_counts()
    args = (*tall_inputs["torch"], 1e-5, 1e-5, 1.0, MAXIT)
    for wrap, plain in ((tall_path.tall_path_batch,
                         tall_path.tall_path_batch_reference),
                        (tall_path.tall_path_scan,
                         tall_path.tall_path_scan_reference)):
        a, b = wrap(*args), plain(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kernels.launch_counts() == {"tall_path_batch": 0,
                                       "tall_path_scan": 0,
                                       "wide_path_batch": 0}


def test_wide_wrapper_runs_plain_form_on_cpu(wide_inputs):
    _, args = _pallas_wide(wide_inputs, 1.0)
    kernels.reset_launch_counts()
    a = wide_path.wide_path_batch(*args, 1e-5, 1e-5, 1.0, MAXIT)
    b = wide_path.wide_path_batch_reference(*args, 1e-5, 1e-5, 1.0, MAXIT)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kernels.launch_counts()["wide_path_batch"] == 0


def test_kernel_shape_rules():
    """The kernels hold lane state in one block's shared memory (232448
    bytes on sm_90, 2 KB kept for scratch); past that the path takes the
    engine, and the choice is made before any call."""
    assert tall_path.MAX_P == 7200
    assert tall_path.fits(1000) and tall_path.fits(7200)
    assert not tall_path.fits(7201) and not tall_path.fits(0)
    assert wide_path.fits(1000, 2000)
    assert wide_path.fits(1000, (57600 - 5000) // 3)
    assert not wide_path.fits(1000, (57600 - 5000) // 3 + 1)
    assert tlasso._use_kernel_tall(1000, torch.float32)
    assert not tlasso._use_kernel_tall(1000, torch.float64)
    assert not tlasso._use_kernel_tall(10000, torch.float32)
    assert tlasso._use_kernel_wide(1000, 2000, torch.float32)
    assert not tlasso._use_kernel_wide(1000, 2000, torch.float64)
    assert not tlasso._use_kernel_wide(20000, 2000, torch.float32)


def test_float32_path_goes_through_the_kernels(monkeypatch):
    """In float32 every path mode dispatches to its kernel wrapper;
    float64 and shapes past a kernel's rule take the engines."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tall_path, "tall_path_batch",
                        spy("batch", tall_path.tall_path_batch))
    monkeypatch.setattr(tall_path, "tall_path_scan",
                        spy("scan", tall_path.tall_path_scan))
    monkeypatch.setattr(wide_path, "wide_path_batch",
                        spy("wide", wide_path.wide_path_batch))
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(40, 8)), rng.normal(size=40)
    Xw, yw = rng.normal(size=(12, 30)), rng.normal(size=12)
    for mode in ("batch", "scan"):
        tlasso.lasso_path(X, y, nlambda=3, path_mode=mode, device="cpu")
    tlasso.lasso_path(Xw, yw, nlambda=3, path_mode="batch", device="cpu")
    assert calls == ["batch", "scan", "wide"]
    tlasso.lasso_path(X, y, nlambda=3, path_mode="batch", device="cpu",
                      dtype=torch.float64)
    tlasso.lasso_path(Xw, yw, nlambda=3, path_mode="scan", device="cpu")
    monkeypatch.setattr(tall_path, "MAX_P", 4)
    tlasso.lasso_path(X, y, nlambda=3, path_mode="batch", device="cpu")
    assert calls == ["batch", "scan", "wide"]
