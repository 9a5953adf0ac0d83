"""The port's Dantzig-selector path, end to end, against the JAX package.

The same numpy inputs go through ``admm_tpu`` and ``admm_tpu_torch``
(``device="cpu"``); both run the generic (non-accelerated) ADMM engine,
there is no kernel on this path.  The two packages draw power
iteration's start vector from different generators, so ``sprad`` differs
in the last bits, and with it the step ``1/(rho sprad)`` (at any rho)
and the auto rho ``1/sqrt(sprad)``.  Bars: lambda grids rtol 1e-6 (one
float32 ulp in the log domain; 1e-12 in float64); coefficients within
2e-4 and intercepts within 2e-3 in float32, the Lasso path's bars
(``tests/test_torch_lasso.py``), and within 1e-5 in float64; ``niter``
within max(3, 10%) per lambda (in "scan" mode a one-iteration shift at
one lambda moves the next warm start).  The flag modes without centering
are ill-conditioned in float32 and are compared in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def tall():
    rng = np.random.default_rng(5)
    n, p = 200, 30
    b = np.zeros(p)
    b[:5] = 2.0 * rng.normal(size=5)
    X = rng.normal(0.5, 1.5, (n, p))
    return X, 1.0 + X @ b + 0.2 * rng.normal(size=n)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(6)
    n, p = 30, 45
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:4] = rng.uniform(1.0, 2.0, 4)
    return X, X @ b + 0.1 * rng.normal(size=n)


def _assert_paths_match(ref, got, dtype="float32"):
    f64 = dtype == "float64"
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-12 if f64 else 1e-6)
    assert got.coef.shape == tuple(np.asarray(ref.coef).shape)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=1e-5 if f64 else 2e-4)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=1e-5 if f64 else 2e-3)
    assert got.niter.dtype == torch.int32 and got.trace is None
    for a, b in zip(got.niter.numpy(), np.asarray(ref.niter)):
        assert abs(int(a) - int(b)) <= max(3, int(0.1 * int(b)))


@pytest.mark.parametrize("rho", [-1.0, 0.01])
@pytest.mark.parametrize("path_mode", ["scan", "batch"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dantzig_path_matches_reference(tall, dtype, path_mode, rho):
    X, y = tall
    jdt, tdt = DTYPES[dtype]
    kw = dict(nlambda=8, path_mode=path_mode, rho=rho)
    got = admm_tpu_torch.dantzig_path(X, y, dtype=tdt, device="cpu", **kw)
    assert got.coef.dtype == tdt and got.coef.shape == (8, X.shape[1])
    _assert_paths_match(admm_tpu.dantzig_path(X, y, dtype=jdt, **kw), got,
                        dtype)
    # The first lambda is lambda0: the all-zero solution.
    assert float(got.coef[0].abs().max()) <= 1e-5


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_dantzig_wide_matrix_free_matches_reference(wide, path_mode):
    """n < p applies X'X matrix-free as X'(X v)."""
    X, y = wide
    kw = dict(nlambda=6, path_mode=path_mode, maxit=3000)
    _assert_paths_match(admm_tpu.dantzig_path(X, y, **kw),
                        admm_tpu_torch.dantzig_path(X, y, device="cpu", **kw))


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_dantzig_weights_match_reference(tall, path_mode):
    X, y = tall
    w = np.random.default_rng(7).uniform(0.5, 2.0, X.shape[0])
    kw = dict(nlambda=6, weights=w, path_mode=path_mode)
    _assert_paths_match(admm_tpu.dantzig_path(X, y, **kw),
                        admm_tpu_torch.dantzig_path(X, y, device="cpu", **kw))


def test_dantzig_integer_weight_equals_repeated_rows():
    """The shared sqrt(w) row scaling: weight k is the row k times (the
    JAX package's own check, ``tests/test_cv.py``, at its bar)."""
    rng = np.random.default_rng(0)
    n, p = 80, 10
    X = rng.normal(size=(n, p))
    y = X[:, 0] + 0.2 * rng.normal(size=n)
    w = rng.integers(1, 4, n).astype(float)
    kw = dict(lambdas=np.array([0.1, 0.04]), eps_abs=1e-8, eps_rel=1e-8,
              dtype=torch.float64, device="cpu")
    idx = np.repeat(np.arange(n), w.astype(int))
    rw = admm_tpu_torch.dantzig_path(X, y, weights=w, **kw)
    rd = admm_tpu_torch.dantzig_path(X[idx], y[idx], **kw)
    np.testing.assert_allclose(rw.coef.numpy(), rd.coef.numpy(), atol=2e-6)


@pytest.mark.parametrize("standardize,intercept",
                         [(False, False), (True, False), (False, True)])
def test_dantzig_user_lambdas_and_flags_match(tall, standardize, intercept):
    X, y = tall
    lams = np.array([0.05, 1.0, 0.2])              # sorted descending inside
    kw = dict(lambdas=lams, standardize=standardize, intercept=intercept)
    got = admm_tpu_torch.dantzig_path(X, y, device="cpu",
                                      dtype=torch.float64, **kw)
    np.testing.assert_array_equal(got.lambdas.numpy(), np.sort(lams)[::-1])
    _assert_paths_match(admm_tpu.dantzig_path(X, y, dtype=jnp.float64, **kw),
                        got, "float64")


def test_dantzig_batch_matches_scan(tall):
    X, y = tall
    lams = np.geomspace(0.5, 0.02, 6)
    scan = admm_tpu_torch.dantzig_path(X, y, lambdas=lams, device="cpu")
    batch = admm_tpu_torch.dantzig_path(X, y, lambdas=lams, device="cpu",
                                        path_mode="batch")
    np.testing.assert_allclose(batch.coef.numpy(), scan.coef.numpy(),
                               atol=5e-3)


@pytest.mark.parametrize("path_mode", ["batch", "scan"])
def test_dantzig_builder_matches_reference(tall, path_mode):
    X, y = tall
    ref = admm_tpu.admm_dantzig(X, y).penalty(nlambda=8).opts(
        path_mode=path_mode).fit()
    got = admm_tpu_torch.admm_dantzig(X, y, device="cpu").penalty(
        nlambda=8).opts(path_mode=path_mode).fit()
    assert isinstance(got, admm_tpu_torch.ADMMLassoFit)
    np.testing.assert_allclose(got.lambda_, ref.lambda_, rtol=1e-6)
    assert got.beta.shape == ref.beta.shape == (X.shape[1] + 1, 8)
    b_ref, b_got = ref.beta.toarray(), got.beta.toarray()
    np.testing.assert_allclose(b_got[1:], b_ref[1:], atol=2e-4)
    np.testing.assert_allclose(b_got[0], b_ref[0], atol=2e-3)
    assert got.niter.shape == (8,)


@pytest.mark.parametrize("case", [
    "rows", "nan", "lambda", "nlambda", "ratio", "maxit", "eps", "rho",
    "path_mode", "activeset",
])
def test_dantzig_builder_validates_like_reference(tall, case):
    """Every ``ValueError`` of the JAX builder, on both packages."""
    X, y = tall
    bad = X.copy()
    bad[1, 1] = np.nan
    calls = {
        "rows": lambda m: m.admm_dantzig(X, y[:-1]),
        "nan": lambda m: m.admm_dantzig(bad, y),
        "lambda": lambda m: m.admm_dantzig(X, y).penalty(lambda_=[0.1, -1.0]),
        "nlambda": lambda m: m.admm_dantzig(X, y).penalty(nlambda=0),
        "ratio": lambda m: m.admm_dantzig(X, y).penalty(lambda_min_ratio=1.5),
        "maxit": lambda m: m.admm_dantzig(X, y).opts(maxit=0),
        "eps": lambda m: m.admm_dantzig(X, y).opts(eps_abs=-1.0),
        "rho": lambda m: m.admm_dantzig(X, y).opts(rho=0.0),
        "path_mode": lambda m: m.admm_dantzig(X, y).opts(path_mode="nope"),
        # The JAX builder refuses this one at fit time.
        "activeset": lambda m: m.admm_dantzig(X, y).penalty(nlambda=2).opts(
            path_mode="activeset").fit(),
    }
    with pytest.raises(ValueError) as ref:
        calls[case](admm_tpu)
    with pytest.raises(ValueError) as got:
        calls[case](admm_tpu_torch)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("option", [
    "trace_len", "data_mesh", "builder_trace", "builder_penalty_factor",
    "builder_limits", "fit_plot",
])
def test_dantzig_options_not_ported_raise(tall, option):
    """What is not ported raises by name; the traced path is ported and
    must record one trace per lambda, ``data_mesh`` on a 4-position CPU
    mesh agrees with the path without one (its parity with the JAX
    package's is ``tests/test_torch_mesh.py``), and ``fit.plot()`` must
    draw the path."""
    X, y = tall
    t = admm_tpu_torch
    builder = t.admm_dantzig(X, y, device="cpu")
    calls = {
        "trace_len": lambda: t.dantzig_path(X, y, trace_len=8, device="cpu"),
        "data_mesh": lambda: t.dantzig_path(
            X, y, nlambda=5, data_mesh=torch_mesh(4, devices=["cpu"] * 4),
            device="cpu"),
        "builder_trace": lambda: builder.penalty(nlambda=2).opts(
            trace=8).fit(),
        # The builder takes glmnet's options since the Lasso ports them;
        # its fit refuses them with the reference's own error.
        "builder_penalty_factor": lambda: builder.penalty(
            penalty_factor=np.ones(X.shape[1])).fit(),
        "builder_limits": lambda: builder.penalty(upper_limits=1.0).fit(),
        "fit_plot": lambda: builder.penalty(nlambda=2).opts(
            maxit=5).fit().plot(),
    }
    if "trace" in option:
        res = calls[option]()
        assert res.trace.shape[1:] == (8, 5)
        assert np.isfinite(np.asarray(res.trace)[:, 0]).any()
        return
    if option == "data_mesh":
        ref = t.dantzig_path(X, y, nlambda=5, device="cpu")
        np.testing.assert_allclose(calls[option]().coef.numpy(),
                                   ref.coef.numpy(), atol=1e-4)
        return
    if option == "fit_plot":
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        ax = calls[option]()
        assert ax.get_title() == "Solution path"
        plt.close(ax.figure)
        return
    match = ("not supported for the Dantzig selector"
             if option.startswith("builder_") and option != "builder_trace"
             else "not ported")
    with pytest.raises(NotImplementedError, match=match):
        calls[option]()


def test_dantzig_parallel_raises_as_in_reference(tall):
    X, y = tall
    with pytest.raises(NotImplementedError) as ref:
        admm_tpu.admm_dantzig(X, y).parallel()
    with pytest.raises(NotImplementedError) as got:
        admm_tpu_torch.admm_dantzig(X, y).parallel()
    assert str(got.value) == str(ref.value)


def test_dantzig_tensor_input_stays_on_its_device(tall):
    X, y = tall
    Xt = torch.as_tensor(X, dtype=torch.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    # The default device is "cuda"; tensors stay where they are.
    res = admm_tpu_torch.dantzig_path(Xt, yt, nlambda=3, maxit=50)
    assert res.coef.device.type == "cpu" and res.coef.shape == (3, 30)
    fit = admm_tpu_torch.admm_dantzig(Xt, yt).penalty(nlambda=3).opts(
        maxit=50).fit()
    assert fit.beta.shape == (31, 3)
