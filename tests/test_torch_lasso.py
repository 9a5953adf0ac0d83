"""The port's Lasso/Elastic-Net path, end to end, against the JAX package.

The same numpy inputs go through ``admm_tpu`` and ``admm_tpu_torch``
(``device="cpu"``, where the path runs its kernels' plain forms).  Bars:
lambda grids rtol 1e-6 (one float32 ulp in the log domain); with an
explicit ``rho`` the tall coefficients within 1e-5; with auto-rho, and in
the wide regime, coefficients within 2e-4 and intercepts within 2e-3,
the between-path-modes bar of ``tests/test_lasso.py``: the two packages
draw power iteration's start vector from different generators, so sprad,
and with it rho (and the wide step size), differ in the last bits.
"""
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tall():
    # Coefficients up to 4 put the grid's lambda0 near 7, so the whole grid
    # (down to 1e-4 lambda0) has |log lambda| < 8, where one float32 ulp of
    # the log is 4.8e-7 of lambda: the 1e-6 bar then holds two ulps.
    rng = np.random.default_rng(21)
    n, p = 120, 15
    X = rng.normal(0.5, 1.5, (n, p))
    b = 4.0 * rng.uniform(-1, 1, p) * (rng.uniform(size=p) < 0.5)
    return X, 2.0 + X @ b + 0.5 * rng.normal(size=n)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(22)
    n, p = 50, 110
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:6] = rng.uniform(0.5, 1.0, 6)
    return X, X @ b + 0.2 * rng.normal(size=n)


def _assert_paths_match(ref, got, coef_atol=2e-4, beta0_atol=2e-3):
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-6)
    assert got.coef.shape == tuple(np.asarray(ref.coef).shape)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=coef_atol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=beta0_atol)
    assert got.niter.dtype == torch.int32 and bool((got.niter > 0).all())


@pytest.mark.parametrize("regime", ["tall", "wide"])
@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_lasso_path_matches_reference(request, regime, path_mode):
    X, y = request.getfixturevalue(regime)
    kw = dict(nlambda=20, path_mode=path_mode)
    _assert_paths_match(admm_tpu.lasso_path(X, y, **kw),
                        admm_tpu_torch.lasso_path(X, y, device="cpu", **kw))


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_tall_explicit_rho_matches_reference(tall, path_mode):
    X, y = tall
    kw = dict(nlambda=20, path_mode=path_mode, rho=20.0)
    _assert_paths_match(admm_tpu.lasso_path(X, y, **kw),
                        admm_tpu_torch.lasso_path(X, y, device="cpu", **kw),
                        coef_atol=1e-5)


@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_enet_path_matches_reference(request, regime):
    X, y = request.getfixturevalue(regime)
    _assert_paths_match(
        admm_tpu.enet_path(X, y, alpha=0.6, nlambda=20),
        admm_tpu_torch.enet_path(X, y, alpha=0.6, nlambda=20, device="cpu"))


@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_builder_fit_matches_reference(request, regime):
    X, y = request.getfixturevalue(regime)
    ref = admm_tpu.admm_lasso(X, y).penalty(nlambda=20).fit()
    got = admm_tpu_torch.admm_lasso(X, y, device="cpu").penalty(
        nlambda=20).fit()
    np.testing.assert_allclose(got.lambda_, ref.lambda_, rtol=1e-6)
    assert got.beta.shape == ref.beta.shape == (X.shape[1] + 1, 20)
    b_ref, b_got = ref.beta.toarray(), got.beta.toarray()
    np.testing.assert_allclose(b_got[1:], b_ref[1:], atol=2e-4)
    np.testing.assert_allclose(b_got[0], b_ref[0], atol=2e-3)
    assert got.niter.shape == (20,)


def test_enet_builder_matches_reference(tall):
    X, y = tall
    ref = admm_tpu.admm_enet(X, y).penalty(alpha=0.6, nlambda=20).opts(
        path_mode="scan").fit()
    got = admm_tpu_torch.admm_enet(X, y, device="cpu").penalty(
        alpha=0.6, nlambda=20).opts(path_mode="scan").fit()
    np.testing.assert_allclose(got.lambda_, ref.lambda_, rtol=1e-6)
    np.testing.assert_allclose(got.beta.toarray(), ref.beta.toarray(),
                               atol=2e-3)
    np.testing.assert_allclose(got.beta.toarray()[1:],
                               ref.beta.toarray()[1:], atol=2e-4)


@pytest.mark.parametrize("standardize,intercept",
                         [(False, False), (True, False), (False, True)])
def test_user_lambdas_and_flags_match(tall, standardize, intercept):
    X, y = tall
    lams = np.array([0.01, 0.5, 0.1, 0.05])        # sorted descending inside
    kw = dict(lambdas=lams, standardize=standardize, intercept=intercept,
              rho=20.0)
    _assert_paths_match(admm_tpu.lasso_path(X, y, **kw),
                        admm_tpu_torch.lasso_path(X, y, device="cpu", **kw),
                        coef_atol=1e-5)


def test_weights_and_offset_match(tall, wide):
    for X, y in (tall, wide):
        rng = np.random.default_rng(23)
        w = rng.uniform(0.5, 2.0, X.shape[0])
        off = rng.normal(size=X.shape[0])
        kw = dict(nlambda=10, weights=w, offset=off, path_mode="batch")
        _assert_paths_match(admm_tpu.lasso_path(X, y, **kw),
                            admm_tpu_torch.lasso_path(X, y, device="cpu",
                                                      **kw))


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
def test_float64_engine_path_matches_reference(tall, path_mode):
    """float64 takes the generic engines on both sides."""
    import jax.numpy as jnp

    X, y = tall
    kw = dict(nlambda=10, path_mode=path_mode, rho=20.0)
    ref = admm_tpu.lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.lasso_path(X, y, device="cpu", dtype=torch.float64,
                                    **kw)
    assert got.coef.dtype == torch.float64
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-12)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=1e-9)
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(ref.niter))


def test_tensor_input_stays_on_its_device(tall):
    X, y = tall
    Xt = torch.as_tensor(X, dtype=torch.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    # The default device is "cuda"; tensors stay where they are.
    res = admm_tpu_torch.lasso_path(Xt, yt, nlambda=5)
    assert res.coef.device.type == "cpu" and res.coef.shape == (5, 15)
    fit = admm_tpu_torch.admm_lasso(Xt, yt).penalty(nlambda=5).fit()
    assert fit.beta.shape == (16, 5)


@pytest.mark.parametrize("option", [
    "penalty_factor", "lower_limits", "upper_limits", "exclude", "dfmax",
    "pmax", "trace_len", "data_mesh", "activeset", "activeset_auto",
    "adaptive_lasso_path", "builder_penalty_factor", "builder_limits",
    "builder_parallel", "builder_trace", "builder_activeset", "fit_plot",
])
def test_options_not_ported_raise(tall, wide, option, monkeypatch):
    """What is not ported raises by name; glmnet's per-coordinate options,
    dfmax/pmax, the adaptive lasso, the traced solves, the active set,
    ``.parallel()`` and ``fit.plot()`` are ported now and must run (their
    parity is ``tests/test_torch_lasso_options.py``,
    ``test_torch_trace.py``, ``test_torch_activeset.py``,
    ``test_torch_consensus.py`` and ``test_torch_plotting.py``)."""
    X, y = tall
    ones = np.ones(X.shape[1])
    path = lambda **kw: admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    builder = admm_tpu_torch.admm_lasso(X, y, device="cpu")
    # The active-set mode is the wide regime's; on tall data it raises the
    # JAX package's ValueError (tests/test_torch_api_faults.py).
    Xw, yw = wide
    calls = {
        "penalty_factor": lambda: path(penalty_factor=ones, nlambda=5),
        "lower_limits": lambda: path(lower_limits=0.0, nlambda=5),
        "upper_limits": lambda: path(upper_limits=1.0, nlambda=5),
        "exclude": lambda: path(exclude=[0], nlambda=5),
        "dfmax": lambda: path(dfmax=3, nlambda=5),
        "pmax": lambda: path(pmax=3, nlambda=5),
        "trace_len": lambda: path(trace_len=8),
        # A 4-position CPU mesh (tests/test_torch_mesh.py holds its
        # parity with the JAX package's data_mesh).
        "data_mesh": lambda: path(data_mesh=make_mesh(4, devices=["cpu"]
                                                      * 4)),
        "activeset": lambda: admm_tpu_torch.lasso_path(
            Xw, yw, path_mode="activeset", device="cpu"),
        # The scan-mode auto-dispatch, at a threshold this wide problem
        # reaches (the real one is 20000 columns).
        "activeset_auto": lambda: admm_tpu_torch.lasso_path(
            Xw, yw, nlambda=5, device="cpu"),
        "adaptive_lasso_path": lambda: admm_tpu_torch.adaptive_lasso_path(
            X, y, nlambda=5, device="cpu"),
        "builder_penalty_factor": lambda: builder.penalty(
            nlambda=5, penalty_factor=ones),
        "builder_limits": lambda: builder.penalty(nlambda=5,
                                                  lower_limits=0.0),
        "builder_parallel": lambda: builder.parallel(nthread=2),
        "builder_trace": lambda: builder.opts(trace=True),
        "builder_activeset": lambda: admm_tpu_torch.admm_lasso(
            Xw, yw, device="cpu").opts(path_mode="activeset").fit(),
        "fit_plot": lambda: builder.penalty(nlambda=3).fit().plot(),
    }
    from admm_tpu_torch.models import lasso as lasso_mod

    monkeypatch.setattr(lasso_mod, "_ACTIVESET_AUTO_P", Xw.shape[1])
    if option in _PORTED_OPTIONS:
        if option == "fit_plot":
            import matplotlib
            matplotlib.use("Agg")
            from matplotlib import pyplot as plt

            ax = calls[option]()
            assert ax.lines and all(np.isfinite(line.get_xydata()).all()
                                    for line in ax.lines)
            plt.close(ax.figure)
            return
        res = calls[option]()
        if isinstance(res, admm_tpu_torch.ADMMLasso):
            res = res.fit()
        if isinstance(res, admm_tpu_torch.ADMMLassoFit):
            coef = res.beta.toarray()
        else:
            coef = res.coef.numpy()
        assert coef.size and np.isfinite(coef).all()
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        calls[option]()


_PORTED_OPTIONS = {"penalty_factor", "lower_limits", "upper_limits",
                   "exclude", "dfmax", "pmax", "adaptive_lasso_path",
                   "builder_penalty_factor", "builder_limits", "trace_len",
                   "activeset", "activeset_auto", "builder_trace",
                   "builder_activeset", "builder_parallel", "fit_plot",
                   "data_mesh"}


def test_builder_validates_like_reference(tall):
    X, y = tall
    bad = X.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        admm_tpu_torch.admm_lasso(bad, y)
    with pytest.raises(ValueError):
        admm_tpu_torch.admm_lasso(X, y[:-1])
    with pytest.raises(ValueError):
        admm_tpu_torch.admm_lasso(X, y).penalty(lambda_=[-1.0])
    with pytest.raises(ValueError):
        admm_tpu_torch.admm_lasso(X, y).opts(maxit=0)
    with pytest.raises(ValueError):
        admm_tpu_torch.admm_enet(X, y).penalty(alpha=1.5)
    with pytest.raises(ValueError):
        admm_tpu_torch.lasso_path(X, y, path_mode="nope", device="cpu")
