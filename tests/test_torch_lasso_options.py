"""glmnet's per-coordinate Lasso options in the port, against the JAX
package: ``penalty_factor``, ``lower_limits``/``upper_limits``,
``exclude``, ``dfmax``/``pmax``, the adaptive lasso and the builders'
``.penalty(...)``.

The same seeded numpy inputs go through ``admm_tpu`` and
``admm_tpu_torch`` (``device="cpu"``).  Bars: lambda grids rtol 1e-6;
tall paths at an explicit ``rho`` within 1e-5 and ``niter`` within 1 per
lambda; with auto-rho, and in the wide regime, within 2e-4 and ``niter``
within a few iterations at eps 1e-7 (the two
packages draw power iteration's start vector from different generators,
so sprad, hence rho and the wide step size, differ in the last bits:
``tests/test_torch_lasso.py``).  A factor or a box takes the engine: no
kernel wrapper may be called, and no launch counted.
"""
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch import kernels
from admm_tpu_torch.kernels import tall_path, wide_path

torch.set_num_threads(1)


def _regression(n, p, seed, k=4, noise=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:k] = [1.5, -2.0, 1.0, 0.5][:k]
    return X, X @ b + noise * rng.normal(size=n), rng


@pytest.fixture(scope="module")
def tall():
    return _regression(120, 10, 31)[:2]


@pytest.fixture(scope="module")
def wide():
    return _regression(40, 80, 33)[:2]


def _match(ref, got, atol, niter_gap=1):
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-6)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=atol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=10 * atol)
    assert np.abs(got.niter.numpy() - np.asarray(ref.niter)).max() \
        <= niter_gap


@pytest.fixture
def kernel_spy(monkeypatch):
    """Records every call of the Lasso kernel wrappers (on the CPU their
    plain forms run and count no launch, so the calls are what tells the
    engine from a kernel)."""
    calls = []
    for mod, name in ((tall_path, "tall_path_batch"),
                      (tall_path, "tall_path_scan"),
                      (wide_path, "wide_path_batch"),
                      (wide_path, "wide_path_scan")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    kernels.reset_launch_counts()
    return calls


_OPTIONS = {
    "penalty_factor": lambda p, rng: dict(
        penalty_factor=rng.uniform(0.5, 3.0, p)),
    "zero_factor": lambda p, rng: dict(
        penalty_factor=np.r_[1.0, 0.0, np.ones(p - 2)]),
    "lower_limits": lambda p, rng: dict(lower_limits=0.0),
    "box": lambda p, rng: dict(lower_limits=-0.4,
                               upper_limits=np.r_[0.5, np.full(p - 1, 9.0)]),
    "exclude": lambda p, rng: dict(exclude=[1, 3]),
    "factor_and_box": lambda p, rng: dict(
        penalty_factor=rng.uniform(0.5, 3.0, p), upper_limits=0.5),
}


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_tall_options_match_reference_on_the_engine(tall, option, path_mode,
                                                    kernel_spy):
    X, y = tall
    kw = dict(nlambda=8, path_mode=path_mode, rho=20.0,
              **_OPTIONS[option](X.shape[1], np.random.default_rng(7)))
    ref = admm_tpu.lasso_path(X, y, **kw)
    got = admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    _match(ref, got, atol=1e-5)
    assert kernel_spy == [] and not any(kernels.launch_counts().values())


@pytest.mark.parametrize("path_mode", ["scan", "batch"])
@pytest.mark.parametrize("option", ["penalty_factor", "zero_factor",
                                    "lower_limits", "exclude"])
def test_wide_options_match_reference_on_the_engine(wide, option, path_mode,
                                                    kernel_spy):
    X, y = wide
    kw = dict(nlambda=6, path_mode=path_mode,
              **_OPTIONS[option](X.shape[1], np.random.default_rng(7)))
    ref = admm_tpu.lasso_path(X, y, **kw)
    got = admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    _match(ref, got, atol=2e-4, niter_gap=2)
    assert kernel_spy == [] and not any(kernels.launch_counts().values())


@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_without_options_the_kernel_wrappers_run(request, regime,
                                                 kernel_spy):
    """The spy's positive control: the plain path reaches a wrapper."""
    X, y = request.getfixturevalue(regime)
    admm_tpu_torch.lasso_path(X, y, nlambda=4, path_mode="batch",
                              device="cpu")
    assert kernel_spy == [f"{regime}_path_batch"]


@pytest.mark.parametrize("n,p", [(200, 12), (60, 120)])
def test_penalty_factor_transform_equivalence(n, p):
    """Penalizing pf_j |b_j| is the column rescaling x_j -> x_j / pf_j
    with a uniform penalty (after glmnet's sum-to-p rescaling); the port
    holds it and matches the JAX package's factor path."""
    X, y, rng = _regression(n, p, 31 + p)
    pf = rng.uniform(0.5, 3.0, p)
    pf_t = pf * p / pf.sum()
    kw = dict(lambdas=np.array([0.3, 0.1, 0.03]), standardize=False,
              intercept=False, eps_abs=1e-7, eps_rel=1e-7)
    a = admm_tpu_torch.lasso_path(X, y, penalty_factor=pf, device="cpu",
                                  **kw)
    u = admm_tpu_torch.lasso_path(X / pf_t[None, :], y, device="cpu", **kw)
    np.testing.assert_allclose(a.coef.numpy(), u.coef.numpy() / pf_t[None, :],
                               atol=2e-4)
    ref = admm_tpu.lasso_path(X, y, penalty_factor=pf, **kw)
    np.testing.assert_allclose(a.coef.numpy(), np.asarray(ref.coef),
                               atol=2e-4)


def test_penalty_factor_units_and_zeros():
    X, y, rng = _regression(150, 10, 32, k=1)
    p = X.shape[1]
    t = lambda **kw: admm_tpu_torch.lasso_path(X, y, nlambda=6,
                                               device="cpu", **kw)
    a, b = t(), t(penalty_factor=np.ones(p))
    # All-ones factors are no factors; glmnet rescales to sum p.
    np.testing.assert_allclose(a.lambdas.numpy(), b.lambdas.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(a.coef.numpy(), b.coef.numpy(), atol=1e-6)
    c = t(penalty_factor=7.0 * np.ones(p))
    np.testing.assert_allclose(b.coef.numpy(), c.coef.numpy(), atol=1e-6)
    # A zero factor leaves coordinate 3 unpenalized, in the model at the
    # grid top; the grid's top is the factor-aware boundary, as in JAX.
    pf = np.ones(p)
    pf[3] = 0.0
    yz = X @ np.r_[0.5, 0, 0, 2.0, np.zeros(p - 4)] + 0.1 * rng.normal(
        size=X.shape[0])
    kw = dict(nlambda=6, penalty_factor=pf)
    for rho, atol, niter_gap in ((-1.0, 2e-4, 4), (20.0, 1e-5, 1)):
        r = admm_tpu_torch.lasso_path(X, yz, rho=rho, device="cpu", **kw)
        ref = admm_tpu.lasso_path(X, yz, rho=rho, **kw)
        _match(ref, r, atol, niter_gap)
        coef0 = r.coef.numpy()[0]
        assert abs(coef0[3]) > 0.5
        assert np.abs(np.delete(coef0, 3)).max() < 0.3


def test_penalty_factor_wide_zero_factor_no_early_exit():
    """Wide with a zero factor: the all-zero early exit is off (lambda0
    is +inf), so the unpenalized coordinate is fitted at the grid top."""
    rng = np.random.default_rng(33)
    n, p = 50, 100
    X = rng.normal(size=(n, p))
    y = X[:, 7] * 3.0 + 0.1 * rng.normal(size=n)
    pf = np.ones(p)
    pf[7] = 0.0
    kw = dict(nlambda=5, penalty_factor=pf, standardize=False,
              intercept=False, eps_abs=1e-6, eps_rel=1e-6)
    for path_mode in ("scan", "batch"):
        r = admm_tpu_torch.lasso_path(X, y, path_mode=path_mode,
                                      device="cpu", **kw)
        assert abs(r.coef.numpy()[0, 7]) > 1.0
        ref = admm_tpu.lasso_path(X, y, path_mode=path_mode, **kw)
        np.testing.assert_allclose(r.coef.numpy(), np.asarray(ref.coef),
                                   atol=2e-4)


def test_limits_validation_and_wide_regime():
    X, y, _ = _regression(60, 120, 82, noise=0.1)
    n, p = X.shape
    kw = dict(nlambda=6, lower_limits=0.0, standardize=False,
              intercept=False, eps_abs=1e-7, eps_rel=1e-7)
    r = admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    ref = admm_tpu.lasso_path(X, y, **kw)
    np.testing.assert_allclose(r.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-6)
    np.testing.assert_allclose(r.coef.numpy(), np.asarray(ref.coef),
                               atol=2e-4)
    c = r.coef.numpy()
    assert np.all(c >= -1e-6)
    # The one-sided KKT conditions of the nonnegative lasso.
    lam = float(r.lambdas[3])
    g = X.T @ (X @ c[3] - y) / n
    act = c[3] > 1e-6
    np.testing.assert_allclose(g[act], -lam * np.ones(act.sum()), atol=5e-4)
    assert np.all(g[~act] + lam >= -5e-4)
    up = np.full(p, np.inf)
    up[0] = 0.5
    r2 = admm_tpu_torch.lasso_path(X, y, nlambda=4, lower_limits=0.0,
                                   upper_limits=up, standardize=False,
                                   intercept=False, device="cpu")
    assert r2.coef.numpy()[:, 0].max() <= 0.5 + 1e-6


@pytest.mark.parametrize("kw", [
    dict(lower_limits=1.0), dict(upper_limits=-0.5),
    dict(penalty_factor=np.ones(3)), dict(penalty_factor=-np.ones(10)),
    dict(penalty_factor=np.zeros(10)), dict(exclude=[10]),
    dict(dfmax=0, penalty_factor=np.r_[0.0, np.ones(9)]),
], ids=["lower_positive", "upper_negative", "pf_shape", "pf_negative",
        "pf_all_zero", "exclude_range", "dfmax_zero"])
def test_option_errors_match_reference(tall, kw):
    X, y = tall
    with pytest.raises(ValueError) as ref:
        admm_tpu.lasso_path(X, y, nlambda=3, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.lasso_path(X, y, nlambda=3, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("limit", [dict(dfmax=3), dict(pmax=4),
                                   dict(dfmax=5, pmax=5)],
                         ids=["dfmax", "pmax", "both"])
def test_dfmax_pmax_truncate_like_reference(tall, limit):
    X, y = tall
    kw = dict(nlambda=12, rho=20.0, path_mode="batch", **limit)
    ref = admm_tpu.lasso_path(X, y, **kw)
    got = admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    assert got.coef.shape == np.asarray(ref.coef).shape
    assert got.coef.shape[0] < 12
    _match(ref, got, atol=1e-5)


def test_adaptive_lasso():
    """Two stages: the float64 OLS init (torch.linalg.solve against the
    JAX package's numpy), then the factor path; the port's result equals
    its own manual two-stage and the JAX package's adaptive path."""
    rng = np.random.default_rng(17)
    n, p = 300, 12
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:3] = [3.0, -2.0, 1.5]
    y = X @ b + 0.5 * rng.normal(size=n)
    res = admm_tpu_torch.adaptive_lasso_path(X, y, nlambda=20, rho=20.0,
                                             dtype=torch.float64,
                                             device="cpu")
    b0 = np.linalg.lstsq(X - X.mean(0), y - y.mean(), rcond=None)[0]
    man = admm_tpu_torch.lasso_path(X, y, penalty_factor=1.0 / np.abs(b0),
                                    nlambda=20, rho=20.0,
                                    dtype=torch.float64, device="cpu")
    assert np.abs(res.coef.numpy() - man.coef.numpy()).max() < 1e-8
    import jax.numpy as jnp
    ref = admm_tpu.adaptive_lasso_path(X, y, nlambda=20, rho=20.0,
                                       dtype=jnp.float64)
    np.testing.assert_allclose(res.coef.numpy(), np.asarray(ref.coef),
                               atol=1e-8)
    assert np.abs(res.niter.numpy() - np.asarray(ref.niter)).max() <= 1
    supports = [tuple(np.flatnonzero(c)) for c in res.coef.numpy()]
    assert (0, 1, 2) in supports


@pytest.mark.parametrize("init", ["ridge", "vector", "weighted_ols"])
def test_adaptive_lasso_inits_match_reference(tall, init):
    X, y = tall
    w = np.random.default_rng(3).uniform(0.5, 2.0, X.shape[0])
    kw = {"ridge": dict(init="ridge", init_ridge=1e-2),
          "vector": dict(init=np.linspace(-1.0, 1.0, X.shape[1])),
          "weighted_ols": dict(init="ols", gamma=0.5, weights=w)}[init]
    kw.update(nlambda=6, rho=20.0)
    ref = admm_tpu.adaptive_lasso_path(X, y, **kw)
    got = admm_tpu_torch.adaptive_lasso_path(X, y, device="cpu", **kw)
    _match(ref, got, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(init=np.ones(5)), "one entry"),
    (dict(init="newton"), "init must be"),
], ids=["init_shape", "init_name"])
def test_adaptive_lasso_validation(tall, kw, match):
    X, y = tall
    with pytest.raises(ValueError, match=match):
        admm_tpu_torch.adaptive_lasso_path(X, y, device="cpu", **kw)


def test_adaptive_lasso_ols_needs_tall():
    X, y = _regression(8, 12, 5)[:2]
    with pytest.raises(ValueError, match="n > p"):
        admm_tpu_torch.adaptive_lasso_path(X, y, init="ols", device="cpu")


@pytest.mark.parametrize("builder", ["admm_lasso", "admm_enet"])
def test_builders_take_penalty_factor_and_limits(tall, builder, kernel_spy):
    X, y = tall
    pf = np.linspace(0.5, 2.0, X.shape[1])
    kw = dict(nlambda=6, penalty_factor=pf, lower_limits=-0.5,
              **({"alpha": 0.7} if builder == "admm_enet" else {}))
    ref = getattr(admm_tpu, builder)(X, y).penalty(**kw).opts(
        rho=20.0).fit()
    got = getattr(admm_tpu_torch, builder)(X, y, device="cpu").penalty(
        **kw).opts(rho=20.0).fit()
    np.testing.assert_allclose(got.lambda_, ref.lambda_, rtol=1e-6)
    np.testing.assert_allclose(got.beta.toarray(), ref.beta.toarray(),
                               atol=1e-5)
    assert np.abs(got.niter - ref.niter).max() <= 1
    assert kernel_spy == [] and not any(kernels.launch_counts().values())


def test_dantzig_builder_refuses_options_as_reference(tall):
    X, y = tall
    with pytest.raises(NotImplementedError) as ref:
        admm_tpu.admm_dantzig(X, y).penalty(lower_limits=0.0).fit()
    with pytest.raises(NotImplementedError) as got:
        admm_tpu_torch.admm_dantzig(X, y, device="cpu").penalty(
            lower_limits=0.0).fit()
    assert str(got.value) == str(ref.value)
