"""Cross-validation in the port (``admm_tpu_torch.models.cv``) against the
JAX package's ``admm_tpu.models.cv``, with the same explicit ``foldid``
on both sides.

Same seeded numpy inputs, ``device="cpu"`` (the kernels' plain forms).
Bars: cvm and cvsd rtol 1e-4 (the JAX package's own bar between its
device and host scoring); ``lambda_min`` and ``lambda_1se`` the same grid
point (the auto grids agree to rtol 1e-6, one float32 ulp of the log);
the full fit within 1e-5 on tall data at an explicit ``rho``, within 2e-4
with auto-rho or on wide data (power iteration's start vector:
``tests/test_torch_lasso.py``).
"""
import numpy as np
import pytest
import torch

from admm_tpu.models import cv as jcv
from admm_tpu_torch import kernels
from admm_tpu_torch.kernels import tall_path, wide_path
from admm_tpu_torch.models import cv as tcv
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh

torch.set_num_threads(1)

TALL_RHO = 20.0


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[:5] = rng.uniform(1.0, 2.0, 5) * rng.choice([-1, 1], 5)
    X = rng.normal(size=(n, p))
    return X, X @ b + rng.normal(size=n)


@pytest.fixture(scope="module")
def tall():
    X, y = _problem(120, 10, 3)
    return X, y, np.arange(120) % 4


@pytest.fixture(scope="module")
def wide():
    X, y = _problem(40, 80, 4)
    return X, y, np.arange(40) % 4


@pytest.fixture(scope="module")
def binom():
    rng = np.random.default_rng(9)
    n, p = 120, 8
    X = rng.normal(size=(n, p))
    eta = 0.2 + X @ np.r_[1.5, -1.0, 0.7, np.zeros(p - 3)]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(float)
    return X, y, np.arange(n) % 3


def _index(cv, lam):
    return int(np.argmin(np.abs(np.asarray(cv.lambdas) - lam)))


def _assert_cv_match(ref, got, fit_atol):
    np.testing.assert_allclose(got.lambdas, np.asarray(ref.lambdas),
                               rtol=1e-6)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-4)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-4)
    for key in ("lambda_min", "lambda_1se"):
        assert _index(got, getattr(got, key)) == _index(ref, getattr(ref,
                                                                     key))
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=1e-6)
    np.testing.assert_array_equal(got.foldid, ref.foldid)
    np.testing.assert_allclose(got.fit.coef.numpy(), np.asarray(ref.fit.coef),
                               atol=fit_atol)
    np.testing.assert_allclose(got.fit.beta0.numpy(),
                               np.asarray(ref.fit.beta0), atol=10 * fit_atol)


def _both(fn, X, y, **kw):
    return (getattr(jcv, fn)(X, y, **kw),
            getattr(tcv, fn)(X, y, device="cpu", **kw))


@pytest.mark.parametrize("cv_mode", ["onepass", "loop"])
@pytest.mark.parametrize("regime", ["tall", "wide"])
def test_gaussian_cv_matches_reference(request, regime, cv_mode):
    X, y, foldid = request.getfixturevalue(regime)
    kw = dict(foldid=foldid, nlambda=8, cv_mode=cv_mode)
    if regime == "tall":
        kw["rho"] = TALL_RHO
    ref, got = _both("cv_lasso_path", X, y, **kw)
    _assert_cv_match(ref, got, 1e-5 if regime == "tall" else 2e-4)


def test_gaussian_cv_auto_rho_matches_reference(tall):
    X, y, foldid = tall
    ref, got = _both("cv_lasso_path", X, y, foldid=foldid, nlambda=8)
    _assert_cv_match(ref, got, 2e-4)


def test_enet_cv_matches_reference(tall):
    X, y, foldid = tall
    ref, got = _both("cv_enet_path", X, y, alpha=0.6, foldid=foldid,
                     nlambda=8, rho=TALL_RHO)
    _assert_cv_match(ref, got, 1e-5)


def test_default_folds_equal_reference(tall):
    """No foldid: glmnet's round-robin over a permutation, drawn from
    ``np.random.default_rng(seed)`` exactly as the JAX package does."""
    X, y, _ = tall
    for n, nfolds, seed in ((120, 5, 0), (121, 4, 7), (10, 3, 2)):
        ref, _ = jcv._cv_foldid(n, nfolds, seed, None)
        got, nf = tcv._cv_foldid(n, nfolds, seed, None)
        np.testing.assert_array_equal(got, ref)
        assert nf == nfolds
    ref, got = _both("cv_lasso_path", X, y, nfolds=5, seed=1, nlambda=6,
                     rho=TALL_RHO)
    _assert_cv_match(ref, got, 1e-5)


def test_ragged_folds_and_train_only_rows(tall):
    X, y, _ = tall
    foldid = np.arange(120) % 7            # 120 = 7 * 17 + 1: ragged
    foldid[110:] = -1                      # trains every fold, never scored
    for mode in ("onepass", "loop"):
        ref, got = _both("cv_lasso_path", X, y, foldid=foldid, nlambda=6,
                         cv_mode=mode, rho=TALL_RHO)
        _assert_cv_match(ref, got, 1e-5)


@pytest.mark.parametrize("cv_mode", ["onepass", "loop"])
def test_weighted_cv_matches_reference(tall, cv_mode):
    X, y, foldid = tall
    w = np.random.default_rng(0).uniform(0.2, 3.0, X.shape[0])
    ref, got = _both("cv_lasso_path", X, y, foldid=foldid, nlambda=6,
                     weights=w, cv_mode=cv_mode, rho=TALL_RHO)
    _assert_cv_match(ref, got, 1e-5)


@pytest.mark.parametrize("option", ["penalty_factor", "lower_limits",
                                    "exclude"])
def test_options_reach_the_folds(tall, option):
    X, y, foldid = tall
    pf = np.ones(X.shape[1])
    pf[0], pf[5] = 0.3, 2.0
    kw = {"penalty_factor": dict(penalty_factor=pf),
          "lower_limits": dict(lower_limits=0.0),
          "exclude": dict(exclude=[2])}[option]
    ref, got = _both("cv_lasso_path", X, y, foldid=foldid, nlambda=6,
                     rho=TALL_RHO, **kw)
    _assert_cv_match(ref, got, 1e-5)
    loop = tcv.cv_lasso_path(X, y, foldid=foldid, nlambda=6, rho=TALL_RHO,
                             cv_mode="loop", device="cpu", **kw)
    np.testing.assert_allclose(loop.cvm, got.cvm, rtol=1e-4, atol=1e-5)


def test_gaussian_offset_is_a_response_shift(tall):
    X, y, foldid = tall
    off = np.random.default_rng(4).normal(size=y.shape[0])
    ref, got = _both("cv_lasso_path", X, y, offset=off, foldid=foldid,
                     nlambda=6, rho=TALL_RHO)
    _assert_cv_match(ref, got, 1e-5)
    shifted = tcv.cv_lasso_path(X, y - off, foldid=foldid, nlambda=6,
                                rho=TALL_RHO, device="cpu")
    np.testing.assert_allclose(got.cvm, shifted.cvm, rtol=1e-6)


@pytest.mark.parametrize("measure", ["mse", "mae", "deviance"])
def test_gaussian_type_measures(tall, measure):
    X, y, foldid = tall
    ref, got = _both("cv_lasso_path", X, y, foldid=foldid, nlambda=6,
                     rho=TALL_RHO, type_measure=measure)
    _assert_cv_match(ref, got, 1e-5)


def test_keep_returns_prevalidated_predictors(tall):
    """keep=True: the (n, nlambda) out-of-fold predictors, host-scored;
    scoring them again reproduces cvm (with the offset carried)."""
    X, y, foldid = tall
    off = np.linspace(-1.0, 1.0, y.shape[0])
    ref, got = _both("cv_lasso_path", X, y, foldid=foldid, nlambda=6,
                     rho=TALL_RHO, keep=True, offset=off)
    _assert_cv_match(ref, got, 1e-5)
    assert got.fit_preval.shape == (120, 6)
    np.testing.assert_allclose(got.fit_preval, ref.fit_preval, atol=1e-4)
    cvm = ((got.fit_preval - y[:, None]) ** 2).mean(axis=0)
    np.testing.assert_allclose(cvm, got.cvm, rtol=1e-6)


def test_device_scoring_matches_host_formula(tall):
    """The one-pass gaussian scoring on the device (float32) against the
    host's float64 formula on the same predictors: rtol 1e-4."""
    X, y, foldid = tall
    dev = tcv.cv_lasso_path(X, y, foldid=foldid, nlambda=6, rho=TALL_RHO,
                            device="cpu")
    host = tcv.cv_lasso_path(X, y, foldid=foldid, nlambda=6, rho=TALL_RHO,
                             keep=True, device="cpu")
    np.testing.assert_allclose(dev.cvm, host.cvm, rtol=1e-4)
    np.testing.assert_allclose(dev.cvsd, host.cvsd, rtol=1e-4)
    for kind in ("mse", "mae"):
        eta = torch.as_tensor(host.fit_preval, dtype=torch.float32)
        yt = torch.as_tensor(y, dtype=torch.float32)
        ws = torch.ones(y.shape[0])
        got = tcv._score_reduce_dev(eta, yt, ws, torch.tensor(120.0), kind)
        err = (host.fit_preval - y[:, None]) ** 2 if kind == "mse" else \
            np.abs(host.fit_preval - y[:, None])
        cvm, cvsd = tcv._cv_curve(err, foldid)
        np.testing.assert_allclose(got.numpy(), np.stack([cvm, cvsd]),
                                   rtol=1e-4)


@pytest.mark.parametrize("path_mode,first", [("batch", "tall_path_batch"),
                                             ("scan", "tall_path_scan")])
def test_each_fold_is_one_batch_kernel_call(tall, monkeypatch, path_mode,
                                            first):
    """The full fit follows path_mode; every fold solves all lambdas at
    once: one call of the batch wrapper per fold (on the card, one launch
    each)."""
    X, y, foldid = tall
    calls = []
    for name in ("tall_path_batch", "tall_path_scan"):
        real = getattr(tall_path, name)
        monkeypatch.setattr(tall_path, name, lambda *a, _r=real, _n=name,
                            **k: calls.append(_n) or _r(*a, **k))
    tcv.cv_lasso_path(X, y, foldid=foldid, nlambda=6, path_mode=path_mode,
                      device="cpu")
    assert calls == [first] + ["tall_path_batch"] * 4


def test_wide_folds_call_the_wide_batch_kernel(wide, monkeypatch):
    X, y, foldid = wide
    calls = []
    real = wide_path.wide_path_batch
    monkeypatch.setattr(wide_path, "wide_path_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tcv.cv_lasso_path(X, y, foldid=foldid, nlambda=6, device="cpu")
    assert len(calls) == 5


def test_logistic_cv_matches_reference(binom):
    X, y, foldid = binom
    ref, got = _both("cv_logistic_path", X, y, foldid=foldid, nlambda=6)
    _assert_cv_match(ref, got, 1e-5)


@pytest.mark.parametrize("measure", ["class", "auc", "mse", "mae",
                                     "deviance"])
def test_binomial_type_measures(binom, measure):
    X, y, foldid = binom
    ref, got = _both("cv_logistic_path", X, y, foldid=foldid, nlambda=6,
                     type_measure=measure)
    _assert_cv_match(ref, got, 1e-5)


def test_glm_cv_huber_and_weights_match_reference(tall):
    X, y, foldid = tall
    from admm_tpu.models.glm import huber as jhuber
    from admm_tpu_torch.models.glm import huber as thuber
    w = np.random.default_rng(5).uniform(0.5, 2.0, y.shape[0])
    ref = jcv.cv_glm_path(X, y, jhuber(1.0), foldid=foldid, nlambda=6,
                          weights=w)
    got = tcv.cv_glm_path(X, y, thuber(1.0), foldid=foldid, nlambda=6,
                          weights=w, device="cpu")
    _assert_cv_match(ref, got, 1e-5)


def test_glm_cv_options_and_offset_match_reference(binom):
    X, y, foldid = binom
    off = np.linspace(-0.5, 0.5, y.shape[0])
    kw = dict(foldid=foldid, nlambda=6, offset=off, lower_limits=-1.0,
              penalty_factor=np.r_[0.5, np.ones(X.shape[1] - 1)])
    from admm_tpu.models.glm import binomial as jb
    from admm_tpu_torch.models.glm import binomial as tb
    ref = jcv.cv_glm_path(X, y, jb(), **kw)
    got = tcv.cv_glm_path(X, y, tb(), device="cpu", **kw)
    _assert_cv_match(ref, got, 1e-5)


def test_dantzig_cv_matches_reference(tall):
    X, y, foldid = tall
    ref, got = _both("cv_dantzig_path", X, y, foldid=foldid, nlambda=6)
    _assert_cv_match(ref, got, 1e-5)


@pytest.mark.parametrize("case", [
    "nfolds_one", "nfolds_past_n", "foldid_shape", "empty_fold",
    "weights_shape", "offset_shape", "cv_mode", "measure_auc_gaussian",
    "measure_unknown", "measure_class_huber", "glm_offset_loop",
])
def test_validation_errors_match_reference(tall, case):
    X, y, _ = tall
    bad = np.zeros(120, np.int64)
    bad[0] = 5
    calls = {
        "nfolds_one": ("cv_lasso_path", dict(nfolds=1)),
        "nfolds_past_n": ("cv_lasso_path", dict(nfolds=121)),
        "foldid_shape": ("cv_lasso_path", dict(foldid=np.arange(10) % 2)),
        "empty_fold": ("cv_lasso_path", dict(foldid=bad)),
        "weights_shape": ("cv_lasso_path", dict(weights=np.ones(3))),
        "offset_shape": ("cv_lasso_path", dict(offset=np.ones(3))),
        "cv_mode": ("cv_lasso_path", dict(cv_mode="vmap")),
        "measure_auc_gaussian": ("cv_lasso_path", dict(type_measure="auc")),
        "measure_unknown": ("cv_lasso_path", dict(type_measure="banana")),
        "measure_class_huber": ("huber", dict(type_measure="class")),
        "glm_offset_loop": ("huber", dict(offset=np.ones(120),
                                          cv_mode="loop")),
    }
    fn, kw = calls[case]

    def call(mod, glm, **extra):
        if fn == "huber":
            return mod.cv_glm_path(X, y, glm.huber(), nlambda=3, **kw,
                                   **extra)
        return getattr(mod, fn)(X, y, nlambda=3, **kw, **extra)

    from admm_tpu.models import glm as jglm
    from admm_tpu_torch.models import glm as tglm
    with pytest.raises(ValueError) as ref:
        call(jcv, jglm)
    with pytest.raises(ValueError) as got:
        call(tcv, tglm, device="cpu")
    assert str(got.value) == str(ref.value)


def test_fold_mesh_is_not_ported(tall):
    """``fold_mesh`` deals the folds over a mesh's positions: each CV on a
    2-position CPU mesh is its CV without one, to the bit
    (``tests/test_torch_mesh_cv.py`` holds it against the JAX
    package's)."""
    X, y, foldid = tall
    mesh = torch_mesh(2, devices=["cpu"] * 2)
    for fn in (tcv.cv_lasso_path, tcv.cv_logistic_path,
               tcv.cv_dantzig_path):
        got = fn(X, y, foldid=foldid, nlambda=3, fold_mesh=mesh,
                 device="cpu")
        ref = fn(X, y, foldid=foldid, nlambda=3, device="cpu")
        np.testing.assert_array_equal(got.cvm, ref.cvm)
        assert got.lambda_min == ref.lambda_min


def test_no_launch_is_counted_on_the_cpu(tall):
    X, y, foldid = tall
    kernels.reset_launch_counts()
    tcv.cv_lasso_path(X, y, foldid=foldid, nlambda=4, device="cpu")
    assert not any(kernels.launch_counts().values())
