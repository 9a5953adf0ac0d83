"""The port's glmnet front end (``admm_tpu_torch.glmnet``: ``glmnet``,
``cv_glmnet``, ``big_glm``) against the JAX package's, on the same seeded
numpy inputs and ``device="cpu"``, for every family string, a
``GLMFamily`` object and factory, ``relax=True``, glmnet's ``Surv``-style
Cox responses, and the front end's errors.

The front end adds no work: each result is its family driver's, so the
port's is held to the driver's own result on the same inputs to the bit,
and to the JAX package's within 1e-6 in float64 (rtol 1e-7; cvm rtol
1e-6 and ``lambda_min`` at the same grid index), at an explicit rho for
the gaussian paths (20: the tall paths meet 1e-5 against the JAX package
only at an explicit rho).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch as t
from admm_tpu_torch.interop import to_numpy

from _torch_parity import assert_cv_close

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    n, p = 120, 8
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:3] = [1.0, -1.0, 0.5]
    eta = X @ b
    tt = np.round(rng.exponential(np.exp(-eta)), 1) + 0.05
    ev = (rng.random(n) < 0.7) * 1.0
    return X, {
        "gaussian": eta + rng.normal(size=n),
        "binomial": (rng.random(n) < 1 / (1 + np.exp(-eta))) * 1.0,
        "poisson": rng.poisson(np.exp(0.3 * eta)) * 1.0,
        "multinomial": rng.integers(0, 3, n),
        "mgaussian": np.c_[eta + rng.normal(size=n),
                           0.5 * eta + rng.normal(size=n)],
        "surv": np.c_[tt, ev],
        "surv3": np.c_[tt * rng.uniform(0, 0.5, n), tt, ev],
    }


# (label, family, response key, glmnet keywords)
CASES = [
    ("gaussian", "gaussian", "gaussian", {"rho": 20.0}),
    ("enet", "gaussian", "gaussian", {"alpha": 0.5, "rho": 20.0}),
    ("binomial", "binomial", "binomial", {}),
    ("poisson", "poisson", "poisson", {}),
    ("huber", "huber", "gaussian", {}),
    ("multinomial", "multinomial", "multinomial", {}),
    ("multinomial_grouped", "multinomial", "multinomial",
     {"type_multinomial": "grouped"}),
    ("mgaussian", "mgaussian", "mgaussian", {}),
    ("cox", "cox", "surv", {}),
    ("cox_start_stop", "cox", "surv3", {}),
    ("probit_factory", "probit", "binomial", {}),
    ("probit_instance", "probit()", "binomial", {}),
]


def _family(name, pkg):
    if name == "probit":
        return pkg.binomial_probit
    if name == "probit()":
        return pkg.binomial_probit()
    return name


def _coef(res):
    return np.asarray(to_numpy(res.coef))


def _driver(fam, X, y, kw, cv=False):
    """The port's family driver called directly, as the front end must."""
    if fam == "gaussian":
        if kw.get("alpha", 1.0) != 1.0:
            return (t.cv_enet_path if cv else t.enet_path)(X, y, **kw)
        kw = {k: v for k, v in kw.items() if k != "alpha"}
        return (t.cv_lasso_path if cv else t.lasso_path)(X, y, **kw)
    if fam == "binomial":
        return (t.cv_glm_path(X, y, t.binomial(), **kw) if cv
                else t.logistic_lasso_path(X, y, **kw))
    if fam == "cox":
        args = ((y[:, 0], y[:, 1]) if y.shape[1] == 2
                else (y[:, 1], y[:, 2]))
        if y.shape[1] == 3:
            kw = dict(kw, start=y[:, 0])
        return (t.cv_cox_path if cv else t.cox_lasso_path)(X, *args, **kw)
    return None


@pytest.mark.parametrize("label,fam,key,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_glmnet_matches_jax_for_every_family(data, label, fam, key, kw):
    X, ys = data
    y = ys[key]
    got = t.glmnet(X, y, _family(fam, t), nlambda=5, **kw, **F64)
    ref = admm_tpu.glmnet(X, y, _family(fam, admm_tpu), nlambda=5,
                          dtype=jnp.float64, **kw)
    assert type(got).__name__ == type(ref).__name__
    np.testing.assert_allclose(_coef(got), np.asarray(ref.coef), atol=1e-6,
                               rtol=1e-7)
    np.testing.assert_allclose(np.asarray(to_numpy(got.lambdas)),
                               np.asarray(ref.lambdas), rtol=1e-6)
    own = _driver(fam, X, y, dict(nlambda=5, **kw, **F64))
    if own is not None:
        np.testing.assert_array_equal(_coef(got), _coef(own))


def test_glmnet_cox_time_event_keywords_equal_surv_y(data):
    X, ys = data
    tt, ev = ys["surv"][:, 0], ys["surv"][:, 1]
    a = t.glmnet(X, family="cox", time=tt, event=ev, nlambda=4, **F64)
    b = t.glmnet(X, ys["surv"], "cox", nlambda=4, **F64)
    np.testing.assert_array_equal(_coef(a), _coef(b))


def test_glmnet_relax_matches_jax(data):
    X, ys = data
    kw = dict(nlambda=5, rho=20.0)
    got = t.glmnet(X, ys["gaussian"], relax=True, **kw, **F64)
    ref = admm_tpu.glmnet(X, ys["gaussian"], relax=True, dtype=jnp.float64,
                          **kw)
    np.testing.assert_allclose(_coef(got), np.asarray(ref.coef), atol=1e-6)
    np.testing.assert_array_equal(
        _coef(got), _coef(t.relaxed_lasso_path(X, ys["gaussian"], **kw,
                                               **F64)))


CV_CASES = [c for c in CASES if c[0] in (
    "gaussian", "enet", "binomial", "poisson", "multinomial", "mgaussian",
    "cox", "probit_factory")]


@pytest.mark.parametrize("label,fam,key,kw", CV_CASES,
                         ids=[c[0] for c in CV_CASES])
def test_cv_glmnet_matches_jax(data, label, fam, key, kw):
    X, ys = data
    y = ys[key]
    cv_kw = dict(nlambda=5, nfolds=3, **kw)
    got = t.cv_glmnet(X, y, _family(fam, t), **cv_kw, **F64)
    ref = admm_tpu.cv_glmnet(X, y, _family(fam, admm_tpu),
                             dtype=jnp.float64, **cv_kw)
    np.testing.assert_array_equal(got.foldid, ref.foldid)
    assert_cv_close(got, ref, rtol=1e-6)
    np.testing.assert_allclose(_coef(got.fit), np.asarray(ref.fit.coef),
                               atol=1e-6, rtol=1e-7)
    own = _driver(fam, X, y, dict(cv_kw, **F64), cv=True)
    if own is not None:
        np.testing.assert_array_equal(got.cvm, own.cvm)


def test_cv_glmnet_relax_matches_jax(data):
    X, ys = data
    kw = dict(nlambda=5, nfolds=3, rho=20.0)
    got = t.cv_glmnet(X, ys["gaussian"], relax=True, **kw, **F64)
    ref = admm_tpu.cv_glmnet(X, ys["gaussian"], relax=True,
                             dtype=jnp.float64, **kw)
    np.testing.assert_allclose(got["cvm"], np.asarray(ref["cvm"]),
                               rtol=1e-6)
    assert got["lambda_min"] == pytest.approx(ref["lambda_min"], rel=1e-6)


BIG_CASES = [c for c in CASES if c[0] in (
    "gaussian", "binomial", "poisson", "huber", "multinomial", "mgaussian",
    "cox", "probit_instance")]


@pytest.mark.parametrize("label,fam,key,kw", BIG_CASES,
                         ids=[c[0] for c in BIG_CASES])
def test_big_glm_matches_jax(data, label, fam, key, kw):
    X, ys = data
    y = ys[key]
    extra = {"lower_limits": -0.5} if fam in ("gaussian", "cox") else {}
    got = t.big_glm(X, y, _family(fam, t), **extra, **F64)
    ref = admm_tpu.big_glm(X, y, _family(fam, admm_tpu), dtype=jnp.float64,
                           **extra)
    assert np.asarray(to_numpy(got.lambdas)).tolist() == [0.0]
    np.testing.assert_allclose(_coef(got), np.asarray(ref.coef), atol=1e-6,
                               rtol=1e-7)


@pytest.mark.parametrize("call", [
    lambda X, y, pkg: pkg.glmnet(X, y["gaussian"], "gamma"),
    lambda X, y, pkg: pkg.glmnet(X, y["binomial"], "binomial", relax=True),
    lambda X, y, pkg: pkg.glmnet(X, y["binomial"], pkg.binomial_probit(),
                                 relax=True),
    lambda X, y, pkg: pkg.glmnet(X, y["multinomial"], "multinomial",
                                 type_multinomial="both"),
    lambda X, y, pkg: pkg.glmnet(X, y["gaussian"], "cox"),
    lambda X, y, pkg: pkg.glmnet(X, family="cox", time=y["surv"][:, 0]),
    lambda X, y, pkg: pkg.glmnet(X, y["gaussian"], lambda: "binomial"),
    lambda X, y, pkg: pkg.cv_glmnet(X, y["gaussian"], "gamma"),
    lambda X, y, pkg: pkg.cv_glmnet(X, y["poisson"], "poisson", relax=True),
    lambda X, y, pkg: pkg.big_glm(X, y["multinomial"], "multinomial",
                                  upper_limits=1.0),
], ids=["family", "relax", "relax_object", "type_multinomial", "surv_y",
        "time_without_event", "bad_factory", "cv_family", "cv_relax",
        "big_glm_limits"])
def test_front_end_errors_match_jax(data, call):
    X, ys = data
    with pytest.raises(ValueError) as got:
        call(X, ys, t)
    with pytest.raises(ValueError) as ref:
        call(X, ys, admm_tpu)
    assert str(got.value).split("(")[0] == str(ref.value).split("(")[0]
