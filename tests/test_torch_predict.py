"""``predict``/``coef``, the path summary and ``assess``/``roc``/
``confusion``/``c_index`` in the port, against the JAX package.

Both packages get the SAME fitted result: a path fitted by ``admm_tpu``
and carried into the port's ``PathResult`` by
``admm_tpu_torch.interop.from_reference`` (a CV result keeps its numpy
fields and gets the converted fit), so what is compared is the
post-processing alone.  Both compute in float64, the port on the device
of the fit's coefficients (here the CPU), and the bar is rtol 1e-12 (atol 1e-15: the probit link is torch's ``ndtr`` in the
port and JAX's in the reference, which differ by 3e-17 near 0).  One
case also predicts from a fit of the port's own.
"""
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models import glm as jglm
from admm_tpu_torch.interop import from_reference
from admm_tpu_torch.models import glm as tglm
from admm_tpu_torch.models.cv import CVResult
from admm_tpu_torch.predict import _predict

torch.set_num_threads(1)
RTOL = 1e-12


def _port(ref):
    """The port's form of a JAX-package path or CV result."""
    if hasattr(ref, "lambda_1se"):
        return CVResult(**{**ref._asdict(), "fit": from_reference(ref.fit)})
    return from_reference(ref)


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(0)
    n, p = 120, 10
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:3] = [2.0, -1.0, 0.5]
    y = 1.0 + X @ b + 0.3 * rng.normal(size=n)
    res = admm_tpu.lasso_path(X, y, nlambda=8)
    return X, y, res, _port(res)


@pytest.fixture(scope="module")
def binom():
    rng = np.random.default_rng(3)
    n, p = 150, 8
    X = rng.normal(size=(n, p))
    b = np.r_[2.0, -2.0, 1.0, np.zeros(p - 3)]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ b)))).astype(float)
    res = admm_tpu.logistic_lasso_path(X, y, nlambda=6)
    return X, y, res, _port(res)


@pytest.fixture(scope="module")
def pois():
    rng = np.random.default_rng(5)
    n, p = 120, 6
    X = 0.5 * rng.normal(size=(n, p))
    y = rng.poisson(np.exp(0.3 + X[:, 0] - 0.5 * X[:, 1])).astype(float)
    res = admm_tpu.poisson_lasso_path(X, y, nlambda=6)
    return X, y, res, _port(res)


@pytest.fixture(scope="module")
def cv(gauss):
    X, y, _, _ = gauss
    ref = admm_tpu.cv_lasso_path(X, y, nfolds=3, nlambda=8, keep=True)
    return ref, _port(ref)


def _same(got, ref):
    if isinstance(ref, list):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        return
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=1e-15)


def _lams(res):
    lams = np.asarray(res.lambdas, np.float64)
    return {"none": None, "on_grid": float(lams[3]),
            "off_grid": float(0.3 * lams[2] + 0.7 * lams[3]),
            "above": float(10 * lams[0]), "below": float(lams[-1] / 10)}


@pytest.mark.parametrize("lam", ["none", "on_grid", "off_grid", "above",
                                 "below"])
@pytest.mark.parametrize("type", ["link", "coefficients", "nonzero"])
def test_predict_gaussian_matches_reference(gauss, type, lam):
    X, _, ref, got = gauss
    s = _lams(ref)[lam]
    _same(admm_tpu_torch.predict(got, X, lam=s, type=type),
          admm_tpu.predict(ref, X, lam=s, type=type))


@pytest.mark.parametrize("lam", ["none", "off_grid"])
@pytest.mark.parametrize("type", ["link", "response", "class"])
@pytest.mark.parametrize("family", ["binomial", "probit"])
def test_predict_binomial_matches_reference(binom, type, family, lam):
    X, _, ref, got = binom
    s = _lams(ref)[lam]
    fams = {"binomial": ("binomial", "binomial"),
            "probit": (jglm.binomial_probit, tglm.binomial_probit)}[family]
    _same(admm_tpu_torch.predict(got, X, lam=s, type=type, family=fams[1]),
          admm_tpu.predict(ref, X, lam=s, type=type, family=fams[0]))


def test_predict_poisson_response_and_offset(pois):
    X, _, ref, got = pois
    off = np.linspace(-0.2, 0.2, X.shape[0])
    for kw in (dict(type="response", family="poisson"),
               dict(type="link", offset=off),
               dict(type="response", family="poisson", offset=off,
                    lam=float(ref.lambdas[2]))):
        _same(admm_tpu_torch.predict(got, X, **kw),
              admm_tpu.predict(ref, X, **kw))


@pytest.mark.parametrize("lam", [None, "lambda.min", "lambda_1se",
                                 "numeric"])
def test_predict_and_coef_of_cv_results(gauss, cv, lam):
    X, _, _, _ = gauss
    ref, got = cv
    s = float(ref.lambdas[2]) if lam == "numeric" else lam
    _same(admm_tpu_torch.predict(got, X, lam=s),
          admm_tpu.predict(ref, X, lam=s))
    _same(admm_tpu_torch.coef(got, lam=s), admm_tpu.coef(ref, lam=s))
    key = "lambda_1se" if lam is None else lam
    if key != "numeric":
        _same(admm_tpu_torch.predict(got, X, lam=s),
              admm_tpu_torch.predict(
                  got.fit, X, lam=getattr(got, key.replace(".", "_"))))


def test_predict_from_a_port_fit(gauss):
    """The port's own tensors in, numpy out: the linear predictors are
    beta0 + X coef of the fit (float64 on the host)."""
    X, y, _, _ = gauss
    res = admm_tpu_torch.lasso_path(X, y, nlambda=5, device="cpu")
    eta = admm_tpu_torch.predict(res, torch.as_tensor(X))
    want = (res.beta0.double().numpy()[:, None]
            + res.coef.double().numpy() @ X.T)
    np.testing.assert_allclose(eta, want, rtol=1e-12)
    cvp = admm_tpu_torch.cv_lasso_path(X, y, nfolds=3, nlambda=5,
                                       device="cpu")
    i = int(np.argmin(np.abs(cvp.lambdas - cvp.lambda_min)))
    np.testing.assert_allclose(
        admm_tpu_torch.predict(cvp, X, lam="lambda.min"),
        cvp.fit.beta0.double().numpy()[i]
        + X @ cvp.fit.coef.double().numpy()[i], rtol=1e-12)


@pytest.mark.parametrize("type", ["link", "response", "class",
                                  "coefficients"])
def test_prediction_runs_on_the_fits_device(gauss, type):
    """The work runs where the fit's coefficients live: a fit moved to the
    meta device (shapes, no data) predicts into a meta tensor, so no step
    went through numpy on the host (the card's case is in
    tests/test_torch_kernels_gpu.py)."""
    X, _, _, got = gauss
    meta = got._replace(beta0=got.beta0.to("meta"), coef=got.coef.to("meta"))
    out = _predict(meta, X, float(got.lambdas[3]), type, "binomial", None,
                   None)
    assert out.device.type == "meta"
    assert out.dtype == (torch.int64 if type == "class" else torch.float64)
    assert out.shape == ((X.shape[1] + 1,) if type == "coefficients"
                         else (X.shape[0],))


@pytest.mark.parametrize("case", ["type", "family", "class_gaussian",
                                  "string_lam_on_path", "cv_selector",
                                  "tau"])
def test_predict_errors_match_reference(gauss, cv, case):
    X, _, ref, got = gauss
    cref, cgot = cv
    calls = {
        "type": lambda m, r, c: m.predict(r, X, type="nope"),
        "family": lambda m, r, c: m.predict(r, X, type="response",
                                            family="nope"),
        "class_gaussian": lambda m, r, c: m.predict(r, X, type="class"),
        "string_lam_on_path": lambda m, r, c: m.predict(r, X,
                                                        lam="lambda.min"),
        "cv_selector": lambda m, r, c: m.predict(c, X, lam="lambda.best"),
        "tau": lambda m, r, c: m.predict(r, X, tau=0.5),
    }
    with pytest.raises(ValueError) as e_ref:
        calls[case](admm_tpu, ref, cref)
    with pytest.raises(ValueError) as e_got:
        calls[case](admm_tpu_torch, got, cgot)
    assert str(e_got.value) == str(e_ref.value)


def test_predict_refuses_other_result_types():
    res = admm_tpu_torch.lad_fit(np.eye(4)[:, :2] + 1.0, np.ones(4),
                                 device="cpu", maxit=5)
    with pytest.raises(TypeError, match="LADResult"):
        admm_tpu_torch.predict(res, np.ones((2, 2)))


@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson",
                                    "huber"])
@pytest.mark.parametrize("weighted", [False, True])
def test_path_table_and_deviance_match_reference(gauss, binom, pois, family,
                                                 weighted):
    data = {"gaussian": gauss, "binomial": binom, "poisson": pois,
            "huber": gauss}[family]
    X, y, ref, got = data
    fam_ref, fam_got = {
        "gaussian": ("gaussian", "gaussian"),
        "binomial": (jglm.binomial, tglm.binomial),
        "poisson": (jglm.poisson, tglm.poisson),
        "huber": (jglm.huber(1.0), tglm.huber(1.0)),
    }[family]
    w = (np.random.default_rng(1).uniform(0.5, 2.0, y.size) if weighted
         else None)
    t_ref = admm_tpu.path_table(ref, X, y, family=fam_ref, weights=w)
    t_got = admm_tpu_torch.path_table(got, X, y, family=fam_got, weights=w)
    np.testing.assert_array_equal(t_got.df, t_ref.df)
    _same(t_got.dev_ratio, t_ref.dev_ratio)
    _same(t_got.lambdas, t_ref.lambdas)
    np.testing.assert_allclose(t_got.nulldev, t_ref.nulldev, rtol=RTOL)
    assert admm_tpu_torch.format_path_table(t_got) == \
        admm_tpu.format_path_table(t_ref)
    _same(admm_tpu_torch.deviance(got, X, y, family=fam_got, weights=w),
          admm_tpu.deviance(ref, X, y, family=fam_ref, weights=w))


def test_path_table_rejects_unknown_family(gauss):
    X, y, ref, got = gauss
    with pytest.raises(ValueError) as e_ref:
        admm_tpu.path_table(ref, X, y, family="weibull")
    with pytest.raises(ValueError) as e_got:
        admm_tpu_torch.path_table(got, X, y, family="weibull")
    assert str(e_got.value) == str(e_ref.value)


def _assess_same(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        _same(got[k], ref[k])


@pytest.mark.parametrize("lam", [None, "grid"])
@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson",
                                    "probit"])
@pytest.mark.parametrize("weighted", [False, True])
def test_assess_matches_reference(gauss, binom, pois, family, lam, weighted):
    data = {"gaussian": gauss, "binomial": binom, "poisson": pois,
            "probit": binom}[family]
    X, y, ref, got = data
    fam_ref, fam_got = {"probit": (jglm.binomial_probit,
                                   tglm.binomial_probit)}.get(
        family, (family, family))
    w = (np.random.default_rng(4).uniform(0.5, 2.0, y.size) if weighted
         else None)
    s = None if lam is None else float(ref.lambdas[2])
    _assess_same(admm_tpu_torch.assess(got, X, y, family=fam_got,
                                       weights=w, lam=s),
                 admm_tpu.assess(ref, X, y, family=fam_ref, weights=w,
                                 lam=s))


def test_assess_cv_results_and_prevalidated_eta(gauss, cv):
    X, y, _, _ = gauss
    ref, got = cv
    for s in (None, "lambda.min"):
        _assess_same(admm_tpu_torch.assess(got, X, y, lam=s),
                     admm_tpu.assess(ref, X, y, lam=s))
    out = admm_tpu_torch.assess(None, None, y, eta=got.fit_preval.T)
    _assess_same(out, admm_tpu.assess(None, None, y, eta=ref.fit_preval.T))
    np.testing.assert_allclose(out["mse"], got.cvm, rtol=1e-6)


@pytest.mark.parametrize("case", ["family", "no_input", "eta_shape"])
def test_assess_errors_match_reference(gauss, case):
    X, y, ref, got = gauss
    calls = {
        "family": lambda m, r: m.assess(r, X, y, family="weibull"),
        "no_input": lambda m, r: m.assess(None, None, y),
        "eta_shape": lambda m, r: m.assess(None, None, y,
                                           eta=np.zeros(y.size)),
    }
    with pytest.raises(ValueError) as e_ref:
        calls[case](admm_tpu, ref)
    with pytest.raises(ValueError) as e_got:
        calls[case](admm_tpu_torch, got)
    assert str(e_got.value) == str(e_ref.value)


@pytest.mark.parametrize("lam", ["default", "grid"])
def test_roc_and_confusion_match_reference(binom, lam):
    X, y, ref, got = binom
    s = None if lam == "default" else float(ref.lambdas[2])
    for a, b in zip(admm_tpu_torch.roc(got, X, y, lam=s),
                    admm_tpu.roc(ref, X, y, lam=s)):
        _same(a, b)
    np.testing.assert_array_equal(admm_tpu_torch.confusion(got, X, y, lam=s),
                                  admm_tpu.confusion(ref, X, y, lam=s))
    eta = admm_tpu.predict(ref, X, lam=s or float(ref.lambdas[-1]))
    for a, b in zip(admm_tpu_torch.roc(None, None, y, eta=eta),
                    admm_tpu.roc(None, None, y, eta=eta)):
        _same(a, b)


@pytest.mark.parametrize("shape", ["one", "path"])
@pytest.mark.parametrize("weighted", [False, True])
def test_c_index_matches_reference(shape, weighted):
    rng = np.random.default_rng(10)
    n = 60
    t = np.round(rng.exponential(size=n), 1) + 0.1      # tied times
    d = (rng.uniform(size=n) < 0.7).astype(float)
    eta = rng.normal(size=n) if shape == "one" else rng.normal(size=(4, n))
    w = rng.integers(1, 3, n).astype(float) if weighted else None
    got = admm_tpu_torch.c_index(eta, t, d, weights=w)
    ref = admm_tpu.c_index(eta, t, d, weights=w)
    _same(got, ref)
    with pytest.raises(ValueError, match="comparable"):
        admm_tpu_torch.c_index(eta, np.ones(n), d)
