"""The port's Cox paths, their CV driver, survival curves and the Cox
branches of ``predict``/``assess``/``path_table``
(``admm_tpu_torch.models.cox``) against the JAX package's, on the same
seeded numpy inputs and ``device="cpu"``.

The data have tied times (rounded to 0.1), so every case runs Breslow's
tie groups; weights, offset, strata, start-stop (left truncation) and
their combinations take the segmented and interval risk sets.

Bars: float64 coefficients within 1e-6 (plus rtol 1e-7) and ``niter``
within 1 per lambda; float32 against the JAX package's float64 path
within the larger of 2e-4 and the JAX package's own float32 gap to its
float64 path on the same input (measured in the test), the convention of
the port's earlier parity tests (the float32 risk-set sums add in
another order than XLA's).  CV, survival curves, deviances and C: rtol
1e-6 in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu_torch.interop import from_reference
from admm_tpu_torch.models import cox

from _torch_parity import assert_cv_close

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def surv():
    rng = np.random.default_rng(2)
    n, p = 150, 8
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:3] = [1.0, -0.7, 0.5]
    t = np.round(rng.exponential(np.exp(-X @ beta)), 1) + 0.05   # ties
    d = (rng.random(n) < 0.7) * 1.0
    extra = {"weights": rng.uniform(0.5, 2.0, n),
             "offset": 0.1 * rng.normal(size=n),
             "strata": rng.integers(0, 3, n),
             "start": t * rng.uniform(0.0, 0.5, n)}
    return X, t, d, extra


CASES = {
    "plain": {}, "batch": {"path_mode": "batch"},
    "weights_offset": ("weights", "offset"), "strata": ("strata",),
    "start": ("start",), "start_strata": ("start", "strata"),
    "all": ("weights", "offset", "strata", "start"),
    "factors_limits": {"penalty_factor": np.linspace(0.5, 1.5, 8),
                       "lower_limits": -0.3, "upper_limits": 0.8,
                       "exclude": [5]},
    "enet_unstandardized": {"alpha": 0.5, "standardize": False},
    "lambdas": {"lambdas": [0.01, 0.1, 0.03]},
}


def _kw(case, extra):
    spec = CASES[case]
    return ({k: extra[k] for k in spec} if isinstance(spec, tuple)
            else dict(spec))


def _close(got, ref, atol=1e-6):
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=atol, rtol=1e-7)
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-10)
    gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
    assert gap.max() <= 1, f"niter gap {gap.max()}"


@pytest.mark.parametrize("case", list(CASES))
def test_cox_lasso_path_matches_jax_f64(surv, case):
    X, t, d, extra = surv
    kw = _kw(case, extra)
    got = admm_tpu_torch.cox_lasso_path(X, t, d, nlambda=6, **kw, **F64)
    ref = admm_tpu.cox_lasso_path(X, t, d, nlambda=6, dtype=jnp.float64,
                                  **kw)
    _close(got, ref)


@pytest.mark.parametrize("case", ["plain", "start_strata"])
def test_cox_lasso_path_f32_at_the_jax_float32_gap(surv, case):
    X, t, d, extra = surv
    kw = dict(nlambda=6, **_kw(case, extra))
    got = admm_tpu_torch.cox_lasso_path(X, t, d, dtype=torch.float32,
                                        device="cpu", **kw)
    ref64 = np.asarray(admm_tpu.cox_lasso_path(X, t, d, dtype=jnp.float64,
                                               **kw).coef)
    ref32 = np.asarray(admm_tpu.cox_lasso_path(X, t, d, dtype=jnp.float32,
                                               **kw).coef)
    bar = max(2e-4, np.abs(ref32 - ref64).max())
    assert np.abs(got.coef.numpy() - ref64).max() <= bar


def test_risk_terms_match_jax_on_lanes(surv):
    """The risk-set sums of a batch of linear predictors (lanes on the
    last axis) equal the JAX package's per lane, start-stop and strata
    included."""
    from admm_tpu.models import cox as jcox

    X, t, d, extra = surv
    st = extra["start"]
    order, first, last, seg, ext = cox._cox_prep(t, extra["strata"], st,
                                                 "cpu")
    jorder, jss, jf, jl = jcox._strata_prep(t, extra["strata"])
    np.testing.assert_array_equal(order, jorder)
    jfirst, jlast = jcox._tie_groups(t[jorder], jss)
    jext = jcox._startstop_prep_strata(t[jorder], st[jorder], jss)
    eta = np.random.default_rng(3).normal(size=(4, t.size))
    dd = d[order]
    G = cox._cox_risk_terms(torch.as_tensor(eta), torch.as_tensor(dd), first,
                            last, None, seg, ext)[2]
    for i in range(4):
        ref = jcox._cox_risk_terms(jnp.asarray(eta[i]), jnp.asarray(dd),
                                   jfirst, jlast, None, (jf, jl), jext)[2]
        np.testing.assert_allclose(G[i].numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("cv_mode", ["onepass", "loop"])
@pytest.mark.parametrize("case", ["plain", "all"])
def test_cv_cox_path_matches_jax(surv, cv_mode, case):
    X, t, d, extra = surv
    kw = dict(nfolds=3, nlambda=5, cv_mode=cv_mode, **_kw(case, extra))
    got = admm_tpu_torch.cv_cox_path(X, t, d, **kw, **F64)
    ref = admm_tpu.cv_cox_path(X, t, d, dtype=jnp.float64, **kw)
    np.testing.assert_array_equal(got.foldid, ref.foldid)
    assert_cv_close(got, ref, rtol=1e-6)
    _close(got.fit, ref.fit)


def test_cv_cox_path_c_index_and_keep_match_jax(surv):
    X, t, d, extra = surv
    kw = dict(nfolds=3, nlambda=5, type_measure="C", keep=True,
              weights=extra["weights"])
    got = admm_tpu_torch.cv_cox_path(X, t, d, **kw, **F64)
    ref = admm_tpu.cv_cox_path(X, t, d, dtype=jnp.float64, **kw)
    assert_cv_close(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got.fit_preval, ref.fit_preval, rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("case", ["plain", "weights_offset", "start",
                                  "strata"])
def test_survfit_cox_matches_jax(surv, case):
    X, t, d, extra = surv
    kw = _kw(case, extra)
    fit = admm_tpu_torch.cox_lasso_path(X, t, d, nlambda=5, **kw, **F64)
    ref_fit = admm_tpu.cox_lasso_path(X, t, d, nlambda=5, dtype=jnp.float64,
                                      **kw)
    lam = float(ref_fit.lambdas[3])
    got = admm_tpu_torch.survfit_cox(fit, X, t, d, lam=lam, **kw)
    ref = admm_tpu.survfit_cox(ref_fit, X, t, d, lam=lam, **kw)
    if case == "strata":
        assert sorted(got) == sorted(ref)
        got, ref = got[1], ref[1]
    np.testing.assert_array_equal(got.time, ref.time)
    np.testing.assert_allclose(got.cumhaz, ref.cumhaz, rtol=1e-6)
    np.testing.assert_allclose(got.surv, ref.surv, rtol=1e-6, atol=1e-12)


def test_survfit_cox_of_a_cv_result_and_new_rows(surv):
    X, t, d, _ = surv
    cv = admm_tpu_torch.cv_cox_path(X, t, d, nfolds=3, nlambda=5, **F64)
    ref = admm_tpu.cv_cox_path(X, t, d, nfolds=3, nlambda=5,
                               dtype=jnp.float64)
    got = admm_tpu_torch.survfit_cox(cv, X, t, d, Xnew=X[:4])
    want = admm_tpu.survfit_cox(ref, X, t, d, Xnew=X[:4])
    np.testing.assert_allclose(got.surv, want.surv, rtol=1e-6)
    with pytest.raises(ValueError):
        admm_tpu_torch.survfit_cox(cv.fit, X, t, d)


@pytest.mark.parametrize("case", ["plain", "start"])
def test_cox_predict_assess_and_path_table_match_jax(surv, case):
    X, t, d, extra = surv
    kw = _kw(case, extra)
    fit = admm_tpu_torch.cox_lasso_path(X, t, d, nlambda=5, **kw, **F64)
    ref = admm_tpu.cox_lasso_path(X, t, d, nlambda=5, dtype=jnp.float64,
                                  **kw)
    off = extra["offset"]
    for typ in ("link", "response", "coefficients"):
        np.testing.assert_allclose(
            admm_tpu_torch.predict(fit, X[:7], type=typ, offset=off[:7]),
            np.asarray(admm_tpu.predict(ref, X[:7], type=typ,
                                        offset=off[:7])), rtol=1e-6,
            atol=1e-12)
    lam = float(ref.lambdas[2])
    np.testing.assert_array_equal(
        admm_tpu_torch.predict(fit, None, type="nonzero", lam=lam),
        admm_tpu.predict(ref, None, type="nonzero", lam=lam))
    with pytest.raises(ValueError):
        admm_tpu_torch.predict(fit, X, type="class")
    y = np.c_[t, d] if case == "plain" else np.c_[extra["start"], t, d]
    for a, b in ((admm_tpu_torch.assess(fit, X, y),
                  admm_tpu.assess(ref, X, y)),
                 (admm_tpu_torch.assess(fit, X, None, time=t, event=d,
                                        lam=lam, **kw),
                  admm_tpu.assess(ref, X, None, time=t, event=d, lam=lam,
                                  **kw))):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-6)
    got_t = admm_tpu_torch.path_table(fit, X, y)
    ref_t = admm_tpu.path_table(ref, X, y)
    np.testing.assert_allclose(got_t.dev_ratio, ref_t.dev_ratio, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(got_t.df, ref_t.df)
    assert got_t.nulldev == pytest.approx(ref_t.nulldev, rel=1e-10)


def test_cox_result_converts_from_jax(surv):
    X, t, d, _ = surv
    ref = admm_tpu.cox_lasso_path(X, t, d, nlambda=3, dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, cox.CoxPathResult)
    np.testing.assert_array_equal(port.coef.numpy(), np.asarray(ref.coef))


@pytest.mark.parametrize("kw", [
    {"event": "two"}, {"event": "zeros"}, {"path_mode": "wide"},
    {"alpha": 0.0}, {"weights": "zero"}, {"start": "late"},
    {"offset": "short"}])
def test_cox_lasso_path_errors(surv, kw):
    X, t, d, _ = surv
    kw = dict(kw)
    ev = {"two": d * 2, "zeros": d * 0}.get(kw.pop("event", None), d)
    if kw.get("weights") == "zero":
        kw["weights"] = np.zeros_like(t)
    if kw.get("start") == "late":
        kw["start"] = t + 1.0
    if kw.get("offset") == "short":
        kw["offset"] = t[:3]
    with pytest.raises(ValueError):
        admm_tpu_torch.cox_lasso_path(X, t, ev, **kw, **F64)
    with pytest.raises(ValueError):
        admm_tpu.cox_lasso_path(X, t, ev, **kw)


def test_cv_cox_path_errors(surv):
    X, t, d, extra = surv
    for kw in ({"type_measure": "auc"}, {"cv_mode": "fast"},
               {"type_measure": "C", "start": extra["start"]}):
        with pytest.raises(ValueError):
            admm_tpu_torch.cv_cox_path(X, t, d, **kw, **F64)
    # fold_mesh needs nfolds a multiple of its size (the default 10
    # folds on 4 positions).
    with pytest.raises(ValueError, match="multiple of the fold_mesh"):
        admm_tpu_torch.cv_cox_path(
            X, t, d, fold_mesh=torch_mesh(4, devices=["cpu"] * 4), **F64)
