"""The port's linear SVM (``admm_tpu_torch.models.svm``), its CV driver and
its ``predict`` branch against the JAX package's, on the same seeded numpy
inputs and ``device="cpu"``.

Bars: float64 weights and biases within 1e-6 (plus rtol 1e-7) and
``niter`` within 1 per C; float32 within 2e-4, niter compared in float64
only.  The hinge loss is piecewise linear in the unpenalized bias, whose
optimum can be an interval: there float32 is held on the weights (2e-4)
and on the objective (no more than 1e-4 above the JAX package's float64
path's), since one more iteration moved a float32 bias by 1.5e-3 here
at an objective 2.4e-5 BELOW the float64 one.  CV (float64): cvm rtol
1e-4 and ``C_min``/``C_1se`` on the same grid point.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu.models import svm as jsvm
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.models import svm as tsvm

from _torch_parity import assert_path_close

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "f64": (jnp.float64, torch.float64, 1e-6)}
FIELDS = ("coef", "intercept")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, p = 80, 6
    X = rng.normal(size=(n, p))
    y = (X @ np.r_[1.0, -1.0, 0.5, np.zeros(p - 3)] + 0.3
         + 0.5 * rng.normal(size=n) > 0).astype(int)
    return X, y


def _objective(res, X, y):
    """(k,) hinge objectives 1/2 ||w||^2 + C sum_i max(0, 1 - m_i)."""
    ys = 2.0 * y - 1.0
    C = np.asarray(res.Cs, np.float64)
    W = np.asarray(res.coef, np.float64)
    b = np.asarray(res.intercept, np.float64)
    m = ys[None, :] * (W @ X.T + b[:, None])
    return 0.5 * (W ** 2).sum(axis=1) + C * np.maximum(0.0, 1.0 - m).sum(1)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("loss", ["hinge", "squared_hinge"])
@pytest.mark.parametrize("mode", ["batch", "scan"])
def test_svm_path_matches_jax(data, mode, loss, dt):
    X, y = data
    jdt, tdt, atol = DTYPES[dt]
    kw = dict(nC=5, path_mode=mode, loss=loss)
    ref = admm_tpu.svm_path(X, y, dtype=jdt, **kw)
    got = admm_tpu_torch.svm_path(X, y, dtype=tdt, device="cpu", **kw)
    assert got.coef.dtype == tdt and got.classes == ref.classes
    if loss == "hinge" and dt == "f32":
        ref64 = admm_tpu.svm_path(X, y, dtype=jnp.float64, **kw)
        assert_path_close(got, ref64, atol, fields=("coef",), niter=False,
                          grid="Cs")
        assert np.all(_objective(got, X, y)
                      <= _objective(ref64, X, y) * (1.0 + 1e-4))
        return
    assert_path_close(got, ref, atol, fields=FIELDS, niter=dt == "f64",
                      grid="Cs")


CASES = {
    "weights": "weights",
    "no_intercept": dict(intercept=False),
    "user_Cs": dict(Cs=[0.5, 4.0, 0.05]),
    "rho": dict(rho=0.7),
    "labels": "labels",
    "pm_one": "pm_one",
}


@pytest.mark.parametrize("case", list(CASES))
def test_svm_options_match_jax(data, case):
    X, y = data
    kw = CASES[case]
    if kw == "weights":
        kw = dict(weights=np.where(y == 1, 2.0, 0.5))
    elif kw == "labels":
        y = np.where(y == 1, "spam", "ham")
        kw = {}
    elif kw == "pm_one":
        y = 2 * y - 1
        kw = {}
    kw = dict(dict(nC=4), **kw)
    ref = admm_tpu.svm_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.svm_path(X, y, dtype=torch.float64, device="cpu",
                                  **kw)
    assert got.classes == ref.classes
    assert_path_close(got, ref, 1e-6, fields=FIELDS, grid="Cs")


def test_svm_fit_and_trace_match_jax(data):
    X, y = data
    ref = admm_tpu.svm_fit(X, y, C=0.7, dtype=jnp.float64)
    got = admm_tpu_torch.svm_fit(X, y, C=0.7, dtype=torch.float64,
                                 device="cpu")
    assert got.coef.shape == (1, X.shape[1])
    assert_path_close(got, ref, 1e-6, fields=FIELDS, grid="Cs")
    kw = dict(nC=3, trace_len=20)
    ref = admm_tpu.svm_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.svm_path(X, y, dtype=torch.float64, device="cpu",
                                  **kw)
    assert got.trace.shape == (3, 20, 5)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-7, atol=1e-12, equal_nan=True)


def test_hinge_proxes_match_jax():
    rng = np.random.default_rng(1)
    v = np.r_[rng.normal(size=20) * 2, 1.0, 0.0]
    for scale in (0.3, np.abs(rng.normal(size=22))):
        for port, ref in ((tsvm.hinge_prox, jsvm.hinge_prox),
                          (tsvm.sq_hinge_prox, jsvm.sq_hinge_prox)):
            sc = scale if np.isscalar(scale) else torch.as_tensor(scale)
            np.testing.assert_allclose(port(torch.as_tensor(v), sc).numpy(),
                                       np.asarray(ref(v, scale)),
                                       rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", ["three_classes", "loss", "path_mode",
                                  "C_zero", "C_inf", "rows"])
def test_svm_refusals_like_jax(data, case):
    """The JAX package's ValueErrors (tests/test_svm.py:115-117, :233),
    with the same messages."""
    X, y = data
    kw = {"three_classes": dict(y=np.arange(X.shape[0]) % 3),
          "loss": dict(loss="logistic"), "path_mode": dict(path_mode="warm"),
          "C_zero": dict(Cs=[1.0, 0.0]), "C_inf": dict(Cs=[np.inf]),
          "rows": dict(y=y[:-1])}[case]
    yy = kw.pop("y", y)
    with pytest.raises(ValueError) as ref:
        admm_tpu.svm_path(X, yy, **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.svm_path(X, yy, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_svm_meshes_not_ported(data):
    """``data_mesh`` and ``fold_mesh`` on CPU meshes: the path within the
    float32 bar of the path without one, the CV equal to the bit."""
    X, y = data
    mesh = torch_mesh(2, devices=["cpu"] * 2)
    got = admm_tpu_torch.svm_path(X, y, data_mesh=mesh, device="cpu")
    ref = admm_tpu_torch.svm_path(X, y, device="cpu")
    np.testing.assert_allclose(got.coef.numpy(), ref.coef.numpy(),
                               atol=1e-4)
    cv = admm_tpu_torch.cv_svm_path(X, y, fold_mesh=mesh, device="cpu")
    cv_ref = admm_tpu_torch.cv_svm_path(X, y, device="cpu")
    np.testing.assert_array_equal(cv.cvm, cv_ref.cvm)


@pytest.mark.parametrize("case", ["class", "loss_hinge", "weights",
                                  "train_only_rows"])
def test_cv_svm_path_matches_jax(data, case):
    X, y = data
    foldid = np.arange(X.shape[0]) % 4
    kw = dict(nC=5, foldid=foldid, dtype=jnp.float64)
    if case == "loss_hinge":
        kw.update(type_measure="loss", loss="hinge")
    elif case == "weights":
        kw["weights"] = np.random.default_rng(4).uniform(0.5, 2.0, len(y))
    elif case == "train_only_rows":
        kw["foldid"] = np.where(np.arange(len(y)) % 9 == 0, -1, foldid)
    ref = admm_tpu.cv_svm_path(X, y, **kw)
    got = admm_tpu_torch.cv_svm_path(X, y, device="cpu",
                                     **dict(kw, dtype=torch.float64))
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-4, atol=1e-12)
    assert got.C_min == pytest.approx(ref.C_min, rel=1e-6)
    assert got.C_1se == pytest.approx(ref.C_1se, rel=1e-6)
    np.testing.assert_array_equal(got.foldid, ref.foldid)
    assert_path_close(got.fit, ref.fit, 1e-6, fields=FIELDS, grid="Cs")


def test_cv_svm_refusals_like_jax(data):
    X, y = data
    for kw in (dict(type_measure="auc"), dict(nfolds=1),
               dict(foldid=np.zeros(len(y), int))):
        with pytest.raises(ValueError) as ref:
            admm_tpu.cv_svm_path(X, y, **kw)
        with pytest.raises(ValueError) as got:
            admm_tpu_torch.cv_svm_path(X, y, device="cpu", **kw)
        assert str(got.value) == str(ref.value)


def test_predict_svm_like_jax(data):
    """Decision values, original labels, coefficients and nonzeros, on
    the C grid and between its points; a CV result at ``C_min``/``C_1se``
    (the default); 'response' refused."""
    X, y = data
    labels = np.where(y == 1, 7, 3)
    kw = dict(nC=4)
    ref = admm_tpu.svm_path(X, labels, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.svm_path(X, labels, dtype=torch.float64,
                                  device="cpu", **kw)
    Xn = X[:6]
    for lam in (None, 0.3, float(np.asarray(ref.Cs)[1])):
        for typ in ("link", "class", "coefficients"):
            a = admm_tpu_torch.predict(got, Xn, lam=lam, type=typ)
            b = admm_tpu.predict(ref, Xn, lam=lam, type=typ)
            if typ == "class":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(admm_tpu_torch.coef(got, lam=0.3),
                               admm_tpu.coef(ref, lam=0.3), atol=1e-7)
    for a, b in zip(admm_tpu_torch.predict(got, None, type="nonzero"),
                    admm_tpu.predict(ref, None, type="nonzero")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="decision"):
        admm_tpu_torch.predict(got, Xn, type="response")
    cv_kw = dict(nC=4, foldid=np.arange(len(y)) % 3, dtype=jnp.float64)
    cv_ref = admm_tpu.cv_svm_path(X, labels, **cv_kw)
    cv_got = admm_tpu_torch.cv_svm_path(X, labels, device="cpu",
                                        **dict(cv_kw, dtype=torch.float64))
    for sel in (None, "C_min", "C.1se", "lambda.min"):
        np.testing.assert_array_equal(
            admm_tpu_torch.predict(cv_got, Xn, lam=sel, type="class"),
            admm_tpu.predict(cv_ref, Xn, lam=sel, type="class"))
    with pytest.raises(ValueError, match="C_min"):
        admm_tpu_torch.predict(cv_got, Xn, lam="best")
    with pytest.raises(TypeError, match="SVMResult"):
        admm_tpu_torch.assess(got, X, labels)


def test_svm_result_round_trip(data):
    """The JAX package's SVMResult (its labels included) carries across and
    back."""
    X, y = data
    ref = admm_tpu.svm_path(X, np.where(y == 1, "b", "a"), nC=2,
                            dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, admm_tpu_torch.SVMResult)
    assert port.classes == ("a", "b")
    back = to_reference(port, type(ref))
    assert back.classes == ref.classes
    for f in ("Cs", "coef", "intercept", "niter"):
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(ref, f)))
