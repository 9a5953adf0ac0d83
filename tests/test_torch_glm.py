"""The port's penalized GLM paths (``models/glm.py``, ``models/logistic.py``)
against the JAX package on the same numpy inputs, ``device="cpu"``.

``tests/conftest.py`` turns JAX's x64 flag on; every comparison passes
``dtype=`` on both sides, float32 against float32 and float64 against
float64.

Bars.  float64 runs the generic engine on both sides, the same arithmetic
in the same order: design statistics within 1e-12, family functions
within 1e-10 (probit 1e-8: the two libraries' log-cdf and inverse cdf
differ in their last digits; its curvature in the far tails 1e-5), path
coefficients and intercepts within 1e-8, ``niter`` within 1.  float32 takes the port's kernel route for the
batched fixed-majorizer path of binomial and huber (the kernel's plain
form here: products and norms accumulated in float64) against the JAX
package's float32 engine: coefficients and intercepts within 2e-5 and
``niter`` within 1 at eps 1e-6, the bar of the JAX package's own kernel
test (``tests/test_pallas_kernels.py``).  Auto lambda grids: rtol 1e-5 in
float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu.models import glm as jglm
from admm_tpu_torch.kernels import glm as glm_kernel
from admm_tpu_torch.models import glm as tglm

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}
N, P, NLAM = 240, 12, 6

# name -> (factory arguments, kind of response)
FAMILIES = {
    "binomial": ((), "binary"),
    "huber": ((1.345,), "real"),
    "poisson": ((), "count"),
    "binomial_probit": ((), "binary"),
    "binomial_cloglog": ((), "binary"),
    "gamma_log": ((), "positive"),
    "negative_binomial": ((2.0,), "count"),
}


def _fam(name):
    args = FAMILIES[name][0]
    return getattr(jglm, name)(*args), getattr(tglm, name)(*args)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(0.2, 1.3, (N, P))
    b = np.zeros(P)
    b[:4] = [1.2, -1.5, 0.8, 0.5]
    eta = 0.3 + 0.5 * (X @ b)
    ys = {
        "binary": (rng.uniform(size=N) < 1 / (1 + np.exp(-eta))).astype(float),
        "real": eta + 0.3 * rng.standard_t(3, size=N),
        "count": rng.poisson(np.exp(np.clip(0.5 * eta, None, 3.0))).astype(
            float),
        "positive": rng.gamma(2.0, np.exp(np.clip(0.4 * eta, -3, 3)) / 2.0),
    }
    w = rng.uniform(0.5, 2.0, size=N)
    off = 0.2 * rng.normal(size=N)
    return X, ys, w, off


def _y(data, name):
    return data[1][FAMILIES[name][1]]


def _both(data, name, dtype, **kw):
    """The same call through both packages."""
    X, _, _, _ = data
    y = _y(data, name)
    jdt, tdt = DTYPES[dtype]
    jfam, tfam = _fam(name)
    ref = admm_tpu.glm_lasso_path(X, y, jfam, dtype=jdt, **kw)
    got = admm_tpu_torch.glm_lasso_path(X, y, tfam, dtype=tdt, device="cpu",
                                        **kw)
    return ref, got


def _assert_path_match(ref, got, dtype, coef_atol):
    tdt = DTYPES[dtype][1]
    assert got.coef.dtype == tdt and got.niter.dtype == torch.int32
    assert got.coef.shape == np.asarray(ref.coef).shape
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-5 if dtype == "float32" else 1e-12)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=coef_atol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=coef_atol)
    assert np.abs(got.niter.numpy() - np.asarray(ref.niter)).max() <= 1
    assert bool(torch.any(got.coef != 0))


# ---------------------------------------------------------------------------
# Design prep and recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_prep_design_and_recover(data, standardize, intercept, weighted):
    """float64, 1e-12: the four flag modes, with and without weights."""
    X, _, w, _ = data
    wn = w * (N / w.sum()) if weighted else None
    ref = jglm.prep_design(jnp.asarray(X), standardize, intercept,
                           weights=None if wn is None else jnp.asarray(wn))
    got = tglm.prep_design(torch.as_tensor(X), standardize, intercept,
                           weights=None if wn is None else torch.as_tensor(wn))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64 and a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    q = P + int(intercept)
    coefs = np.random.default_rng(1).normal(size=(3, q))
    b0_ref, c_ref = jglm.recover_glm(jnp.asarray(coefs), ref[2], ref[3],
                                     intercept)
    b0, c = tglm.recover_glm(torch.as_tensor(coefs), got[2], got[3],
                             intercept)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-12)
    np.testing.assert_allclose(b0.numpy(), np.asarray(b0_ref), atol=1e-12)


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_functions(data, name):
    """float64 on a grid of eta that includes +-30: rtol = atol = 1e-10
    (probit 1e-8)."""
    jfam, tfam = _fam(name)
    tol = 1e-8 if name == "binomial_probit" else 1e-10
    y = _y(data, name)[:41]
    w = data[2][:41]
    eta = np.concatenate([np.linspace(-30.0, 30.0, 31),
                          np.linspace(-2.0, 2.0, 10)])
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=tol, atol=tol)
    ty, teta, tw = (torch.as_tensor(a) for a in (y, eta, w))
    assert tfam.name == jfam.name == name
    assert tfam.curvature_bound == jfam.curvature_bound
    assert tfam.param == jfam.param
    close(tfam.grad_eta(teta, ty), jfam.grad_eta(jnp.asarray(eta), y))
    got_w = tfam.weight_eta(teta, ty).numpy()
    ref_w = np.asarray(jfam.weight_eta(jnp.asarray(eta), y))
    if name == "binomial_probit":
        # r (r + eta) cancels at |eta| >= 26, where the JAX package's
        # log-cdf series is off by 1.6e-10 (torch's agrees with scipy's
        # there): 1e-5 in the tails, 1e-8 on |eta| <= 10.
        tails = np.abs(eta) > 10
        np.testing.assert_allclose(got_w[tails], ref_w[tails], atol=1e-5)
        got_w, ref_w = got_w[~tails], ref_w[~tails]
    close(got_w, ref_w)
    for intercept in (True, False):
        close(tfam.null_resid(ty, intercept),
              jfam.null_resid(jnp.asarray(y), intercept))
        close(tfam.null_resid(ty, intercept, tw),
              jfam.null_resid(jnp.asarray(y), intercept, jnp.asarray(w)))
    eta2 = np.stack([eta, 0.5 * eta])
    close(tfam.cv_loss(eta2, y), jfam.cv_loss(eta2, y))
    assert (tfam.cv_loss_dev is None) == (jfam.cv_loss_dev is None)
    if tfam.cv_loss_dev is not None:
        close(tfam.cv_loss_dev(torch.as_tensor(eta2), ty),
              jfam.cv_loss_dev(jnp.asarray(eta2), jnp.asarray(y)))
    assert (tfam.mean_eta is None) == (jfam.mean_eta is None)
    if tfam.mean_eta is not None:
        close(tfam.mean_eta(eta), jfam.mean_eta(eta))


def test_families_are_cached_and_validated():
    """The factories are ``lru_cache``d, as in the JAX package (a family is
    a static argument there and a dispatch key later)."""
    assert tglm.huber(1.345) is tglm.huber(1.345)
    assert tglm.huber(1.345) is not tglm.huber(2.0)
    assert tglm.binomial() is tglm.binomial()
    assert tglm.negative_binomial(2.0).param == 2.0
    with pytest.raises(ValueError, match="theta must be positive"):
        tglm.negative_binomial(0.0)
    assert admm_tpu_torch.GLMFamily is tglm.GLMFamily
    assert tglm.GLMFamily._fields == jglm.GLMFamily._fields


@pytest.mark.parametrize("name", list(FAMILIES))
def test_auto_lambda_grid(data, name):
    """float32, rtol 1e-5: the null model's score per family (Huber's
    bisection, probit's inverse cdf) and the log-linear grid."""
    ref, got = _both(data, name, "float32", nlambda=5, maxit=3)
    assert got.lambdas.dtype == torch.float32
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-5)
    assert float(got.lambdas[0]) > float(got.lambdas[-1]) > 0


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_batch_fixed_float32_kernel_route_matches_engine(data, name,
                                                         monkeypatch):
    """The default route in float32 (batch, fixed majorizer) goes through
    the kernel wrapper, whose plain form here is held against the JAX
    engine: coefficients and intercepts 2e-5, niter within 1, eps 1e-6."""
    calls = []
    wrapped = glm_kernel.glm_batch_path
    monkeypatch.setattr(glm_kernel, "glm_batch_path",
                        lambda *a, **k: calls.append(k) or wrapped(*a, **k))
    ref, got = _both(data, name, "float32", nlambda=NLAM, eps_abs=1e-6,
                     eps_rel=1e-6)
    assert [c["family"] for c in calls] == [name]
    assert calls[0]["newton_steps"] == 2
    _assert_path_match(ref, got, "float32", 2e-5)


@pytest.mark.parametrize("path_mode,hessian", [
    ("batch", "fixed"), ("scan", "fixed"), ("scan", "exact"),
    ("batch", "exact")])
@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_engine_routes_float64(data, name, path_mode, hessian, monkeypatch):
    """float64 never takes the kernel; each engine route within 1e-8."""
    monkeypatch.setattr(glm_kernel, "glm_batch_path", None)
    ref, got = _both(data, name, "float64", nlambda=NLAM,
                     path_mode=path_mode, hessian=hessian)
    _assert_path_match(ref, got, "float64", 1e-8)


@pytest.mark.parametrize("name", ["poisson", "gamma_log",
                                  "negative_binomial", "binomial_cloglog"])
def test_unbounded_families_scan_adaptive(data, name):
    """hessian="auto" is "adaptive" and the path a scan: the per-lambda
    majorizer rides ``st.aux`` across warm starts.  float64, 1e-8."""
    ref, got = _both(data, name, "float64", nlambda=NLAM)
    _assert_path_match(ref, got, "float64", 1e-8)
    batch = admm_tpu_torch.glm_lasso_path(
        data[0], _y(data, name), _fam(name)[1], nlambda=NLAM,
        path_mode="batch", dtype=torch.float64, device="cpu")
    assert torch.equal(batch.coef, got.coef)     # adaptive is scan-only


def test_probit_default_route_takes_the_engine(data, monkeypatch):
    """Probit has a curvature bound (fixed, batch) but no kernel: float32
    through the batched engine on both sides, 2e-5 at eps 1e-6."""
    monkeypatch.setattr(glm_kernel, "glm_batch_path", None)
    ref, got = _both(data, "binomial_probit", "float32", nlambda=NLAM,
                     eps_abs=1e-6, eps_rel=1e-6)
    _assert_path_match(ref, got, "float32", 2e-5)


def test_poisson_newton_steps_default(data):
    X, y = data[0], _y(data, "poisson")
    ref = admm_tpu.poisson_lasso_path(X, y, nlambda=NLAM, dtype=jnp.float64)
    got = admm_tpu_torch.poisson_lasso_path(X, y, nlambda=NLAM, device="cpu",
                                            dtype=torch.float64)
    _assert_path_match(ref, got, "float64", 1e-8)
    two = admm_tpu_torch.glm_lasso_path(X, y, tglm.poisson(), nlambda=NLAM,
                                        device="cpu", dtype=torch.float64)
    assert not torch.equal(two.coef, got.coef)   # newton_steps 1, not 2


def test_huber_lasso_path_takes_M(data):
    X, y = data[0], _y(data, "huber")
    ref = admm_tpu.huber_lasso_path(X, y, M=2.0, nlambda=NLAM,
                                    dtype=jnp.float64)
    got = admm_tpu_torch.huber_lasso_path(X, y, M=2.0, nlambda=NLAM,
                                          device="cpu", dtype=torch.float64)
    _assert_path_match(ref, got, "float64", 1e-8)


OPTIONS = {
    # label: (family, dtype, options as a function of (w, off))
    "weights": ("binomial", "float64", lambda w, off: dict(weights=w)),
    "weights_exact": ("huber", "float64",
                      lambda w, off: dict(weights=w, hessian="exact")),
    "offset": ("poisson", "float64", lambda w, off: dict(offset=off)),
    "offset_no_intercept": ("binomial", "float64",
                            lambda w, off: dict(offset=off, intercept=False)),
    "weights_offset": ("binomial", "float64",
                       lambda w, off: dict(weights=w, offset=off)),
    "penalty_factor": ("binomial", "float64", lambda w, off: dict(
        penalty_factor=np.r_[0.0, 0.5, np.ones(P - 2)])),
    "limits": ("binomial", "float64", lambda w, off: dict(
        lower_limits=0.0, upper_limits=np.r_[0.1, np.full(P - 1, np.inf)])),
    "exclude": ("huber", "float64", lambda w, off: dict(exclude=[0, 3])),
    "alpha_f32_kernel_route": ("binomial", "float32", lambda w, off: dict(
        alpha=0.5, eps_abs=1e-6, eps_rel=1e-6)),
    "alpha_f64": ("huber", "float64", lambda w, off: dict(alpha=0.5)),
    "no_intercept_f32_kernel_route": ("huber", "float32", lambda w, off: dict(
        intercept=False, eps_abs=1e-6, eps_rel=1e-6)),
    "no_standardize": ("binomial", "float64",
                       lambda w, off: dict(standardize=False)),
    "no_standardize_no_intercept": ("huber", "float64", lambda w, off: dict(
        standardize=False, intercept=False)),
    "user_lambdas": ("binomial", "float64", lambda w, off: dict(
        lambdas=[0.01, 0.1, 0.03])),
    "rho_newton_steps_f32_kernel_route": (
        "binomial", "float32", lambda w, off: dict(
            rho=0.5, newton_steps=3, eps_abs=1e-6, eps_rel=1e-6)),
    "rho_maxit": ("poisson", "float64", lambda w, off: dict(rho=2.0, maxit=7)),
    "lambda_min_ratio": ("binomial", "float64",
                         lambda w, off: dict(lambda_min_ratio=0.1)),
    "dfmax": ("binomial", "float64", lambda w, off: dict(dfmax=2)),
    "pmax": ("huber", "float64", lambda w, off: dict(pmax=3)),
}


@pytest.mark.parametrize("label", list(OPTIONS))
def test_options_match_reference(data, label):
    name, dtype, make = OPTIONS[label]
    kw = make(data[2], data[3])
    kw.setdefault("nlambda", NLAM)
    ref, got = _both(data, name, dtype, **kw)
    _assert_path_match(ref, got, dtype, 2e-5 if dtype == "float32" else 1e-8)
    if label in ("dfmax", "pmax"):
        assert 0 < got.coef.shape[0] < NLAM
    if label == "exclude":
        assert float(got.coef[:, [0, 3]].abs().max()) == 0.0
    if label == "limits":
        assert float(got.coef.min()) >= 0.0
        assert float(got.coef[:, 0].max()) <= 0.1 + 1e-12
    if label == "user_lambdas":
        assert got.lambdas.tolist() == [0.1, 0.03, 0.01]


def test_options_keep_the_kernel_route_for_scalar_penalties_only(
        data, monkeypatch):
    """Weights, offset, penalty factors, bounds, float64, another family,
    scan, exact and a shape past ``fits`` take the engine; the decision is
    made before the call."""
    calls = []
    wrapped = glm_kernel.glm_batch_path
    monkeypatch.setattr(glm_kernel, "glm_batch_path",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    X, y, w, off = data[0], _y(data, "binomial"), data[2], data[3]
    run = lambda fam=tglm.binomial(), **kw: admm_tpu_torch.glm_lasso_path(
        X, y, fam, nlambda=3, maxit=5, device="cpu", **kw)
    run()
    run(alpha=0.7, intercept=False, standardize=False, rho=1.0)
    run(dtype=None)
    admm_tpu_torch.huber_lasso_path(X, y, nlambda=3, maxit=5, device="cpu")
    assert len(calls) == 4
    for kw in (dict(weights=w), dict(offset=off),
               dict(penalty_factor=np.ones(P)), dict(lower_limits=0.0),
               dict(exclude=[1]), dict(dtype=torch.float64),
               dict(path_mode="scan"), dict(hessian="exact"),
               dict(fam=tglm.binomial_probit())):
        run(**kw)
    assert tglm._use_kernel_glm(10000, 1001, torch.float32)
    assert not tglm._use_kernel_glm(10000, 1001, torch.float64)
    assert not tglm._use_kernel_glm(30000, 1001, torch.float32)
    monkeypatch.setattr(glm_kernel, "_SMEM_FLOATS", 64)
    run()
    assert len(calls) == 4


def test_logistic_lasso_path_is_the_binomial_glm_path(data):
    X, y = data[0], _y(data, "binomial")
    kw = dict(nlambda=NLAM, alpha=0.8, device="cpu")
    a = admm_tpu_torch.logistic_lasso_path(X, y, **kw)
    b = admm_tpu_torch.glm_lasso_path(X, y, tglm.binomial(), **kw)
    c = admm_tpu_torch.glm_lasso_path(X, y, tglm.binomial, **kw)  # a factory
    for f in ("lambdas", "beta0", "coef", "niter"):
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.equal(getattr(a, f), getattr(c, f))
    ref = admm_tpu.logistic_lasso_path(X, y, nlambda=NLAM, alpha=0.8,
                                       eps_abs=1e-6, eps_rel=1e-6,
                                       dtype=jnp.float32)
    got = admm_tpu_torch.logistic_lasso_path(X, y, eps_abs=1e-6,
                                             eps_rel=1e-6, **kw)
    _assert_path_match(ref, got, "float32", 2e-5)


def test_tensors_stay_where_they_are(data):
    """Tensor inputs keep their device (here the CPU) whatever ``device``
    says; numpy inputs would go to ``device``."""
    X, y = torch.as_tensor(data[0]), torch.as_tensor(_y(data, "binomial"))
    got = admm_tpu_torch.logistic_lasso_path(X, y, nlambda=3, maxit=5)
    assert got.coef.device.type == "cpu" and got.coef.dtype == torch.float32


ERRORS = {
    "alpha_zero": (dict(alpha=0.0), ValueError, "alpha must be in"),
    "alpha_above_one": (dict(alpha=1.5), ValueError, "alpha must be in"),
    "hessian": (dict(hessian="newton"), ValueError, "hessian must be"),
    "path_mode": (dict(path_mode="activeset"), ValueError,
                  "path_mode must be 'auto', 'scan' or 'batch'"),
    "offset_shape": (dict(offset=np.zeros(3)), ValueError,
                     "offset must have one entry per row"),
    "pf_shape": (dict(penalty_factor=np.ones(3)), ValueError,
                 "penalty_factor must have one entry per column"),
    "pf_negative": (dict(penalty_factor=-np.ones(P)), ValueError,
                    "penalty_factor entries must be >= 0"),
    "pf_all_zero": (dict(penalty_factor=np.zeros(P)), ValueError,
                    "at least one positive"),
    "exclude_range": (dict(exclude=[P]), ValueError,
                      "exclude indices must be in"),
    "limits_sign": (dict(lower_limits=0.5), ValueError,
                    "limits must satisfy lower <= 0 <= upper"),
    "dfmax_zero": (dict(dfmax=0, lambda_min_ratio=0.5, nlambda=3,
                        penalty_factor=np.r_[0.0, np.ones(P - 1)]),
                   ValueError, "dfmax/pmax exclude even the largest-lambda"),
    # Ported: a traced path runs (and forces "scan"), raising nothing.
    "trace_len": (dict(trace_len=10, nlambda=3), None, None),
    # Ported: a row-sharded path runs on the engine, raising nothing
    # (tests/test_torch_mesh.py holds its parity).
    "data_mesh": (dict(data_mesh="mesh", nlambda=3), None, None),
}


@pytest.mark.parametrize("label", list(ERRORS))
def test_validation_errors(data, label):
    kw, exc, match = ERRORS[label]
    if exc is None:
        if kw.get("data_mesh") == "mesh":
            kw = dict(kw, data_mesh=torch_mesh(4, devices=["cpu"] * 4))
        res = admm_tpu_torch.logistic_lasso_path(
            data[0], _y(data, "binomial"), device="cpu", **kw)
        if "trace_len" in kw:
            assert res.trace.shape == (3, kw["trace_len"], 5)
        else:
            ref = admm_tpu_torch.logistic_lasso_path(
                data[0], _y(data, "binomial"), device="cpu", nlambda=3)
            np.testing.assert_allclose(res.coef.numpy(), ref.coef.numpy(),
                                       atol=1e-4)
        return
    with pytest.raises(exc, match=match):
        admm_tpu_torch.logistic_lasso_path(data[0], _y(data, "binomial"),
                                           device="cpu", **kw)


def test_fixed_hessian_needs_a_curvature_bound(data):
    with pytest.raises(ValueError, match="'poisson' has unbounded curvature"):
        admm_tpu_torch.poisson_lasso_path(data[0], _y(data, "poisson"),
                                          hessian="fixed", device="cpu")
