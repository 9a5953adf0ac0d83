"""The port's plots (``admm_tpu_torch.plotting`` and the three
``fit.plot()``) against the JAX package's, on the Agg backend: the same
result (converted through ``interop`` where the port has the type) drawn
by both, and the plotted arrays compared — each line's
``get_xydata()``, the scatter offsets, the error bars' and stems'
segments, the step lines and the top axis' Df ticks.  The port's helpers
take tensors, the JAX package's numpy arrays.

Bars: identical arrays where both draw the same numbers (float64 1e-12);
the builders' fits, computed by each package, within the builders'
parity bars (float32 Lasso 1e-5, float64 LAD and BP 1e-8).
"""
import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib import pyplot as plt  # noqa: E402

import admm_tpu  # noqa: E402
import admm_tpu_torch  # noqa: E402
from admm_tpu import plotting as jplot  # noqa: E402
from admm_tpu_torch import plotting as tplot  # noqa: E402
from admm_tpu_torch.interop import from_reference  # noqa: E402

torch.set_num_threads(1)


def _drawn(ax):
    """Everything an axis draws, as arrays: its lines, its collections'
    offsets and segments, its title and the child axes' ticks."""
    out = [line.get_xydata() for line in ax.lines]
    for c in ax.collections:
        out.append(np.asarray(c.get_offsets()))
        if hasattr(c, "get_segments"):
            out.extend(np.asarray(s) for s in c.get_segments())
    for child in ax.child_axes:
        out.append(np.asarray(child.get_xticks()))
        out.append(np.array([t.get_text() for t in child.get_xticklabels()]))
    return out, ax.get_title(), ax.get_xlabel()


def assert_same_plot(got_ax, ref_ax, atol=1e-12, rtol=0.0):
    got, ref = _drawn(got_ax), _drawn(ref_ax)
    assert got[1:] == ref[1:]
    assert len(got[0]) == len(ref[0]) > 0
    for a, b in zip(got[0], ref[0]):
        if a.dtype.kind in "US":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
    plt.close(got_ax.figure)
    plt.close(ref_ax.figure)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 8))
    y = 1.0 + X[:, :3] @ np.array([1.5, -1.0, 0.5]) + 0.5 * rng.normal(
        size=60)
    A = rng.normal(size=(20, 50)) / np.sqrt(20)
    x0 = np.zeros(50)
    x0[[3, 17, 40]] = [1.0, -2.0, 0.5]
    t = rng.exponential(size=60) * np.exp(-0.5 * X[:, 0])
    event = (rng.uniform(size=60) < 0.7) * 1.0
    return dict(X=X, y=y, A=A, b=A @ x0, time=t, event=event,
                X12=np.concatenate([X, rng.normal(size=(60, 4))], axis=1))


@pytest.fixture(scope="module")
def path(data):
    """A float64 JAX Lasso path and its port copy (tensors)."""
    ref = admm_tpu.lasso_path(data["X"], data["y"], nlambda=6,
                              dtype=jnp.float64)
    return from_reference(ref), ref


def _beta(res, lib):
    b0, coef = res.beta0, res.coef
    if lib is np:
        return np.concatenate([np.asarray(b0)[None], np.asarray(coef).T])
    return torch.cat([b0[None], coef.mT])


@pytest.mark.parametrize("helper", [
    "solution_path", "path_norm", "path_lambda_label", "path_dev", "stem",
    "fitted_vs_observed", "cv_curve", "survfit", "survfit_strata",
])
def test_helper_draws_what_the_jax_package_draws(data, path, helper):
    got, ref = path
    X, y = data["X"], data["y"]
    if helper == "solution_path":
        got_ax = tplot.plot_solution_path(got.lambdas, _beta(got, torch))
        ref_ax = jplot.plot_solution_path(np.asarray(ref.lambdas),
                                          _beta(ref, np))
    elif helper.startswith("path_"):
        kw = {"path_norm": dict(xvar="norm"),
              "path_lambda_label": dict(xvar="lambda", label=True),
              "path_dev": dict(xvar="dev", X=X, y=y)}[helper]
        got_ax = tplot.plot_path(got, **kw)
        ref_ax = jplot.plot_path(ref, **kw)
        if helper == "path_lambda_label":
            assert ([t.get_text() for t in got_ax.texts]
                    == [t.get_text() for t in ref_ax.texts] != [])
    elif helper == "stem":
        got_ax = tplot.plot_stem(got.coef[2])
        ref_ax = jplot.plot_stem(np.asarray(ref.coef[2]))
    elif helper == "fitted_vs_observed":
        fit = got.beta0[3] + torch.as_tensor(X) @ got.coef[3]
        got_ax = tplot.plot_fitted_vs_observed(fit, torch.as_tensor(y))
        ref_ax = jplot.plot_fitted_vs_observed(
            np.asarray(ref.beta0[3]) + X @ np.asarray(ref.coef[3]), y)
    elif helper == "cv_curve":
        jcv = admm_tpu.cv_lasso_path(X, y, nfolds=3, nlambda=6,
                                     dtype=jnp.float64)
        cv = admm_tpu_torch.CVResult(*(from_reference(v) if f == "fit"
                                       else v for f, v in
                                       zip(jcv._fields, jcv)))
        got_ax, ref_ax = tplot.plot_cv_curve(cv), jplot.plot_cv_curve(jcv)
    else:
        jcox = admm_tpu.cox_lasso_path(X, data["time"], data["event"],
                                       nlambda=4, dtype=jnp.float64)
        kw = dict(Xnew=X[:5], lam=float(jcox.lambdas[2]))
        jsf = admm_tpu.survfit_cox(jcox, X, data["time"], data["event"],
                                   **kw)
        sf = admm_tpu_torch.survfit_cox(from_reference(jcox), X,
                                        data["time"], data["event"], **kw)
        if helper == "survfit_strata":
            sf, jsf = dict(a=sf, b=sf), dict(a=jsf, b=jsf)
        got_ax, ref_ax = tplot.plot_survfit(sf), jplot.plot_survfit(jsf)
        assert got_ax.get_ylim() == ref_ax.get_ylim()
        assert_same_plot(got_ax, ref_ax, atol=1e-10, rtol=1e-10)
        return
    assert_same_plot(got_ax, ref_ax)


def test_helpers_refuse_as_the_jax_package(path):
    got, ref = path
    for call in (lambda m, r: m.plot_solution_path(r.lambdas[:1], None),
                 lambda m, r: m.plot_path(r, xvar="bogus"),
                 lambda m, r: m.plot_path(r, xvar="dev")):
        with pytest.raises(ValueError) as want:
            call(jplot, ref)
        with pytest.raises(ValueError) as have:
            call(tplot, got)
        assert str(have.value) == str(want.value)
    plt.close("all")


@pytest.mark.parametrize("fit", ["lasso", "enet_parallel", "lad", "bp"])
def test_fit_plot_draws_what_the_jax_package_draws(data, fit):
    """``fit.plot()`` of the three fit classes: the solution path (also
    of a consensus fit), the LAD fitted-vs-observed scatter (the fit
    keeps x and y on the host) and the BP stem plot."""
    X, y, A, b = data["X"], data["y"], data["A"], data["b"]
    if fit == "lasso":
        build = lambda m, **kw: m.admm_lasso(X, y, **kw).penalty(nlambda=6)
        tol = dict(atol=1e-5, rtol=1e-5)
    elif fit == "enet_parallel":
        X = data["X12"]
        build = lambda m, **kw: m.admm_enet(X, y, **kw).penalty(
            nlambda=5, alpha=0.5).parallel(nthread=2)
        tol = dict(atol=1e-5, rtol=1e-5)
    elif fit == "lad":
        build = lambda m, **kw: m.admm_lad(X, y, **kw)
        tol = dict(atol=1e-8, rtol=1e-8)
    else:
        build = lambda m, **kw: m.admm_bp(A, b, **kw)
        tol = dict(atol=1e-8, rtol=1e-8)
    f64 = {} if fit in ("lasso", "enet_parallel") else dict(
        dtype=torch.float64)
    if fit == "enet_parallel":
        # Tensor inputs stay on their own device (here the CPU).
        got = admm_tpu_torch.admm_enet(
            torch.as_tensor(X), torch.as_tensor(y)).penalty(
            nlambda=5, alpha=0.5).parallel(nthread=2).fit()
    else:
        got = build(admm_tpu_torch, device="cpu", **f64).fit()
    ref = build(admm_tpu).fit()
    if fit == "lad":
        assert isinstance(got._x, np.ndarray) and isinstance(got._y,
                                                             np.ndarray)
    assert_same_plot(got.plot(), ref.plot(), **tol)
