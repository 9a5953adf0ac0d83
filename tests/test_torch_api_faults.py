"""Two places where the port answered otherwise than the JAX package, on
the same numpy inputs: the fits' ``trace`` attribute (``None`` when
tracing is off) and the errors of ``path_mode="activeset"`` (the JAX
package's ``ValueError`` where it refuses the mode, before anything that
the port has not ported yet)."""
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tall():
    rng = np.random.default_rng(41)
    n, p = 80, 12
    X = rng.normal(size=(n, p))
    return X, X @ rng.uniform(-1, 1, p) + 0.3 * rng.normal(size=n)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(42)
    n, p = 30, 70
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    x0 = np.zeros(p)
    x0[:4] = rng.normal(size=4)
    return A, A @ x0


def _fit(pkg, kind, data, **kw):
    """One small fit of each builder, ``pkg`` being either package."""
    X, y = data
    if kind == "lasso":
        return pkg.admm_lasso(X, y, **kw).penalty(nlambda=4).opts(
            maxit=50).fit()
    if kind == "lad":
        return pkg.admm_lad(X, y, **kw).opts(maxit=50).fit()
    return pkg.admm_bp(X, y, **kw).opts(maxit=50).fit()


@pytest.mark.parametrize("kind", ["lasso", "lad", "bp"])
def test_fits_have_trace_none_as_in_the_reference(tall, wide, kind):
    data = wide if kind == "bp" else tall
    ref = _fit(admm_tpu, kind, data)
    got = _fit(admm_tpu_torch, kind, data, device="cpu")
    assert ref.trace is None and got.trace is None
    assert type(got).__name__ == type(ref).__name__


@pytest.mark.parametrize("case", ["tall", "penalty_factor", "lower_limits",
                                  "upper_limits", "exclude"])
def test_activeset_raises_the_reference_value_error(tall, wide, case):
    """The reference's order: n > p first, then ``penalty_factor``, then
    limits or ``exclude``; the same exception type and message."""
    X, y = tall if case == "tall" else wide
    p = X.shape[1]
    kw = {"tall": {}, "penalty_factor": dict(penalty_factor=np.ones(p)),
          "lower_limits": dict(lower_limits=0.0),
          "upper_limits": dict(upper_limits=1.0),
          "exclude": dict(exclude=[0])}[case]
    with pytest.raises(ValueError) as ref:
        admm_tpu.lasso_path(X, y, path_mode="activeset", **kw)
    with pytest.raises(ValueError) as got:
        admm_tpu_torch.lasso_path(X, y, path_mode="activeset", device="cpu",
                                  **kw)
    assert str(got.value) == str(ref.value)


def test_activeset_tall_check_comes_before_the_options(tall):
    """On tall data the shape is refused first, whatever else is given."""
    X, y = tall
    kw = dict(path_mode="activeset", penalty_factor=np.ones(X.shape[1]),
              exclude=[0])
    with pytest.raises(ValueError, match="wide-regime") as ref:
        admm_tpu.lasso_path(X, y, **kw)
    with pytest.raises(ValueError, match="wide-regime") as got:
        admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("pkg", [admm_tpu, admm_tpu_torch])
def test_builder_takes_activeset_and_fit_raises_on_tall_data(tall, pkg):
    """``opts(path_mode="activeset")`` takes the mode, as the reference's
    does; ``fit()`` then raises the reference's ValueError on tall data."""
    X, y = tall
    kw = dict(device="cpu") if pkg is admm_tpu_torch else {}
    model = pkg.admm_lasso(X, y, **kw).opts(path_mode="activeset")
    assert model.path_mode == "activeset"
    with pytest.raises(ValueError, match="wide-regime"):
        model.fit()


def test_activeset_on_wide_data_is_not_ported(wide):
    """With no refused option the mode reaches the active-set solver,
    which the port now has: the path and the builder's fit run it and
    agree with the JAX package's (full parity:
    ``tests/test_torch_activeset.py``)."""
    X, y = wide
    kw = dict(nlambda=4, rho=1.0)
    ref = admm_tpu.lasso_path(X, y, path_mode="activeset", **kw)
    got = admm_tpu_torch.lasso_path(X, y, path_mode="activeset",
                                    device="cpu", **kw)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=1e-5)
    fit = admm_tpu_torch.admm_lasso(X, y, device="cpu").penalty(
        nlambda=4).opts(path_mode="activeset", rho=1.0).fit()
    np.testing.assert_allclose(fit.beta.toarray()[1:].T, got.coef.numpy(),
                               atol=1e-6)
