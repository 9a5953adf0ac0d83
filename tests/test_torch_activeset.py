"""The wide active-set path of the port
(``models/lasso.py::_solve_path_wide_activeset``, ``path_mode=
"activeset"`` and the scan-mode auto-dispatch) against the JAX package's,
on the same seeded numpy inputs and ``device="cpu"``.

Bars: coefficients within 1e-5 in float32 at an explicit rho (1e-9 in
float64), ``niter`` within 1 per lambda, with power iteration started from
the JAX package's vector (the wide step is 1/sprad whatever rho is).  The
top-S refresh must break ties as ``lax.top_k`` does (the lower index first): the first refresh ranks an all-zero vector,
later ones many exact zeros, and a different tie order gathers different
columns.  The auto-dispatch threshold is 20000 columns; it is covered by
lowering both packages' constant, never by a 20000-column matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models import lasso as jlasso
from admm_tpu.data.standardize import standardize as jstandardize
from admm_tpu_torch.data.standardize import standardize
from admm_tpu_torch.models import lasso as tlasso

from _torch_parity import jax_start_vector  # noqa: F401  (a fixture)

torch.set_num_threads(1)

RHO = 1.0


def _problem(n, p, seed, k=5):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[:k] = rng.uniform(1.0, 2.0, k) * rng.choice([-1, 1], k)
    X = rng.normal(size=(n, p))
    return X, X @ b + 0.5 * rng.normal(size=n)


@pytest.fixture(scope="module")
def wide():
    return _problem(30, 60, 7)


def _check(got, ref, atol=1e-5):
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=atol)
    np.testing.assert_allclose(got.beta0.numpy(), np.asarray(ref.beta0),
                               atol=atol)
    gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
    assert gap.max() <= 1


@pytest.mark.parametrize("case", ["lasso", "enet", "user_grid",
                                  "no_standardize"])
def test_activeset_path_matches_jax(wide, case, jax_start_vector):
    X, y = wide
    kw = dict(path_mode="activeset", rho=RHO, nlambda=8)
    if case == "enet":
        kw["alpha"] = 0.5
    if case == "user_grid":
        kw["lambdas"] = np.geomspace(2.0, 0.05, 6)
    if case == "no_standardize":
        kw.update(standardize=False, intercept=False)
    name = "enet_path" if case == "enet" else "lasso_path"
    ref = getattr(admm_tpu, name)(X, y, **kw)
    got = getattr(admm_tpu_torch, name)(X, y, device="cpu", **kw)
    _check(got, ref)
    # The active-set path solves the wide Lasso: it agrees with the dense
    # scan to solver tolerance.
    dense = getattr(admm_tpu_torch, name)(X, y, device="cpu",
                                          **dict(kw, path_mode="scan"))
    np.testing.assert_allclose(got.coef.numpy(), dense.coef.numpy(),
                               atol=5e-4)


@pytest.mark.parametrize("s_max", [4, 9, 20])
def test_capped_support_breaks_ties_like_top_k(wide, s_max,
                                                jax_start_vector):
    """S below p, where the refresh's tie order decides which columns are
    gathered: the first refresh ranks the all-zero vector (the grid's top
    lambda keeps x = 0), later refreshes many exact zeros."""
    X, y = wide
    Xs_j, ys_j, st_j = jstandardize(jnp.asarray(X, jnp.float32),
                                    jnp.asarray(y, jnp.float32),
                                    standardize_x=True, intercept=True)
    Xs, ys, st = standardize(torch.as_tensor(X, dtype=torch.float32),
                             torch.as_tensor(y, dtype=torch.float32),
                             standardize_x=True, intercept=True)
    lams = np.geomspace(1.0, 0.05, 6) * float(np.max(np.abs(
        np.asarray(Xs_j).T @ np.asarray(ys_j))))
    args = (RHO, 10000, 1e-5, 1e-5, 1.0, False)
    ref_c, ref_n, _ = jlasso._solve_path_wide_activeset(
        Xs_j, ys_j, jnp.asarray(lams, jnp.float32), *args, s_max=s_max)
    got_c, got_n, _ = tlasso._solve_path_wide_activeset(
        Xs, ys, torch.as_tensor(lams, dtype=torch.float32), *args,
        s_max=s_max)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=1e-5)
    assert np.abs(got_n.numpy().astype(int) - np.asarray(ref_n)).max() <= 1
    assert (np.asarray(got_c[0]) == 0).all()       # the top of the grid
    assert ((got_c.numpy() != 0).sum(axis=1) <= s_max).all()


def test_top_support_ties_go_to_the_lower_index():
    """``_top_support`` against ``lax.top_k`` (sorted) on vectors full of
    ties: all zeros, and a few nonzeros among equal magnitudes."""
    rng = np.random.default_rng(0)
    cases = [np.zeros(50), np.r_[np.zeros(20), 1.0, -1.0, np.zeros(8), 2.0,
                                 np.zeros(19)],
             rng.choice([0.0, 0.5, -0.5, 1.5], size=64)]
    for x in cases:
        for S in (1, 3, 10, len(x)):
            _, ref = jax.lax.top_k(jnp.abs(jnp.asarray(x, jnp.float32)), S)
            got = tlasso._top_support(torch.as_tensor(x, dtype=torch.float32),
                                      S)
            np.testing.assert_array_equal(got.numpy(),
                                          np.sort(np.asarray(ref)))


def test_scan_auto_dispatches_at_the_threshold(monkeypatch,
                                              jax_start_vector):
    """Scan-mode wide paths at p >= _ACTIVESET_AUTO_P take the active set
    in both packages (the constant lowered to this problem's width): the
    auto-dispatched path equals the explicit "activeset" one, and the two
    packages agree; one column fewer keeps the dense scan."""
    X, y = _problem(28, 50, 11)
    monkeypatch.setattr(jlasso, "_ACTIVESET_AUTO_P", 50)
    monkeypatch.setattr(tlasso, "_ACTIVESET_AUTO_P", 50)
    calls = []
    real = tlasso._solve_path_wide_activeset
    monkeypatch.setattr(tlasso, "_solve_path_wide_activeset",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(rho=RHO, nlambda=6)
    ref = admm_tpu.lasso_path(X, y, dtype=jnp.float64, **kw)
    kw["dtype"] = torch.float64
    got = admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    _check(got, ref, atol=1e-9)
    explicit = admm_tpu_torch.lasso_path(X, y, path_mode="activeset",
                                         device="cpu", **kw)
    np.testing.assert_array_equal(got.coef.numpy(), explicit.coef.numpy())
    np.testing.assert_array_equal(got.niter.numpy(), explicit.niter.numpy())
    assert len(calls) == 2
    # One column short of the threshold, a traced path, a factor path and
    # "batch" keep the dense engines (as in the JAX package).
    monkeypatch.setattr(tlasso, "_ACTIVESET_AUTO_P", 51)
    admm_tpu_torch.lasso_path(X, y, device="cpu", **kw)
    monkeypatch.setattr(tlasso, "_ACTIVESET_AUTO_P", 50)
    admm_tpu_torch.lasso_path(X, y, device="cpu", trace_len=4, **kw)
    admm_tpu_torch.lasso_path(X, y, device="cpu", penalty_factor=np.ones(50),
                              **kw)
    admm_tpu_torch.lasso_path(X, y, device="cpu", path_mode="batch", **kw)
    assert len(calls) == 2
