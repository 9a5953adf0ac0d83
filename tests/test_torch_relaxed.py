"""The port's relaxed lasso (``admm_tpu_torch.models.relaxed``) and its CV
driver against the JAX package's, on the same seeded numpy inputs and
``device="cpu"``.

Bars: the (gamma, lambda) coefficient grid within 1e-5 (plus rtol 1e-5)
in float32 and 1e-9 in float64 at an explicit rho, the underlying path's
``niter`` within 1; ``gamma = 1`` is the port's own ``lasso_path`` to the
bit.  CV: cvm rtol 1e-4, ``lambda_min`` as a grid index and the same
``gamma_min``.  The port's one-pass folds are the batch path of the
gaussian CV (one tall-batch kernel launch per fold on the card), the JAX
package's its vmapped engine: the same solutions to solver tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models.relaxed import _masked_refits as jrefits
from admm_tpu_torch.models.relaxed import _masked_refits

torch.set_num_threads(1)

RHO = 20.0
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "f64": (jnp.float64, torch.float64, 1e-9)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, p = 120, 15
    X = rng.normal(size=(n, p))
    b = np.r_[rng.uniform(1.0, 2.0, 4), np.zeros(p - 4)]
    return X, 1.0 + X @ b + 0.5 * rng.normal(size=n)


CASES = {
    "scan": {},
    "batch": dict(path_mode="batch"),
    "gammas": dict(gammas=(1.0, 0.0, 0.6)),
    "weights": dict(weights="obs"),
    "no_standardize": dict(standardize=False, intercept=False),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_relaxed_lasso_path_matches_jax(data, case, dt):
    X, y = data
    jdt, tdt, atol = DTYPES[dt]
    rtol = 1e-5 if dt == "f32" else 1e-7
    kw = dict(CASES[case], nlambda=6, rho=RHO)
    if kw.get("weights") == "obs":
        kw["weights"] = np.random.default_rng(3).uniform(0.5, 2.0, len(y))
    ref = admm_tpu.relaxed_lasso_path(X, y, dtype=jdt, **kw)
    got = admm_tpu_torch.relaxed_lasso_path(X, y, dtype=tdt, device="cpu",
                                            **kw)
    np.testing.assert_array_equal(got.gammas.numpy(),
                                  np.asarray(ref.gammas))
    for f in ("coef", "beta0", "refit_coef", "refit_beta0"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=atol,
                                   rtol=rtol, err_msg=f)
    gap = np.abs(got.fit.niter.numpy().astype(int)
                 - np.asarray(ref.fit.niter))
    assert gap.max() <= 1
    # gamma = 1 is the lasso path itself, to the bit.
    lasso_kw = {k: v for k, v in kw.items() if k != "gammas"}
    lasso = admm_tpu_torch.lasso_path(X, y, dtype=tdt, device="cpu",
                                      **lasso_kw)
    g1 = int(np.flatnonzero(got.gammas.numpy() == 1.0)[0])
    assert torch.equal(got.coef[g1], lasso.coef)
    assert torch.equal(got.beta0[g1], lasso.beta0)


def test_masked_refits_match_jax(data):
    """The batched Cholesky of the L masked systems against the JAX
    package's sequenced ones, float64, including a support past n (the
    jitter's ridge) and an empty one."""
    X, y = data
    Xw, yw = X[:10], y[:10]
    rng = np.random.default_rng(5)
    masks = (rng.uniform(size=(4, 15)) < 0.4).astype(float)
    masks[0] = 0.0
    masks[1] = 1.0          # 15 > 10 rows
    for Xa, ya in ((X, y), (Xw, yw)):
        b0_r, c_r = jrefits(jnp.asarray(Xa), jnp.asarray(ya),
                            jnp.asarray(masks), standardize_x=True,
                            intercept=True)
        b0_g, c_g = _masked_refits(torch.as_tensor(Xa), torch.as_tensor(ya),
                                   torch.as_tensor(masks), standardize_x=True,
                                   intercept=True)
        np.testing.assert_allclose(c_g.numpy(), np.asarray(c_r), rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(b0_g.numpy(), np.asarray(b0_r),
                                   rtol=1e-7, atol=1e-9)


def test_relaxed_refuses_limits_like_jax(data):
    X, y = data
    with pytest.raises(NotImplementedError) as ref:
        admm_tpu.relaxed_lasso_path(X, y, lower_limits=0.0)
    with pytest.raises(NotImplementedError) as got:
        admm_tpu_torch.relaxed_lasso_path(X, y, lower_limits=0.0,
                                          device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("case", ["onepass", "loop", "weights"])
def test_cv_relaxed_lasso_matches_jax(data, case):
    X, y = data
    kw = dict(foldid=np.arange(len(y)) % 4, nlambda=6, rho=RHO,
              cv_mode="loop" if case == "loop" else "onepass")
    if case == "weights":
        kw["weights"] = np.random.default_rng(4).uniform(0.5, 2.0, len(y))
    ref = admm_tpu.cv_relaxed_lasso_path(X, y, **kw)
    got = admm_tpu_torch.cv_relaxed_lasso_path(X, y, device="cpu", **kw)
    assert got["cvm"].shape == ref["cvm"].shape == (5, 6)
    np.testing.assert_allclose(got["cvm"], ref["cvm"], rtol=1e-4)
    np.testing.assert_allclose(got["cvsd"], ref["cvsd"], rtol=1e-4)
    li = lambda r: int(np.argmin(np.abs(r["lambdas"] - r["lambda_min"])))
    assert li(got) == li(ref) and got["gamma_min"] == ref["gamma_min"]
    np.testing.assert_array_equal(got["foldid"], ref["foldid"])
    np.testing.assert_allclose(got["fit"].coef.numpy(),
                               np.asarray(ref["fit"].coef), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="cv_mode='onepass' supports"):
        admm_tpu_torch.cv_relaxed_lasso_path(X, y, device="cpu",
                                             cv_mode="onepass", dfmax=3)
