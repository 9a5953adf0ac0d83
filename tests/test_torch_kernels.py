"""The port's kernels, in their plain PyTorch form on the CPU, against the
JAX package's Pallas kernels in interpret mode.

Both sides get the same inputs, built once by the JAX package and handed
across with ``admm_tpu_torch.interop`` (the same Minv, X'y, rho, sprad,
lambda0 and lambda grid), so a kernel is compared with a kernel and not
with a power-iteration rounding.  Shapes and bars are those of
``tests/test_pallas_kernels.py``: coefficients within 1e-5 in float32;
niter within 1 per lane for the batched kernels (the two sides accumulate
their matrix products in different orders); scan niter totals within
max(3, 10%) (a one-iteration shift at one lambda moves the next warm
start); and the wide lane above lambda0 exactly 0.  The LAD, BP and GLM
kernels are held to the bars of their own Pallas tests, stated at each
test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.data.standardize import standardize
from admm_tpu.core.prox import l2norm
from admm_tpu.linalg import (chol_inverse, dot, gram, ridge_inverse,
                             spectral_radius_sym, tgram)
from admm_tpu.models.glm import (_glm_auto_rho, _glm_fixed_minv, binomial,
                                 glm_lasso_path, huber, prep_design,
                                 recover_glm)
from admm_tpu.models.lasso import _wide_setup
from admm_tpu.ops.bp_kernel import bp_batch_solve_pallas
from admm_tpu.ops.glm_kernel import glm_batch_path_pallas
from admm_tpu.ops.lad_kernel import lad_solve_pallas
from admm_tpu.ops.tall_path import (tall_path_batch_pallas,
                                    tall_path_scan_pallas)
from admm_tpu.ops.wide_path import wide_path_batch_pallas
from admm_tpu_torch import kernels
from admm_tpu_torch.interop import to_torch
from admm_tpu_torch.kernels import _common as kcommon
from admm_tpu_torch.kernels import bp, glm, lad, tall_path, wide_path
from admm_tpu_torch.kernels._common import check_cuda_input
from admm_tpu_torch.models import bp as tbp
from admm_tpu_torch.models import glm as tglm
from admm_tpu_torch.models import lad as tlad
from admm_tpu_torch.models import lasso as tlasso

torch.set_num_threads(1)

MAXIT = 2000


@pytest.fixture(scope="module")
def tall_inputs():
    """n = 200, p = 40, k = 10 (test_pallas_kernels.py::problem)."""
    rng = np.random.default_rng(3)
    n, p, k = 200, 40, 10
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.4)
    y = 1.0 + X @ b + 0.3 * rng.normal(size=n)
    Xs, ys, _ = standardize(jnp.asarray(X, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            standardize_x=True, intercept=True)
    lam0 = float(jnp.max(jnp.abs(dot(Xs.T, ys))))
    ilams = jnp.asarray(np.geomspace(lam0, lam0 * 1e-3, k), jnp.float32)
    XtX = gram(Xs)
    Xty = dot(Xs.T, ys)
    rho = jnp.cbrt(spectral_radius_sym(XtX)) * ilams[0] ** (2.0 / 3.0)
    Minv = ridge_inverse(XtX, rho)
    return dict(jax=(Minv, Xty, ilams, rho), p=p,
                torch=tuple(to_torch(a) for a in (Minv, Xty, ilams, rho)))


@pytest.fixture(scope="module")
def wide_inputs():
    """n = 60, p = 150, k = 9, first lambda above lambda0
    (test_pallas_kernels.py::wide_problem)."""
    rng = np.random.default_rng(11)
    n, p, k = 60, 150, 9
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:12] = rng.normal(size=12)
    y = X @ b + 0.2 * rng.normal(size=n)
    Xs, ys, _ = standardize(jnp.asarray(X, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            standardize_x=True, intercept=True)
    lam0 = float(jnp.max(jnp.abs(dot(Xs.T, ys))))
    ilams = jnp.asarray(np.geomspace(lam0 * 1.1, lam0 * 1e-2, k),
                        jnp.float32)
    return dict(Xs=Xs, ys=ys, ilams=ilams, n=n, p=p)


def _pallas_wide(w, alpha):
    lambda0, sprad, rho = _wide_setup(w["Xs"], w["ys"], w["ilams"], -1.0,
                                      alpha, False)
    out = wide_path_batch_pallas(w["Xs"], w["ys"], w["ilams"], rho, sprad,
                                 lambda0, 1e-5, 1e-5, alpha, MAXIT,
                                 true_n=w["n"], true_p=w["p"], interpret=True)
    return out, tuple(to_torch(a) for a in (w["Xs"], w["ys"], w["ilams"],
                                            rho, sprad, lambda0))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_batch_plain_matches_pallas(tall_inputs, alpha):
    Minv, Xty, ilams, rho = tall_inputs["jax"]
    z_ref, n_ref = tall_path_batch_pallas(Minv, Xty, ilams, rho, 1e-5, 1e-5,
                                          alpha, MAXIT,
                                          true_p=tall_inputs["p"],
                                          interpret=True)
    z, niter = tall_path.tall_path_batch_reference(
        *tall_inputs["torch"], 1e-5, 1e-5, alpha, MAXIT)
    assert z.dtype == torch.float32 and niter.dtype == torch.int32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    assert np.max(np.abs(niter.numpy() - np.asarray(n_ref))) <= 1


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_scan_plain_matches_pallas(tall_inputs, alpha):
    Minv, Xty, ilams, rho = tall_inputs["jax"]
    z_ref, n_ref = tall_path_scan_pallas(Minv, Xty, ilams, rho, 1e-5, 1e-5,
                                         alpha, MAXIT,
                                         true_p=tall_inputs["p"],
                                         interpret=True)
    z, niter = tall_path.tall_path_scan_reference(
        *tall_inputs["torch"], 1e-5, 1e-5, alpha, MAXIT)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-5)
    total = int(np.asarray(n_ref).sum())
    assert abs(int(niter.sum()) - total) <= max(3, int(0.1 * total))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_wide_batch_plain_matches_pallas(wide_inputs, alpha):
    (x_ref, n_ref), args = _pallas_wide(wide_inputs, alpha)
    x, niter = wide_path.wide_path_batch_reference(*args, 1e-5, 1e-5, alpha,
                                                   MAXIT)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-5)
    assert np.max(np.abs(niter.numpy() - np.asarray(n_ref))) <= 1
    # The first lambda is above lambda0: the all-zero exit is exact.
    assert torch.abs(x[0]).max().item() == 0.0


def test_wrappers_run_plain_form_on_cpu_without_launching(tall_inputs):
    """On CPU tensors each wrapper returns exactly its plain form's result
    and counts no launch."""
    kernels.reset_launch_counts()
    args = (*tall_inputs["torch"], 1e-5, 1e-5, 1.0, MAXIT)
    for wrap, plain in ((tall_path.tall_path_batch,
                         tall_path.tall_path_batch_reference),
                        (tall_path.tall_path_scan,
                         tall_path.tall_path_scan_reference)):
        a, b = wrap(*args), plain(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kernels.launch_counts() == {"tall_path_batch": 0,
                                       "tall_path_scan": 0,
                                       "wide_path_batch": 0,
                                       "wide_path_scan": 0,
                                       "lad_solve": 0,
                                       "bp_batch_solve": 0,
                                       "glm_batch_path": 0}


def test_wide_wrapper_runs_plain_form_on_cpu(wide_inputs):
    _, args = _pallas_wide(wide_inputs, 1.0)
    kernels.reset_launch_counts()
    a = wide_path.wide_path_batch(*args, 1e-5, 1e-5, 1.0, MAXIT)
    b = wide_path.wide_path_batch_reference(*args, 1e-5, 1e-5, 1.0, MAXIT)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kernels.launch_counts()["wide_path_batch"] == 0


def test_kernel_shape_rules():
    """The Lasso path kernels hold lane state in one block's shared memory
    (232448 bytes on sm_90, 2 KB kept for scratch); past that the path
    takes the engine, and the choice is made before any call."""
    assert tall_path.MAX_P == 7200
    assert tall_path.fits(1000) and tall_path.fits(7200)
    assert not tall_path.fits(7201) and not tall_path.fits(0)
    assert wide_path.fits(1000, 2000)
    assert wide_path.fits(1000, (57600 - 5000) // 3)
    assert not wide_path.fits(1000, (57600 - 5000) // 3 + 1)
    assert tlasso._use_kernel_tall(1000, torch.float32)
    assert not tlasso._use_kernel_tall(1000, torch.float64)
    assert not tlasso._use_kernel_tall(10000, torch.float32)
    assert tlasso._use_kernel_wide(1000, 2000, torch.float32)
    assert not tlasso._use_kernel_wide(1000, 2000, torch.float64)
    assert not tlasso._use_kernel_wide(20000, 2000, torch.float32)


def test_float32_path_goes_through_the_kernels(monkeypatch):
    """In float32 every path mode dispatches to its kernel wrapper;
    float64 and shapes past a kernel's rule take the engines."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tall_path, "tall_path_batch",
                        spy("batch", tall_path.tall_path_batch))
    monkeypatch.setattr(tall_path, "tall_path_scan",
                        spy("scan", tall_path.tall_path_scan))
    monkeypatch.setattr(wide_path, "wide_path_batch",
                        spy("wide", wide_path.wide_path_batch))
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(40, 8)), rng.normal(size=40)
    Xw, yw = rng.normal(size=(12, 30)), rng.normal(size=12)
    for mode in ("batch", "scan"):
        tlasso.lasso_path(X, y, nlambda=3, path_mode=mode, device="cpu")
    tlasso.lasso_path(Xw, yw, nlambda=3, path_mode="batch", device="cpu")
    assert calls == ["batch", "scan", "wide"]
    tlasso.lasso_path(X, y, nlambda=3, path_mode="batch", device="cpu",
                      dtype=torch.float64)
    tlasso.lasso_path(Xw, yw, nlambda=3, path_mode="scan", device="cpu")
    monkeypatch.setattr(tall_path, "MAX_P", 4)
    tlasso.lasso_path(X, y, nlambda=3, path_mode="batch", device="cpu")
    assert calls == ["batch", "scan", "wide"]


# ---------------------------------------------------------------------------
# LAD and BP (shapes of tests/test_pallas_kernels.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lad_inputs():
    """n = 300, p = 20, heavy-tailed noise
    (test_pallas_kernels.py::test_lad_kernel_matches_xla_solver)."""
    rng = np.random.default_rng(8)
    n, p = 300, 20
    X = rng.normal(size=(n, p))
    y = X @ rng.normal(size=p) + rng.standard_t(2, size=n)
    Xs, ys = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
    Ginv = chol_inverse(gram(Xs), jitter=1e-6)
    H = dot(Xs, dot(Ginv, Xs.T))
    return dict(X=X, Xs=Xs, ys=ys, Ginv=Ginv, H=H, ynorm=float(l2norm(ys)),
                n=n)


@pytest.fixture(scope="module")
def bp_inputs():
    """n = 60, p = 160, m = 5 signals of 6 nonzeros
    (test_pallas_kernels.py::test_bp_batch_kernel_matches_xla_solver)."""
    rng = np.random.default_rng(12)
    n, p, k, m = 60, 160, 6, 5
    X0 = np.zeros((m, p))
    for i in range(m):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    A = jnp.asarray(rng.normal(size=(n, p)) / np.sqrt(n), jnp.float32)
    B = jnp.asarray(X0, jnp.float32) @ A.T
    Winv = chol_inverse(tgram(A), jitter=1e-6)
    AAAB = dot(B, dot(Winv, A))
    return dict(A=A, Winv=Winv, AAAB=AAAB, X0=X0, p=p)


@pytest.mark.parametrize("rho", [1.0, 5.0])
def test_lad_plain_matches_pallas(lad_inputs, rho):
    """The terminal duals saturate and are path-dependent near the L1
    kinks, so, as in the Pallas kernel's own test, the invariant is the
    recovered coefficient vector (atol 5e-3) and its L1 objective
    (<= 1.001x), not the raw state."""
    w = lad_inputs
    ay_ref, az_ref, n_ref = lad_solve_pallas(
        w["H"], w["ys"], rho, 1e-5, 1e-5, w["ynorm"], MAXIT, true_n=w["n"],
        interpret=True)
    ay, az, niter = lad.lad_solve_reference(
        to_torch(w["H"]), to_torch(w["ys"]), rho, 1e-5, 1e-5, w["ynorm"],
        MAXIT)
    assert ay.dtype == az.dtype == torch.float32
    assert niter.dtype == torch.int32 and niter.dim() == 0
    assert 0 < int(niter) <= MAXIT and int(n_ref) > 0

    def coef_of(adj_y, adj_z):
        v = w["ys"] - jnp.asarray(adj_y) / rho + jnp.asarray(adj_z)
        return np.asarray(dot(w["Ginv"], dot(w["Xs"].T, v)))

    c_ref, c = coef_of(ay_ref, az_ref), coef_of(ay.numpy(), az.numpy())
    obj = lambda c: np.abs(np.asarray(w["ys"]) - w["X"] @ c).sum()
    np.testing.assert_allclose(c, c_ref, atol=5e-3)
    assert obj(c) <= obj(c_ref) * 1.001


@pytest.mark.parametrize("rho", [1.0, 5.0])
def test_bp_batch_plain_matches_pallas(bp_inputs, rho):
    """The Pallas test's bars: z within 1e-4, the true signals within
    1e-3, niter within max(3, 5%) per lane (the two sides accumulate
    their products in different orders)."""
    w = bp_inputs
    z_ref, n_ref = bp_batch_solve_pallas(w["A"], w["Winv"], w["AAAB"], rho,
                                         1e-6, 1e-6, 3000, true_p=w["p"],
                                         interpret=True)
    z, niter = bp.bp_batch_solve_reference(
        *(to_torch(w[k]) for k in ("A", "Winv", "AAAB")), rho, 1e-6, 1e-6,
        3000)
    assert z.dtype == torch.float32 and niter.dtype == torch.int32
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), w["X0"], atol=1e-3)
    for a, b in zip(niter.numpy(), np.asarray(n_ref)):
        assert abs(int(a) - int(b)) <= max(3, int(0.05 * int(b)))


def test_bp_plain_single_lane_equals_its_row_of_the_batch(bp_inputs):
    """Lanes never interact: lane i alone gives lane i of the batch, to
    the bit (what lets the kernel drop a converged lane from its list of
    active lanes, and m = 1 be the same kernel with one lane)."""
    A, Winv, AAAB = (to_torch(bp_inputs[k]) for k in ("A", "Winv", "AAAB"))
    z, niter = bp.bp_batch_solve_reference(A, Winv, AAAB, 5.0, 2e-5, 2e-5,
                                           3000)
    z1, n1 = bp.bp_batch_solve_reference(A, Winv, AAAB[2:3], 5.0, 2e-5, 2e-5,
                                         3000)
    assert torch.equal(z1[0], z[2]) and int(n1[0]) == int(niter[2])


def test_lad_bp_wrappers_run_plain_form_on_cpu(lad_inputs, bp_inputs):
    kernels.reset_launch_counts()
    args = (to_torch(lad_inputs["H"]), to_torch(lad_inputs["ys"]), 5.0, 2e-5,
            2e-5, lad_inputs["ynorm"], 50)
    for a, b in zip(lad.lad_solve(*args), lad.lad_solve_reference(*args)):
        assert torch.equal(a, b)
    args = (*(to_torch(bp_inputs[k]) for k in ("A", "Winv", "AAAB")), 5.0,
            2e-5, 2e-5, 50)
    for a, b in zip(bp.bp_batch_solve(*args),
                    bp.bp_batch_solve_reference(*args)):
        assert torch.equal(a, b)
    counts = kernels.launch_counts()
    assert counts["lad_solve"] == 0 and counts["bp_batch_solve"] == 0


def test_lad_bp_shape_rules():
    """LAD: the first kernel's bound, 6n floats in one block's 232448 -
    2048 bytes of shared memory, kept.  BP: the dispatch bound 8p + 4n <= 57600 floats, which was the
    first BP kernel's shared-memory size and is kept as the port's rule
    (the cooperative-grid kernel keeps lane state in device memory); there
    is no rule on the number of BP signals."""
    assert lad.MAX_N == 9600
    assert lad.fits(1000) and lad.fits(5000) and lad.fits(9600)
    assert not lad.fits(9601) and not lad.fits(0)
    assert bp.fits(1000, 2000)
    assert bp.fits(1000, (57600 - 4000) // 8)
    assert not bp.fits(1000, (57600 - 4000) // 8 + 1)
    assert not bp.fits(1000, 10000) and not bp.fits(0, 10)
    assert tlad._use_kernel_lad(1000, torch.float32, 0.5)
    assert not tlad._use_kernel_lad(1000, torch.float64, 0.5)
    assert not tlad._use_kernel_lad(1000, torch.float32, 0.3)
    assert not tlad._use_kernel_lad(10000, torch.float32, 0.5)
    assert tbp._use_kernel_bp(1000, 2000, torch.float32)
    assert not tbp._use_kernel_bp(1000, 2000, torch.float64)
    assert not tbp._use_kernel_bp(1000, 10000, torch.float32)


def test_float32_lad_and_bp_go_through_the_kernels(monkeypatch):
    """float32 LAD (tau = 0.5) and every float32 BP solve, one signal
    included, dispatch to the kernel wrappers; float64, other quantiles
    and shapes past a kernel's rule take the engine."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(lad, "lad_solve", spy("lad", lad.lad_solve))
    monkeypatch.setattr(bp, "bp_batch_solve", spy("bp", bp.bp_batch_solve))
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(40, 5)), rng.normal(size=40)
    A, B = rng.normal(size=(10, 30)), rng.normal(size=(3, 10))
    kw = dict(device="cpu", maxit=20)
    tlad.lad_fit(X, y, **kw)
    tlad.quantile_fit(X, y, tau=0.5, **kw)
    tbp.bp_fit(A, B[0], **kw)
    tbp.bp_fit_batch(A, B, **kw)
    assert calls == ["lad", "lad", "bp", "bp"]
    tlad.lad_fit(X, y, dtype=torch.float64, **kw)
    tlad.quantile_fit(X, y, tau=0.3, **kw)
    tbp.bp_fit(A, B[0], dtype=torch.float64, **kw)
    tbp.bp_fit_batch(A, B, dtype=torch.float64, **kw)
    monkeypatch.setattr(lad, "MAX_N", 8)
    monkeypatch.setattr(bp, "_SMEM_FLOATS", 64)
    tlad.lad_fit(X, y, **kw)
    tbp.bp_fit(A, B[0], **kw)
    assert calls == ["lad", "lad", "bp", "bp"]


# ---------------------------------------------------------------------------
# GLM (shapes of tests/test_pallas_kernels.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def glm_inputs():
    """n = 300, p = 16, 6 lambdas, a Bernoulli and a noisy response
    (test_pallas_kernels.py::test_glm_kernel_matches_xla_batch_solver)."""
    rng = np.random.default_rng(51)
    n, p = 300, 16
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[:4] = [1.5, -2.0, 1.0, 0.5]
    ys = {"binomial": (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ b))))
          .astype(np.float32),
          "huber": (X @ b + 0.3 * rng.normal(size=n)).astype(np.float32)}
    fams = {"binomial": binomial(), "huber": huber(1.345)}
    Xa, pen_mask, mean_x, sd_x = prep_design(jnp.asarray(X), True, True)
    return dict(X=X, ys=ys, fams=fams, Xa=Xa, pen_mask=pen_mask,
                mean_x=mean_x, sd_x=sd_x, n=n, q=p + 1)


def _glm_args(w, name, alpha):
    """What both kernels get: the JAX package's Minv, rho and lambda grid."""
    fam, y = w["fams"][name], w["ys"][name]
    ref = glm_lasso_path(w["X"], y, fam, nlambda=6, path_mode="batch",
                         hessian="fixed", alpha=alpha, eps_abs=1e-6,
                         eps_rel=1e-6, dtype=jnp.float32)
    rho = _glm_auto_rho(fam, -1.0, jnp.float32)
    Minv = _glm_fixed_minv(w["Xa"], fam, rho)
    lams = jnp.asarray(ref.lambdas, jnp.float32)
    return ref, (w["Xa"], Minv, jnp.asarray(y), w["pen_mask"], lams, rho)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("newton_steps", [1, 2])
@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_glm_plain_matches_pallas(glm_inputs, name, newton_steps, alpha):
    """The Pallas test's bars: z within 2e-5, niter within 1 per lane (the
    two sides accumulate their products in different orders, and their
    sigmoids may differ in the last bit)."""
    w = glm_inputs
    fam = w["fams"][name]
    _, args = _glm_args(w, name, alpha)
    z_ref, n_ref = glm_batch_path_pallas(
        *args, 1e-6, 1e-6, jnp.float32(alpha), MAXIT, family=fam.name,
        huber_m=fam.param, newton_steps=newton_steps, true_q=w["q"],
        n_total=w["n"], interpret=True)
    z, niter = glm.glm_batch_path_reference(
        *(to_torch(a) for a in args[:5]), float(args[5]), 1e-6, 1e-6, alpha,
        MAXIT, family=fam.name, huber_m=fam.param, newton_steps=newton_steps)
    assert z.dtype == torch.float32 and niter.dtype == torch.int32
    assert z.shape == (6, w["q"]) and niter.shape == (6,)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=2e-5)
    assert np.max(np.abs(niter.numpy() - np.asarray(n_ref))) <= 1
    assert int(niter.max()) < MAXIT and float(z[-1].abs().max()) > 0


@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_glm_plain_matches_engine_path(glm_inputs, name):
    """As the Pallas kernel's own test: recovered coefficients within 2e-5
    of the JAX engine's batch path, niter within 1."""
    w = glm_inputs
    fam = w["fams"][name]
    ref, args = _glm_args(w, name, 1.0)
    z, niter = glm.glm_batch_path_reference(
        *(to_torch(a) for a in args[:5]), float(args[5]), 1e-6, 1e-6, 1.0,
        MAXIT, family=fam.name, huber_m=fam.param, newton_steps=2)
    beta0, coef = recover_glm(jnp.asarray(z.numpy()), w["mean_x"], w["sd_x"],
                              True)
    np.testing.assert_allclose(np.asarray(coef), np.asarray(ref.coef),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(beta0), np.asarray(ref.beta0),
                               atol=2e-5)
    assert np.abs(niter.numpy() - np.asarray(ref.niter)).max() <= 1


def test_glm_plain_lane_stops_at_maxit_and_alone_matches_batch(glm_inputs):
    """A lane that runs out of iterations reports ``maxit``; lanes never
    interact, so one lane alone gives its row of the batch (to 1e-6 here:
    the CPU's float64 product of one row and of six rows sum in different
    orders, and the rounded float32 can differ in the last bit)."""
    _, args = _glm_args(glm_inputs, "binomial", 1.0)
    targs = [to_torch(a) for a in args[:5]]
    kw = dict(family="binomial", newton_steps=2)
    z, niter = glm.glm_batch_path_reference(*targs, 0.25, 1e-6, 1e-6, 1.0, 25,
                                            **kw)
    assert int(niter.max()) == 25 and int(niter.min()) < 25
    targs[4] = targs[4][3:4]
    z1, n1 = glm.glm_batch_path_reference(*targs, 0.25, 1e-6, 1e-6, 1.0, 25,
                                          **kw)
    assert float((z1[0] - z[3]).abs().max()) <= 1e-6
    assert abs(int(n1[0]) - int(niter[3])) <= 1


def test_glm_wrapper_runs_plain_form_on_cpu(glm_inputs):
    _, args = _glm_args(glm_inputs, "huber", 1.0)
    targs = (*(to_torch(a) for a in args[:5]), 1.0, 1e-5, 1e-5, 1.0, 50)
    kw = dict(family="huber", huber_m=1.345, newton_steps=2)
    kernels.reset_launch_counts()
    for a, b in zip(glm.glm_batch_path(*targs, **kw),
                    glm.glm_batch_path_reference(*targs, **kw)):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["glm_batch_path"] == 0
    with pytest.raises(ValueError, match="serves"):
        glm.glm_batch_path(*targs, family="poisson")


def test_glm_shape_rule():
    """The dispatch bound 7q + 2n <= 57600 floats, which was the first GLM
    kernel's shared-memory size and is kept as the port's rule (the
    cooperative-grid kernel keeps lane state in device memory); there is
    no rule on the number of lambdas."""
    assert glm.fits(2000, 201) and glm.fits(10000, 1001)
    assert glm.fits(10000, (57600 - 20000) // 7)
    assert not glm.fits(10000, (57600 - 20000) // 7 + 1)
    assert glm.fits((57600 - 7) // 2, 1)
    assert not glm.fits((57600 - 7) // 2 + 1, 1)
    assert not glm.fits(0, 10) and not glm.fits(10, 0)
    assert tglm._use_kernel_glm(2000, 201, torch.float32)
    assert not tglm._use_kernel_glm(2000, 201, torch.float64)
    assert not tglm._use_kernel_glm(40000, 201, torch.float32)


def test_check_cuda_input_rules():
    """What every wrapper checks before a launch, on tensors the CPU can
    make: class, device, dtype, shape, contiguity."""
    cpu = torch.device("cpu")
    good = torch.zeros((4, 3))
    check_cuda_input("Xa", good, (4, 3), cpu)
    with pytest.raises(TypeError, match="must be a torch.Tensor"):
        check_cuda_input("Xa", good.numpy(), (4, 3), cpu)
    with pytest.raises(ValueError, match="is on meta, expected cpu"):
        check_cuda_input("Xa", torch.zeros((4, 3), device="meta"), (4, 3),
                         cpu)
    with pytest.raises(TypeError, match="float32"):
        check_cuda_input("Xa", good.double(), (4, 3), cpu)
    with pytest.raises(ValueError, match="shape"):
        check_cuda_input("Xa", good, (3, 4), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        check_cuda_input("Xa", torch.zeros((3, 4)).t(), (4, 3), cpu)


# ---------------------------------------------------------------------------
# The launch plan of the cooperative-grid kernels (GLM, BP; the tall scan
# and the wide batch kernel at the end of the file)
# ---------------------------------------------------------------------------

PLAN_SHAPES = [  # (rows n, columns q or p, lanes)
    (10000, 1001, 100), (2000, 201, 30), (303, 17, 6), (303, 16, 1),
    (1000, 2000, 100), (1000, 2000, 1), (14400, 4114, 2), (400, 7000, 2),
    (5, 9, 3), (61, 163, 130),
]


def _covers_once(tiles, rows):
    """Consecutive, disjoint ``[lo, hi)`` from 0 to ``rows``, sizes within
    one of each other."""
    assert tiles[0][0] == 0 and tiles[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    sizes = [hi - lo for lo, hi in tiles]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
    return sizes


@pytest.mark.parametrize("sms", [132, 1, 7])
@pytest.mark.parametrize("n,q,k", PLAN_SHAPES)
def test_glm_launch_plan(n, q, k, sms):
    """One block per SM; every row of Xa and every row of Xa' and Minv has
    exactly one owner; leading dimensions are multiples of four; scratch
    holds x, z, y, grad (k ldq each) and G (k ldn) for the lanes of one
    launch, the partial sums grid x lanes x 5 doubles."""
    plan = glm.launch_plan(n, q, k, sms)
    assert plan["grid"] == sms == len(plan["n_tiles"]) == len(plan["q_tiles"])
    assert plan["threads"] == 256
    _covers_once(plan["n_tiles"], n)
    sizes = _covers_once(plan["q_tiles"], q)
    assert max(sizes) == -(-q // sms)
    assert plan["ldq"] % 4 == 0 and q <= plan["ldq"] < q + 4
    assert plan["ldn"] % 4 == 0 and n <= plan["ldn"] < n + 4
    groups = plan["lane_groups"]
    assert groups[0][0] == 0 and groups[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    lanes = max(hi - lo for lo, hi in groups)
    assert lanes == min(k, 128)
    assert plan["scratch_floats"] == lanes * (4 * plan["ldq"] + plan["ldn"])
    assert plan["partial_doubles"] == sms * lanes * 5
    assert plan["smem_bytes"] == (64 + 128) * 33 * 16 <= 232448


@pytest.mark.parametrize("sms", [132, 1, 7])
@pytest.mark.parametrize("n,p,m", PLAN_SHAPES)
def test_bp_launch_plan(n, p, m, sms):
    """As for the GLM kernel: rows of A and Winv, rows of A', z, y, adj_z,
    adj_y, z_new, y_new, v, x (m ldp each) and t, u (m ldn each), six sums
    per lane and block."""
    plan = bp.launch_plan(n, p, m, sms)
    assert plan["grid"] == sms and plan["threads"] == 256
    _covers_once(plan["n_tiles"], n)
    _covers_once(plan["p_tiles"], p)
    assert plan["ldp"] % 4 == 0 and p <= plan["ldp"] < p + 4
    assert plan["ldn"] % 4 == 0 and n <= plan["ldn"] < n + 4
    lanes = max(hi - lo for lo, hi in plan["lane_groups"])
    assert lanes == min(m, 128) and plan["lane_groups"][-1][1] == m
    assert plan["scratch_floats"] == lanes * (8 * plan["ldp"]
                                              + 2 * plan["ldn"])
    assert plan["partial_doubles"] == sms * lanes * 6


def test_launch_plan_at_the_main_path_shapes():
    """The numbers the kernels' notes and docstrings quote: at 132 blocks
    Xa' (q = 1001) gives a block 7 or 8 rows and A' (p = 2000) 15 or 16;
    q = 1001 and 201 are padded to 1004 and 204; G for 100 lanes at
    n = 10000 is 4 MB; the syncs of one iteration."""
    g = glm.launch_plan(10000, 1001, 100, 132)
    assert {hi - lo for lo, hi in g["q_tiles"]} == {7, 8}
    assert {hi - lo for lo, hi in g["n_tiles"]} == {75, 76}
    assert g["ldq"] == 1004 and glm.launch_plan(2000, 201, 30, 132)["ldq"] == 204
    assert 100 * g["ldn"] * 4 == 4_000_000
    b = bp.launch_plan(1000, 2000, 100, 132)
    assert {hi - lo for lo, hi in b["p_tiles"]} == {15, 16}
    assert b["scratch_floats"] * 4 == 100 * (8 * 2000 + 2 * 1000) * 4
    # Fewer rows than blocks: 17 blocks own one row each, the rest none.
    sizes = [hi - lo for lo, hi in glm.launch_plan(303, 17, 6, 132)["q_tiles"]]
    assert sorted(set(sizes)) == [0, 1] and sum(sizes) == 17
    assert glm.syncs_per_iteration(2) == 7 and glm.syncs_per_iteration(1) == 4
    assert bp.SYNCS_PER_ITERATION == 4
    # Every shape the dispatch bound admits has a plan, and the bound is
    # what it was.
    assert glm.fits(14400, 4114) and not glm.fits(14400, 4115)
    assert bp.fits(400, 7000) and not bp.fits(400, 7001)
    assert glm._SMEM_FLOATS == bp._SMEM_FLOATS == 57600


def test_padded_rows_and_row_tile():
    """``padded_rows`` zero-pads to a multiple of four and passes an
    aligned matrix through; ``row_tile`` is the header's integer rule."""
    M = torch.arange(15.0).reshape(3, 5)
    P = kcommon.padded_rows(M)
    assert P.shape == (3, 8) and P.is_contiguous()
    assert torch.equal(P[:, :5], M) and float(P[:, 5:].abs().max()) == 0.0
    T = kcommon.padded_rows(M.mT)          # (5, 3) -> (5, 4)
    assert T.shape == (5, 4) and torch.equal(T[:, :3], M.mT)
    Q = torch.ones((2, 8))
    assert kcommon.padded_rows(Q) is Q
    assert kcommon.padded_rows(Q.mT).is_contiguous()
    assert [kcommon.pad4(d) for d in (1, 4, 201, 1001)] == [4, 4, 204, 1004]
    assert kcommon.row_tile(1001, 131, 132) == (993, 1001)
    assert kcommon.lane_groups(130) == [(0, 128), (128, 130)]
    assert kcommon.lane_groups(1) == [(0, 1)]


# ---------------------------------------------------------------------------
# The launch plans of the tall scan and wide batch kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [132, 1, 7])
@pytest.mark.parametrize("n,p,k", PLAN_SHAPES)
def test_tall_scan_launch_plan(n, p, k, sms):
    """One lane over the grid: at most one block per SM, no more blocks
    than one warp per coordinate needs and no more than a block has threads
    (thread b adds block b's sums); every column of ``z_out`` has exactly
    one owner; Minv' gets a leading dimension that is a multiple of four;
    a block holds the right-hand side as ``ldp`` float64s and five rows of
    p floats, which fits whatever ``fits`` admits; z_new, y_new and the
    partial sums are double-buffered."""
    plan = tall_path.launch_plan(p, sms)
    grid = plan["grid"]
    assert 1 <= grid <= min(sms, 256) and plan["threads"] == 256
    assert grid == min(sms, -(-p // 8)) == len(plan["col_tiles"])
    _covers_once(plan["col_tiles"], p)
    assert plan["ldp"] % 4 == 0 and p <= plan["ldp"] < p + 4
    assert plan["smem_bytes"] == 4 * (2 * plan["ldp"] + 5 * p)
    assert not tall_path.fits(p) or plan["smem_bytes"] <= 232448 - 2048
    assert plan["exchange_floats"] == 2 * p
    assert plan["partial_doubles"] == 2 * grid * 6


@pytest.mark.parametrize("sms", [132, 1, 7])
@pytest.mark.parametrize("n,p,k", PLAN_SHAPES)
def test_wide_launch_plan(n, p, k, sms):
    """As for the GLM and BP kernels: one block per SM; every row of X and
    every row of X' has exactly one owner; leading dimensions are multiples
    of four; scratch holds x (k ldp) and Ax, z, y, tmp (k ldn each) for the
    lanes of one launch, the partial sums lanes x 5 x grid doubles; lanes
    go in groups of at most 128."""
    plan = wide_path.launch_plan(n, p, k, sms)
    assert plan["grid"] == sms == len(plan["n_tiles"]) == len(plan["p_tiles"])
    assert plan["threads"] == 256
    _covers_once(plan["n_tiles"], n)
    sizes = _covers_once(plan["p_tiles"], p)
    assert max(sizes) == -(-p // sms)
    assert plan["ldp"] % 4 == 0 and p <= plan["ldp"] < p + 4
    assert plan["ldn"] % 4 == 0 and n <= plan["ldn"] < n + 4
    groups = plan["lane_groups"]
    assert groups[0][0] == 0 and groups[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    lanes = max(hi - lo for lo, hi in groups)
    assert lanes == min(k, 128)
    assert plan["scratch_floats"] == lanes * (plan["ldp"] + 4 * plan["ldn"])
    assert plan["partial_doubles"] == sms * lanes * 5
    assert plan["smem_bytes"] == (64 + 128) * 33 * 16 <= 232448


def test_scan_and_wide_plans_at_the_main_path_shapes():
    """The numbers the kernels' notes quote: at p = 1000 the scan takes 125
    blocks, one coordinate per warp, 28000 bytes of shared memory and one
    sync per iteration; at 1000 x 2000 x 100 the wide kernel gives a block
    7 or 8 rows of X and 15 or 16 of X', 2.4 MB of lane state and three
    syncs per iteration.  ``fits`` is what it was."""
    t = tall_path.launch_plan(1000, 132)
    assert t["grid"] == 125 and t["grid"] * 8 == 1000
    assert {hi - lo for lo, hi in t["col_tiles"]} == {8}
    assert t["smem_bytes"] == 28000 and t["ldp"] == 1000
    assert tall_path.SCAN_SYNCS_PER_ITERATION == 1
    # The widest problem ``fits`` admits: a whole grid, one block's memory.
    big = tall_path.launch_plan(tall_path.MAX_P, 132)
    assert big["grid"] == 132 and big["smem_bytes"] == 7 * 4 * 7200
    assert tall_path.launch_plan(5, 132)["grid"] == 1
    assert tall_path.launch_plan(1001, 132)["ldp"] == 1004
    w = wide_path.launch_plan(1000, 2000, 100, 132)
    assert {hi - lo for lo, hi in w["n_tiles"]} == {7, 8}
    assert {hi - lo for lo, hi in w["p_tiles"]} == {15, 16}
    assert w["scratch_floats"] * 4 == 100 * (2000 + 4 * 1000) * 4 == 2_400_000
    assert w["lane_groups"] == [(0, 100)]
    assert wide_path.launch_plan(61, 163, 130, 132)["lane_groups"] == [
        (0, 128), (128, 130)]
    assert wide_path.SYNCS_PER_ITERATION == 3
    assert tall_path.MAX_P == 7200 and wide_path._SMEM_FLOATS == 57600
    assert wide_path.fits(1000, 17533) and not wide_path.fits(1000, 17534)
    assert wide_path.fits(11519, 1) and not wide_path.fits(11519, 2)
    assert not wide_path.fits(0, 10) and not wide_path.fits(10, 0)


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_wide_wrapper_one_lane_runs_plain_form_on_cpu(wide_inputs, alpha):
    """k = 1 goes the same way as a batch: on CPU tensors the wrapper
    returns its plain form's result, counts no launch, and one lane alone
    stops where its lane of the batch stops (within 1: the CPU's float64
    product of one row and of nine rows sum in different orders)."""
    _, args = _pallas_wide(wide_inputs, alpha)
    Xs, ys, ilams, rho, sprad, lambda0 = args
    kernels.reset_launch_counts()
    tail = (sprad, lambda0, 1e-5, 1e-5, alpha, MAXIT)
    x, niter = wide_path.wide_path_batch(Xs, ys, ilams, rho, *tail)
    one = (Xs, ys, ilams[4:5], rho[4:5])
    x1, n1 = wide_path.wide_path_batch(*one, *tail)
    xr, nr = wide_path.wide_path_batch_reference(*one, *tail)
    assert torch.equal(x1, xr) and torch.equal(n1, nr)
    assert x1.shape == (1, wide_inputs["p"])
    assert float((x1[0] - x[4]).abs().max()) <= 1e-5
    assert abs(int(n1[0]) - int(niter[4])) <= 1
    assert kernels.launch_counts()["wide_path_batch"] == 0


# ---------------------------------------------------------------------------
# The launch plans of the LAD and tall batch kernels
# ---------------------------------------------------------------------------

LAD_PLAN_N = [1000, 5000, 303, lad.MAX_N, 1, 7, 4097, 2500]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", LAD_PLAN_N)
def test_lad_launch_plan(n, sms):
    """One block per SM, no more blocks than rows and no more than 256
    (thread b adds block b's sums); every row of H has exactly one owner;
    H's leading dimension is a multiple of four; each row is cut into
    segments of at most 2048 floats, multiples of four, that cover it; the
    ring has a multiple of eight stages (slot s is read by consumer warp
    s % 8), at most 64, and, with the state (v as ld float64s, the
    float64 sum of each segment of a block's rows, z, y, ys and the block's
    adj_z, adj_y), fits a block's dynamic shared memory."""
    plan = lad.launch_plan(n, sms)
    grid = plan["grid"]
    assert grid == min(sms, n, 256) and plan["threads"] == 288
    sizes = _covers_once(plan["row_tiles"], n)
    assert min(sizes) >= 1 and max(sizes) == -(-n // grid)
    ld, seg, nseg = plan["ld"], plan["seg"], plan["segments_per_row"]
    assert ld % 4 == 0 and n <= ld < n + 4
    assert seg % 4 == 0 and 4 <= seg <= 2048
    assert (nseg - 1) * seg < ld <= nseg * seg
    assert 8 <= plan["stages"] <= lad.MAX_STAGES and plan["stages"] % 8 == 0
    assert plan["ring_bytes"] == 4 * seg * plan["stages"]
    rows = max(sizes)
    state = (8 * ld + 8 * rows * nseg
             + 4 * (3 * kcommon.pad4(n) + 2 * kcommon.pad4(rows)))
    assert plan["smem_bytes"] == state + plan["ring_bytes"] <= 232448 - 2048
    # The ring holds all the multiples of eight stages that are left.
    assert (plan["stages"] == lad.MAX_STAGES
            or plan["smem_bytes"] + 8 * 4 * seg > 232448 - 2048)
    assert plan["exchange_floats"] == 2 * n
    assert plan["partial_doubles"] == 2 * 6 * grid


def test_lad_plan_at_the_main_path_shapes():
    """The numbers the kernel's notes quote: at n = 1000 a block owns 7 or
    8 rows of 4 KB and the ring holds 48 stages (its whole share, and six
    iterations ahead); at n = 5000 each row is three 6.7 KB stages, 16 of
    them in flight (107 KB); at n = MAX_N ten 3.8 KB stages per row and a
    ring of eight; odd n is padded to a multiple of four; one sync per
    iteration; ``fits`` is what it was."""
    p1 = lad.launch_plan(1000, 132)
    assert p1["grid"] == 132 and p1["ld"] == 1000
    assert {hi - lo for lo, hi in p1["row_tiles"]} == {7, 8}
    assert p1["seg"] == 1000 and p1["segments_per_row"] == 1
    assert p1["stages"] == 48 and p1["ring_bytes"] == 192000
    p5 = lad.launch_plan(5000, 132)
    assert {hi - lo for lo, hi in p5["row_tiles"]} == {37, 38}
    assert p5["seg"] == 1668 and p5["segments_per_row"] == 3
    assert p5["stages"] == 16 and p5["ring_bytes"] == 106752 >= 64 * 1024
    big = lad.launch_plan(lad.MAX_N, 132)
    assert big["seg"] == 960 and big["segments_per_row"] == 10
    assert big["stages"] == 8
    assert lad.launch_plan(303, 132)["ld"] == 304
    assert lad.SYNCS_PER_ITERATION == 1
    assert lad.MAX_N == 9600 and lad.fits(9600) and not lad.fits(9601)


@pytest.mark.parametrize("sms", [132, 1, 7])
@pytest.mark.parametrize("n,p,k", PLAN_SHAPES)
def test_tall_batch_launch_plan(n, p, k, sms):
    """As for the wide kernel: one block per SM; every coordinate (row of
    Minv') has exactly one owner; Minv' gets a leading dimension that is a
    multiple of four; scratch holds eight rows of ldp floats per lane for
    the lanes of one launch, the partial sums lanes x 6 x grid doubles;
    lanes go in groups of at most 128."""
    plan = tall_path.batch_launch_plan(p, k, sms)
    assert plan["grid"] == sms == len(plan["p_tiles"])
    assert plan["threads"] == 256
    sizes = _covers_once(plan["p_tiles"], p)
    assert max(sizes) == -(-p // sms)
    assert plan["ldp"] % 4 == 0 and p <= plan["ldp"] < p + 4
    groups = plan["lane_groups"]
    assert groups[0][0] == 0 and groups[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    lanes = max(hi - lo for lo, hi in groups)
    assert lanes == min(k, 128)
    assert plan["scratch_floats"] == 8 * lanes * plan["ldp"]
    assert plan["partial_doubles"] == sms * lanes * 6
    assert plan["smem_bytes"] == (64 + 128) * 33 * 16 <= 232448


def test_tall_batch_plan_at_the_main_path_shapes():
    """p = 1000, 100 lambdas: a block owns 7 or 8 coordinates, the lane
    state is 3.2 MB, one launch; k = 1 and k = 130 (two launches); two
    syncs per iteration."""
    b = tall_path.batch_launch_plan(1000, 100, 132)
    assert {hi - lo for lo, hi in b["p_tiles"]} == {7, 8}
    assert b["ldp"] == 1000 and b["lane_groups"] == [(0, 100)]
    assert b["scratch_floats"] * 4 == 8 * 100 * 1000 * 4 == 3_200_000
    assert tall_path.batch_launch_plan(1000, 1, 132)["lane_groups"] == [(0, 1)]
    assert tall_path.batch_launch_plan(37, 130, 132)["lane_groups"] == [
        (0, 128), (128, 130)]
    assert tall_path.BATCH_SYNCS_PER_ITERATION == 2
    assert tall_path.fits(tall_path.MAX_P) and not tall_path.fits(7201)
