"""The CUDA kernels against their plain PyTorch forms, on the card.

Needs a CUDA device and ``nvcc``; without a device every test skips.  On
the card, run without the JAX-side ``conftest.py`` (this file imports no
JAX)::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Shapes are those of the CPU kernel tests (tall n = 200, p = 40, k = 10;
wide n = 60, p = 150, k = 9 with the first lambda above lambda0), and so
are the bars: coefficients within 1e-5, niter within 1 per lane for the
batched kernels, scan niter totals within max(3, 10%).  The kernels and
their plain forms accumulate in float64 and round in the same places, so
in practice they agree to the bit.  The LAD and BP kernels (n = 300,
p = 20; n = 60, p = 160, m = 5) and the GLM kernel (n = 303, p = 16) are
held to the bars of the JAX package's own Pallas tests, stated at each
test.
"""
import numpy as np
import pytest
import torch

from admm_tpu_torch import kernels
from admm_tpu_torch.data.standardize import standardize
from admm_tpu_torch.kernels import bp, glm, lad, tall_path, wide_path
from admm_tpu_torch.linalg import chol_inverse, gram, tgram
from admm_tpu_torch.models.glm import (_glm_auto_rho, _glm_fixed_minv,
                                       binomial, huber, prep_design)
from admm_tpu_torch.models.lasso import (_auto_lambdas, _tall_setup,
                                          _wide_setup)

torch.set_num_threads(1)

MAXIT = 2000


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _std(X, y, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return standardize(torch.as_tensor(X, **f32), torch.as_tensor(y, **f32),
                       standardize_x=True, intercept=True)[:2]


@pytest.fixture(scope="module")
def tall_args(dev):
    rng = np.random.default_rng(3)
    n, p, k = 200, 40, 10
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.4)
    Xs, ys = _std(X, 1.0 + X @ b + 0.3 * rng.normal(size=n), dev)
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0, lam0 * 1e-3, k),
                         dtype=torch.float32, device=dev)
    Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], -1.0)
    return Minv.contiguous(), Xty.contiguous(), ilams, rho


@pytest.fixture(scope="module")
def wide_args(dev):
    rng = np.random.default_rng(11)
    n, p, k = 60, 150, 9
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:12] = rng.normal(size=12)
    Xs, ys = _std(X, X @ b + 0.2 * rng.normal(size=n), dev)
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0 * 1.1, lam0 * 1e-2, k),
                         dtype=torch.float32, device=dev)
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams, -1.0, 1.0, False)
    return Xs.contiguous(), ys.contiguous(), ilams, rho.contiguous(), sprad, \
        lambda0


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_batch_kernel_matches_plain(tall_args, alpha):
    args = (*tall_args, 1e-5, 1e-5, alpha, MAXIT)
    before = kernels.launch_counts()["tall_path_batch"]
    z, niter = tall_path.tall_path_batch(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tall_path_batch"] == before + 1
    z_ref, n_ref = tall_path.tall_path_batch_reference(*args)
    assert z.is_cuda and z.shape == z_ref.shape and niter.dtype == torch.int32
    assert float((z - z_ref).abs().max()) <= 1e-5
    assert int((niter - n_ref).abs().max()) <= 1


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_scan_kernel_matches_plain(tall_args, alpha):
    args = (*tall_args, 1e-5, 1e-5, alpha, MAXIT)
    z, niter = tall_path.tall_path_scan(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = tall_path.tall_path_scan_reference(*args)
    assert float((z - z_ref).abs().max()) <= 1e-5
    total = int(n_ref.sum())
    assert abs(int(niter.sum()) - total) <= max(3, int(0.1 * total))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_wide_batch_kernel_matches_plain(wide_args, alpha):
    args = (*wide_args, 1e-5, 1e-5, alpha, MAXIT)
    x, niter = wide_path.wide_path_batch(*args)
    torch.cuda.synchronize()
    x_ref, n_ref = wide_path.wide_path_batch_reference(*args)
    assert float((x - x_ref).abs().max()) <= 1e-5
    assert int((niter - n_ref).abs().max()) <= 1
    assert float(x[0].abs().max()) == 0.0


def test_kernels_reject_what_they_do_not_take(tall_args, wide_args):
    Minv, Xty, ilams, rho = tall_args
    rest = (rho, 1e-5, 1e-5, 1.0, 10)
    for fn in (tall_path.tall_path_batch, tall_path.tall_path_scan):
        with pytest.raises(TypeError, match="float32"):
            fn(Minv.double(), Xty.double(), ilams.double(), *rest)
        with pytest.raises(ValueError, match="is on cpu"):
            fn(Minv, Xty.cpu(), ilams, *rest)
        with pytest.raises(ValueError, match="contiguous"):
            fn(Minv.t(), Xty, ilams, *rest)
        with pytest.raises(ValueError, match="shape"):
            fn(Minv, Xty[:-1], ilams, *rest)
    Xs, ys, wl, wr, sprad, lambda0 = wide_args
    tail = (sprad, lambda0, 1e-5, 1e-5, 1.0, 10)
    with pytest.raises(TypeError, match="float32"):
        wide_path.wide_path_batch(Xs, ys.double(), wl, wr, *tail)
    with pytest.raises(ValueError, match="is on cpu"):
        wide_path.wide_path_batch(Xs, ys, wl.cpu(), wr, *tail)
    with pytest.raises(ValueError, match="contiguous"):
        wide_path.wide_path_batch(Xs.t().contiguous().t(), ys, wl, wr, *tail)


@pytest.fixture(scope="module")
def lad_args(dev):
    rng = np.random.default_rng(8)
    n, p = 300, 20
    X = rng.normal(size=(n, p))
    y = X @ rng.normal(size=p) + rng.standard_t(2, size=n)
    Xs = torch.as_tensor(X, dtype=torch.float32, device=dev)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    Ginv = chol_inverse(gram(Xs), jitter=1e-6)
    H = (Xs @ (Ginv @ Xs.mT)).contiguous()
    return dict(X=X, y=y, Xs=Xs, ys=ys, Ginv=Ginv, H=H,
                ynorm=float(torch.sqrt(torch.sum(ys * ys))))


@pytest.fixture(scope="module")
def bp_args(dev):
    rng = np.random.default_rng(12)
    n, p, k, m = 60, 160, 6, 5
    X0 = np.zeros((m, p))
    for i in range(m):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    A = torch.as_tensor(rng.normal(size=(n, p)) / np.sqrt(n),
                        dtype=torch.float32, device=dev)
    B = torch.as_tensor(X0, dtype=torch.float32, device=dev) @ A.mT
    Winv = chol_inverse(tgram(A), jitter=1e-6).contiguous()
    return A, Winv, (B @ (Winv @ A)).contiguous(), X0


@pytest.mark.parametrize("rho", [1.0, 5.0])
def test_lad_kernel_matches_plain(lad_args, rho):
    """Recovered coefficients within 5e-3 and L1 objective <= 1.001x the
    plain form's (the terminal duals are path-dependent near the L1
    kinks); in practice the float64 sums make the two agree far closer,
    and niter is printed by chip_smoke.py at full size."""
    w = lad_args
    args = (w["H"], w["ys"], rho, 1e-5, 1e-5, w["ynorm"], MAXIT)
    before = kernels.launch_counts()["lad_solve"]
    ay, az, niter = lad.lad_solve(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lad_solve"] == before + 1
    ay_ref, az_ref, n_ref = lad.lad_solve_reference(*args)
    assert ay.is_cuda and ay.shape == az.shape == (300,)
    assert niter.dtype == torch.int32 and niter.dim() == 0
    assert abs(int(niter) - int(n_ref)) <= max(3, int(0.05 * int(n_ref)))

    def coef_of(adj_y, adj_z):
        v = w["ys"] - adj_y / rho + adj_z
        return (w["Ginv"] @ (w["Xs"].mT @ v)).cpu().numpy().astype(np.float64)

    c, c_ref = coef_of(ay, az), coef_of(ay_ref, az_ref)
    obj = lambda c: np.abs(w["y"] - w["X"] @ c).sum()
    np.testing.assert_allclose(c, c_ref, atol=5e-3)
    assert obj(c) <= obj(c_ref) * 1.001


@pytest.mark.parametrize("m", [5, 1])
@pytest.mark.parametrize("rho", [1.0, 5.0])
def test_bp_batch_kernel_matches_plain(bp_args, rho, m):
    """z within 1e-4, the true signals within 1e-3, niter within
    max(3, 5%) per lane; m = 1 is the same kernel with one lane."""
    A, Winv, AAAB, X0 = bp_args
    args = (A, Winv, AAAB[:m].contiguous(), rho, 1e-6, 1e-6, 3000)
    before = kernels.launch_counts()["bp_batch_solve"]
    z, niter = bp.bp_batch_solve(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bp_batch_solve"] == before + 1
    z_ref, n_ref = bp.bp_batch_solve_reference(*args)
    assert z.is_cuda and z.shape == (m, 160) and niter.dtype == torch.int32
    assert float((z - z_ref).abs().max()) <= 1e-4
    np.testing.assert_allclose(z.cpu().numpy(), X0[:m], atol=1e-3)
    for a, b in zip(niter.cpu().numpy(), n_ref.cpu().numpy()):
        assert abs(int(a) - int(b)) <= max(3, int(0.05 * int(b)))


def test_lad_bp_kernels_reject_what_they_do_not_take(lad_args, bp_args):
    H, ys = lad_args["H"], lad_args["ys"]
    rest = (5.0, 1e-5, 1e-5, 1.0, 10)
    with pytest.raises(TypeError, match="float32"):
        lad.lad_solve(H.double(), ys.double(), *rest)
    with pytest.raises(ValueError, match="is on cpu"):
        lad.lad_solve(H, ys.cpu(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        lad.lad_solve(H.t(), ys, *rest)
    with pytest.raises(ValueError, match="shape"):
        lad.lad_solve(H, ys[:-1], *rest)
    A, Winv, AAAB, _ = bp_args
    tail = (5.0, 1e-5, 1e-5, 10)
    with pytest.raises(TypeError, match="float32"):
        bp.bp_batch_solve(A, Winv.double(), AAAB, *tail)
    with pytest.raises(ValueError, match="is on cpu"):
        bp.bp_batch_solve(A, Winv, AAAB.cpu(), *tail)
    with pytest.raises(ValueError, match="contiguous"):
        bp.bp_batch_solve(A.t().contiguous().t(), Winv, AAAB, *tail)
    with pytest.raises(ValueError, match="shape"):
        bp.bp_batch_solve(A, Winv[:-1], AAAB, *tail)


@pytest.mark.parametrize("n", [303, lad.MAX_N])
def test_lad_kernel_odd_and_largest_n(dev, n):
    """n = 303 is not a multiple of 4, so the wrapper pads H's rows; at
    n = MAX_N the state leaves room for a ring of eight stages, each row is
    ten stages, and the ring wraps hundreds of times.  Five iterations,
    unconverged: the terminal state within 1e-5 of the plain form's, and
    ``fits`` ends there."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    X = torch.randn((n, 12), generator=gen).to(dev)
    ys = torch.randn((n,), generator=gen).to(dev)
    H = (X @ (chol_inverse(gram(X), jitter=1e-6) @ X.mT)).contiguous()
    args = (H, ys, 5.0, 1e-9, 1e-9, float(torch.linalg.norm(ys)), 5)
    ay, az, niter = lad.lad_solve(*args)
    torch.cuda.synchronize()
    ay_ref, az_ref, n_ref = lad.lad_solve_reference(*args)
    assert int(niter) == int(n_ref) == 5
    assert float((ay - ay_ref).abs().max()) <= 1e-5
    assert float((az - az_ref).abs().max()) <= 1e-5
    assert float(az.abs().max()) > 0.0
    assert lad.fits(n) and not lad.fits(lad.MAX_N + 1)
    with pytest.raises(ValueError, match="LAD kernel takes"):
        lad.lad_solve(torch.zeros((lad.MAX_N + 1, lad.MAX_N + 1), device=dev),
                      torch.zeros((lad.MAX_N + 1,), device=dev), 5.0, 1e-9,
                      1e-9, 1.0, 5)


def test_bp_kernel_largest_shape(dev):
    """n = 400, p = 7000 meets the dispatch bound of ``fits`` exactly
    (8p + 4n = 57600); p + 1 is past it and the wrapper refuses it.  Three
    iterations of two lanes: z within 1e-5 of the plain form's."""
    n, p = 400, 7000
    assert bp.fits(n, p) and not bp.fits(n, p + 1)
    gen = torch.Generator(device="cpu").manual_seed(5)
    A = (torch.randn((n, p), generator=gen) / n ** 0.5).to(dev)
    B = torch.randn((2, n), generator=gen).to(dev)
    Winv = chol_inverse(tgram(A), jitter=1e-6).contiguous()
    args = (A, Winv, (B @ (Winv @ A)).contiguous(), 5.0, 1e-9, 1e-9, 3)
    z, niter = bp.bp_batch_solve(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = bp.bp_batch_solve_reference(*args)
    assert niter.tolist() == n_ref.tolist() == [3, 3]
    assert float(z.abs().max()) > 0.0
    assert float((z - z_ref).abs().max()) <= 1e-5
    wider = torch.zeros((n, p + 1), device=dev)
    with pytest.raises(ValueError, match="BP kernel takes"):
        bp.bp_batch_solve(wider, Winv, torch.zeros((2, p + 1), device=dev),
                          5.0, 1e-9, 1e-9, 3)


# ---------------------------------------------------------------------------
# GLM
# ---------------------------------------------------------------------------

GLM_FAMILIES = {"binomial": binomial, "huber": huber}


def _glm_args(dev, name, intercept, n=303, p=16, k=6, seed=51):
    """A design whose n is no multiple of 4 or 32; q = p + 1 with the ones
    column (rows padded to a multiple of four by the wrapper) and q = p
    without (no padding)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[:4] = [1.5, -2.0, 1.0, 0.5]
    y = ((rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ b))))
         if name == "binomial" else X @ b + 0.3 * rng.normal(size=n))
    fam = GLM_FAMILIES[name]()
    Xa, pen_mask, _, _ = prep_design(torch.as_tensor(X, device=dev), True,
                                     intercept)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    rho = _glm_auto_rho(fam, -1.0)
    Minv = _glm_fixed_minv(Xa, fam, rho).contiguous()
    lam0 = float(torch.max(torch.abs(
        Xa[:, int(intercept):].mT @ fam.null_resid(ys, intercept))) / n)
    lams = torch.tensor(np.geomspace(lam0, lam0 * 1e-2, k),
                        dtype=torch.float32, device=dev)
    return (Xa.contiguous(), Minv, ys, pen_mask, lams, rho), dict(
        family=fam.name, huber_m=fam.param)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("newton_steps", [1, 2, 3])
@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_glm_kernel_matches_plain(dev, name, intercept, newton_steps, alpha):
    """z within 2e-5 and niter within 1 per lane (the JAX package's bar
    for its kernel); in practice far closer, and chip_smoke.py prints the
    gap at full size."""
    args, kw = _glm_args(dev, name, intercept)
    args = (*args, 1e-6, 1e-6, alpha, MAXIT)
    before = kernels.launch_counts()["glm_batch_path"]
    z, niter = glm.glm_batch_path(*args, newton_steps=newton_steps, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["glm_batch_path"] == before + 1
    z_ref, n_ref = glm.glm_batch_path_reference(
        *args, newton_steps=newton_steps, **kw)
    q = 16 + int(intercept)
    assert z.is_cuda and z.shape == (6, q) and niter.dtype == torch.int32
    assert float((z - z_ref).abs().max()) <= 2e-5
    assert int((niter - n_ref).abs().max()) <= 1
    assert int(niter.max()) < MAXIT and float(z[-1].abs().max()) > 0


@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_glm_kernel_one_lane_and_maxit(dev, name):
    """k = 1 is the same kernel with one lane and equals its lane of the
    batch to the bit; a lane that runs out of iterations reports ``maxit``
    and the state it reached, as the plain form does."""
    args, kw = _glm_args(dev, name, True)
    tail = (1e-6, 1e-6, 1.0, 12)
    z, niter = glm.glm_batch_path(*args, *tail, **kw)
    z_ref, n_ref = glm.glm_batch_path_reference(*args, *tail, **kw)
    torch.cuda.synchronize()
    assert int(niter.max()) == 12 and niter.tolist() == n_ref.tolist()
    assert float((z - z_ref).abs().max()) <= 2e-5
    one = (*args[:4], args[4][5:6].contiguous(), args[5])
    z1, n1 = glm.glm_batch_path(*one, *tail, **kw)
    torch.cuda.synchronize()
    assert z1.shape == (1, 17)
    assert torch.equal(z1[0], z[5]) and int(n1[0]) == int(niter[5])


def test_glm_kernel_largest_shape(dev):
    """q = 4114 is the widest design the dispatch bound of ``fits`` admits
    at n = 14400 (7q + 2n <= 57600); q + 1 is past it and the wrapper
    refuses it.  Two iterations of two lanes: z within 1e-5 of the plain
    form's."""
    n, q = 14400, 4114
    assert glm.fits(n, q) and not glm.fits(n, q + 1)
    gen = torch.Generator(device="cpu").manual_seed(6)
    Xa = torch.randn((n, q), generator=gen).to(dev)
    Xa[:, 0] = 1.0
    ys = (torch.rand((n,), generator=gen) < 0.4).float().to(dev)
    mask = torch.ones((q,), device=dev)
    mask[0] = 0.0
    fam = binomial()
    Minv = _glm_fixed_minv(Xa, fam, 0.25).contiguous()
    lams = torch.tensor([0.02, 0.005], device=dev)
    args = (Xa, Minv, ys, mask, lams, 0.25, 1e-9, 1e-9, 1.0, 2)
    z, niter = glm.glm_batch_path(*args, family="binomial")
    torch.cuda.synchronize()
    z_ref, n_ref = glm.glm_batch_path_reference(*args, family="binomial")
    assert niter.tolist() == n_ref.tolist() == [2, 2]
    assert float(z.abs().max()) > 0.0
    assert float((z - z_ref).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="GLM kernel takes"):
        glm.glm_batch_path(torch.zeros((n, q + 1), device=dev),
                           torch.zeros((q + 1, q + 1), device=dev), ys,
                           torch.ones((q + 1,), device=dev), lams, 0.25, 1e-9,
                           1e-9, 1.0, 2, family="binomial")


def test_glm_kernel_rejects_what_it_does_not_take(dev):
    (Xa, Minv, ys, mask, lams, rho), kw = _glm_args(dev, "binomial", True)
    tail = (rho, 1e-5, 1e-5, 1.0, 10)
    with pytest.raises(TypeError, match="float32"):
        glm.glm_batch_path(Xa, Minv.double(), ys, mask, lams, *tail, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        glm.glm_batch_path(Xa, Minv, ys.cpu(), mask, lams, *tail, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        glm.glm_batch_path(Xa.t().contiguous().t(), Minv, ys, mask, lams,
                           *tail, **kw)
    with pytest.raises(ValueError, match="shape"):
        glm.glm_batch_path(Xa, Minv, ys, mask[:-1], lams, *tail, **kw)
    with pytest.raises(ValueError, match="serves"):
        glm.glm_batch_path(Xa, Minv, ys, mask, lams, *tail, family="poisson")
    with pytest.raises(ValueError, match="newton_steps"):
        glm.glm_batch_path(Xa, Minv, ys, mask, lams, *tail, newton_steps=0,
                           **kw)


# ---------------------------------------------------------------------------
# The cooperative-grid design of the GLM and BP kernels: every block works
# on every active lane, lanes leave a compacted list as they converge, and
# sums across blocks are added in a fixed order.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["binomial", "huber"])
def test_glm_lanes_that_finish_apart_equal_each_lane_alone(dev, name):
    """Six lanes converge at different iterations, so the list of active
    lanes shrinks step by step; each lane must come out as if it had run
    alone (k = 1), to the bit, with its own niter."""
    args, kw = _glm_args(dev, name, True)
    tail = (1e-6, 1e-6, 1.0, MAXIT)
    z, niter = glm.glm_batch_path(*args, *tail, **kw)
    torch.cuda.synchronize()
    assert len(set(niter.tolist())) > 1 and int(niter.max()) < MAXIT
    for i in range(6):
        one = (*args[:4], args[4][i:i + 1].contiguous(), args[5])
        z1, n1 = glm.glm_batch_path(*one, *tail, **kw)
        assert z1.shape == (1, 17) and int(n1[0]) == int(niter[i])
        assert torch.equal(z1[0], z[i])


def test_bp_lanes_that_finish_apart_equal_each_lane_alone(bp_args):
    """The same for Basis Pursuit: each of five signals alone (m = 1)
    equals its lane of the batch to the bit."""
    A, Winv, AAAB, _ = bp_args
    tail = (5.0, 1e-6, 1e-6, 3000)
    z, niter = bp.bp_batch_solve(A, Winv, AAAB, *tail)
    torch.cuda.synchronize()
    assert len(set(niter.tolist())) > 1 and int(niter.max()) < 3000
    for i in range(5):
        z1, n1 = bp.bp_batch_solve(A, Winv, AAAB[i:i + 1].contiguous(), *tail)
        assert int(n1[0]) == int(niter[i]) and torch.equal(z1[0], z[i])


@pytest.mark.parametrize("k", [1, 2, 7, 37, 130])
def test_glm_kernel_lane_counts(dev, k):
    """k = 1, fewer lanes than one register tile (4), a ragged number of
    tiles, and more lanes than one launch takes (128: two launches).  The
    design (q = 17) has fewer coordinates than the grid has blocks, so
    most blocks own no row of Minv and still take every grid sync."""
    (Xa, Minv, ys, mask, lams, rho), kw = _glm_args(dev, "binomial", True)
    lam_k = torch.tensor(np.geomspace(float(lams[0]), float(lams[-1]), k),
                         dtype=torch.float32, device=dev)
    args = (Xa, Minv, ys, mask, lam_k, rho, 1e-6, 1e-6, 1.0, MAXIT)
    before = kernels.launch_counts()["glm_batch_path"]
    z, niter = glm.glm_batch_path(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["glm_batch_path"] == before + len(
        glm.launch_plan(303, 17, k, 132)["lane_groups"])
    z_ref, n_ref = glm.glm_batch_path_reference(*args, **kw)
    assert z.shape == (k, 17)
    assert float((z - z_ref).abs().max()) <= 2e-5
    assert int((niter - n_ref).abs().max()) <= 1


@pytest.mark.parametrize("n,p,m", [(5, 9, 3), (61, 163, 1), (61, 163, 9),
                                   (200, 1030, 33)])
def test_bp_kernel_ragged_shapes(dev, n, p, m):
    """n and p that are no multiples of 4 (padded leading dimensions),
    fewer rows than the grid has blocks (n = 5, p = 9), one lane, and lane
    counts that are no multiple of the register tile."""
    gen = torch.Generator(device="cpu").manual_seed(n + p + m)
    A = (torch.randn((n, p), generator=gen) / n ** 0.5).to(dev)
    B = torch.randn((m, n), generator=gen).to(dev)
    Winv = chol_inverse(tgram(A), jitter=1e-6).contiguous()
    args = (A, Winv, (B @ (Winv @ A)).contiguous(), 5.0, 1e-5, 1e-5, 400)
    z, niter = bp.bp_batch_solve(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = bp.bp_batch_solve_reference(*args)
    assert z.shape == (m, p) and float(z.abs().max()) > 0.0
    assert float((z - z_ref).abs().max()) <= 1e-4
    for a, b in zip(niter.tolist(), n_ref.tolist()):
        assert abs(a - b) <= max(3, int(0.05 * b))


def test_bp_kernel_lane_at_maxit(bp_args):
    """Lanes that run out of iterations report ``maxit`` and the state
    they reached, as the plain form does."""
    A, Winv, AAAB, _ = bp_args
    args = (A, Winv, AAAB, 5.0, 1e-7, 1e-7, 9)
    z, niter = bp.bp_batch_solve(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = bp.bp_batch_solve_reference(*args)
    assert niter.tolist() == n_ref.tolist() == [9] * 5
    assert float((z - z_ref).abs().max()) <= 1e-5


def test_two_launches_give_identical_bits(dev, bp_args):
    """No atomics and sums in a fixed order: the same inputs give the same
    bits and the same niter twice, for both kernels."""
    args, kw = _glm_args(dev, "binomial", True)
    runs = [glm.glm_batch_path(*args, 1e-6, 1e-6, 1.0, MAXIT, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    A, Winv, AAAB, _ = bp_args
    runs = [bp.bp_batch_solve(A, Winv, AAAB, 5.0, 1e-6, 1e-6, 3000)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


# ---------------------------------------------------------------------------
# The cooperative-grid design of the tall scan and wide batch kernels: the
# scan's one lane is split over the grid's warps with the loop over lambda
# inside the kernel; the wide kernel runs every lambda in every block.
# ---------------------------------------------------------------------------

def _tall_problem(dev, n, p, k, above=1.0):
    """Minv, X'y, a lambda grid from ``above * lambda0`` down, and rho."""
    rng = np.random.default_rng(n + p + k)
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.4)
    Xs, ys = _std(X, 1.0 + X @ b + 0.3 * rng.normal(size=n), dev)
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0 * above, lam0 * 1e-3, k),
                         dtype=torch.float32, device=dev)
    Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], -1.0)
    return Minv.contiguous(), Xty.contiguous(), ilams, rho


def _wide_problem(dev, n, p, k, alpha=1.0, above=1.1):
    rng = np.random.default_rng(n + p + k)
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:max(1, p // 12)] = rng.normal(size=max(1, p // 12))
    Xs, ys = _std(X, X @ b + 0.2 * rng.normal(size=n), dev)
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0 * above, lam0 * 1e-2, k),
                         dtype=torch.float32, device=dev)
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams, -1.0, alpha, False)
    return (Xs.contiguous(), ys.contiguous(), ilams,
            torch.broadcast_to(rho, (k,)).contiguous(), sprad, lambda0)


@pytest.mark.parametrize("alpha", [1.0, 0.6])
@pytest.mark.parametrize("n,p,k", [(30, 5, 4), (90, 37, 12), (400, 203, 20),
                                   (2500, 1030, 6)])
def test_tall_scan_kernel_ragged_shapes(dev, n, p, k, alpha):
    """p that is no multiple of four (a padded leading dimension of the
    transposed Minv), fewer coordinates than one block has warps (p = 5:
    a grid of one block), a grid narrower than the card (p = 37, 203) and
    several coordinates per warp (p = 1030), on a lambda grid that starts
    above lambda0.  niter must equal the plain form's at every lambda: the
    warm start of each lambda depends on where the last one stopped."""
    args = (*_tall_problem(dev, n, p, k, above=1.2), 1e-5, 1e-5, alpha, MAXIT)
    before = kernels.launch_counts()["tall_path_scan"]
    z, niter = tall_path.tall_path_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tall_path_scan"] == before + 1
    z_ref, n_ref = tall_path.tall_path_scan_reference(*args)
    assert z.shape == (k, p) and niter.dtype == torch.int32
    assert torch.equal(z[0] == 0, z_ref[0] == 0)
    assert float(z[-1].abs().max()) > 0.0
    assert float((z - z_ref).abs().max()) <= 1e-5
    assert niter.tolist() == n_ref.tolist()
    assert int(niter.max()) < MAXIT


@pytest.mark.parametrize("maxit", [1, 2, 7])
def test_tall_scan_kernel_lambdas_that_stop_at_maxit(tall_args, maxit):
    """Lambdas that run out of iterations report ``maxit``, the state
    carries over as in the plain form, and with an odd ``maxit`` the
    last iteration of one lambda and the first of the next would share the
    parity of a per-lambda count (the exchange buffers go by a count over
    the whole path)."""
    args = (*tall_args, 1e-9, 1e-9, 0.6, maxit)
    z, niter = tall_path.tall_path_scan(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = tall_path.tall_path_scan_reference(*args)
    assert niter.tolist() == n_ref.tolist() and int(niter.max()) == maxit
    assert float((z - z_ref).abs().max()) <= 1e-5


def test_tall_scan_kernel_one_lambda_equals_the_batch_kernel(tall_args):
    """From a cold start one lambda of the scan is one lane of the batch
    kernel: the same coefficients within 1e-5 and niter within 1."""
    Minv, Xty, ilams, rho = tall_args
    args = (Minv, Xty, ilams[4:5].contiguous(), rho, 1e-5, 1e-5, 1.0, MAXIT)
    z, niter = tall_path.tall_path_scan(*args)
    zb, nb = tall_path.tall_path_batch(*args)
    torch.cuda.synchronize()
    assert float((z - zb).abs().max()) <= 1e-5
    assert abs(int(niter[0]) - int(nb[0])) <= 1


@pytest.mark.parametrize("alpha", [1.0, 0.6])
@pytest.mark.parametrize("n,p,k", [(5, 9, 3), (61, 163, 1), (61, 163, 2),
                                   (61, 163, 37), (61, 163, 130),
                                   (203, 1030, 9)])
def test_wide_kernel_ragged_shapes_and_lane_counts(dev, n, p, k, alpha):
    """n and p that are no multiples of four, fewer rows than the grid has
    blocks, one lane, fewer lanes than one register tile, a ragged number of
    tiles and more lanes than one launch takes (128: two launches); the
    first lambda is above lambda0 and stays exactly 0."""
    args = (*_wide_problem(dev, n, p, k, alpha), 1e-5, 1e-5, alpha, MAXIT)
    before = kernels.launch_counts()["wide_path_batch"]
    x, niter = wide_path.wide_path_batch(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wide_path_batch"] == before + len(
        wide_path.launch_plan(n, p, k, 132)["lane_groups"])
    x_ref, n_ref = wide_path.wide_path_batch_reference(*args)
    assert x.shape == (k, p) and niter.dtype == torch.int32
    assert float(x[0].abs().max()) == 0.0
    assert k == 1 or float(x[-1].abs().max()) > 0.0
    assert float((x - x_ref).abs().max()) <= 1e-5
    assert int((niter - n_ref).abs().max()) <= 1
    assert int(niter.max()) < MAXIT


def test_wide_kernel_lane_at_maxit(wide_args):
    """Lanes that run out of iterations report ``maxit`` and the state
    they reached, as the plain form does; the lane above lambda0 converges
    before that with x = 0."""
    args = (*wide_args, 1e-7, 1e-7, 1.0, 9)
    x, niter = wide_path.wide_path_batch(*args)
    torch.cuda.synchronize()
    x_ref, n_ref = wide_path.wide_path_batch_reference(*args)
    assert niter.tolist() == n_ref.tolist() and int(niter.max()) == 9
    assert float((x - x_ref).abs().max()) <= 1e-5


def test_wide_lanes_that_finish_apart_equal_each_lane_alone(wide_args):
    """Nine lanes converge at different iterations, each with its own rho;
    each must come out as if it had run alone (k = 1), to the bit."""
    Xs, ys, ilams, rhos, sprad, lambda0 = wide_args
    tail = (sprad, lambda0, 1e-5, 1e-5, 1.0, MAXIT)
    x, niter = wide_path.wide_path_batch(Xs, ys, ilams, rhos, *tail)
    torch.cuda.synchronize()
    assert len(set(niter.tolist())) > 1 and int(niter.max()) < MAXIT
    for i in range(ilams.shape[0]):
        x1, n1 = wide_path.wide_path_batch(Xs, ys, ilams[i:i + 1].contiguous(),
                                           rhos[i:i + 1].contiguous(), *tail)
        assert int(n1[0]) == int(niter[i]) and torch.equal(x1[0], x[i])


def test_wide_kernel_walks_the_rho_ladder_per_lane(wide_args):
    """With the ladder held for the whole solve (``rho_start_iter`` past
    ``maxit``) the plain form needs other iteration counts than with the
    ladder on: the ladder moves rho on this problem.  The kernel follows
    the plain form lane by lane both ways."""
    args = (*wide_args, 1e-5, 1e-5, 1.0, MAXIT)
    _, n_on = wide_path.wide_path_batch_reference(*args)
    _, n_held = wide_path.wide_path_batch_reference(*args,
                                                    rho_start_iter=MAXIT)
    assert n_on.tolist() != n_held.tolist()
    for kw, n_ref in ((dict(), n_on), (dict(rho_start_iter=MAXIT), n_held)):
        x, niter = wide_path.wide_path_batch(*args, **kw)
        x_ref, _ = wide_path.wide_path_batch_reference(*args, **kw)
        assert niter.tolist() == n_ref.tolist()
        assert float((x - x_ref).abs().max()) <= 1e-5


def test_scan_and_wide_launches_give_identical_bits(tall_args, wide_args):
    """No atomics and sums in a fixed order: the same inputs give the same
    bits and the same niter twice, for both kernels."""
    runs = [tall_path.tall_path_scan(*tall_args, 1e-5, 1e-5, 0.6, MAXIT)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    runs = [wide_path.wide_path_batch(*wide_args, 1e-5, 1e-5, 0.6, MAXIT)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def _wide_scan_problem(dev, n, p, k, alpha, seed):
    """The README's wide generator (100 nonzeros U(-1, 1), y = 5 + Xb +
    N(0, 1)), standardized on the card, and the path's own grid (ratio
    0.01, its top at lambda0) and set-up."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    idx = rng.choice(p, size=min(100, p), replace=False)
    b[idx] = rng.uniform(-1, 1, idx.size)
    f32 = dict(dtype=torch.float32, device=dev)
    Xs, ys, stats = standardize(torch.as_tensor(X, **f32),
                                torch.as_tensor(5 + X @ b + rng.normal(size=n),
                                                **f32),
                                standardize_x=True, intercept=True)
    lams = _auto_lambdas(Xs, ys, stats, k, 0.01, alpha, alpha < 1, None,
                         None)
    ilams = (lams * n / stats.scale_y).contiguous()
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams[0], -1.0, alpha,
                                      alpha < 1)
    return Xs.contiguous(), ys.contiguous(), ilams, rho, sprad, lambda0


@pytest.mark.parametrize("n,p,k,alpha", [(1000, 2000, 100, 1.0),
                                         (301, 1203, 20, 0.6)])
def test_wide_scan_kernel_matches_plain(dev, n, p, k, alpha):
    """The main path's 1000 x 2000 x 100 lambdas and a ragged shape (n and
    p multiples of neither 4 nor the block count): the kernel equals its
    plain form to the bit with the same niter per lambda, one launch a
    path, and a second launch gives the same bits."""
    args = (*_wide_scan_problem(dev, n, p, k, alpha, n + p), 1e-5, 1e-5,
            alpha, 10000)
    before = kernels.launch_counts()["wide_path_scan"]
    x, niter = wide_path.wide_path_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wide_path_scan"] == before + 1
    x_ref, n_ref = wide_path.wide_path_scan_reference(*args)
    assert torch.equal(niter, n_ref)
    assert torch.equal(x, x_ref)
    again = wide_path.wide_path_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(again[0], x) and torch.equal(again[1], niter)


def test_wide_scan_kernel_lambdas_at_maxit(dev):
    """At eps 1e-7 and maxit 9 every lambda stops at maxit, and the next
    one starts from where it stopped, as in the plain form."""
    args = (*_wide_scan_problem(dev, 60, 150, 9, 1.0, 11), 1e-7, 1e-7, 1.0,
            9)
    x, niter = wide_path.wide_path_scan(*args)
    x_ref, n_ref = wide_path.wide_path_scan_reference(*args)
    assert bool(torch.all(niter == 9)) and torch.equal(niter, n_ref)
    assert torch.equal(x, x_ref)


def test_lasso_path_launches_the_wide_scan_kernel_once(dev, monkeypatch):
    """The wide scan path on the card is one launch of the scan kernel and
    nothing else, and it lands within the wide path's parity bar of the
    engine's run of the same path."""
    import admm_tpu_torch as t
    from admm_tpu_torch.models import lasso

    rng = np.random.default_rng(5)
    X = rng.normal(size=(120, 300))
    y = X[:, :8] @ rng.uniform(-1, 1, 8) + 0.5 * rng.normal(size=120)
    before = kernels.launch_counts()
    res = t.lasso_path(X, y, nlambda=30, device=dev)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **dict.fromkeys(kernels.KERNELS, 0), "wide_path_scan": 1}
    monkeypatch.setattr(lasso, "_use_kernel_wide_scan", lambda *a: False)
    eng = t.lasso_path(X, y, nlambda=30, device=dev)
    assert kernels.launch_counts() == after
    assert torch.equal(res.lambdas, eng.lambdas)
    assert (res.coef - eng.coef).abs().max().item() <= 2e-4
    assert abs(int(res.niter.sum()) - int(eng.niter.sum())) \
        <= 0.02 * int(eng.niter.sum())


def test_wide_scan_kernel_rejects_what_it_does_not_take(dev):
    Xs, ys, ilams, rho, sprad, lambda0 = _wide_scan_problem(dev, 60, 150, 4,
                                                            1.0, 3)
    tail = (rho, sprad, lambda0, 1e-5, 1e-5, 1.0, 100)
    with pytest.raises(TypeError):
        wide_path.wide_path_scan(Xs.double(), ys, ilams, *tail)
    with pytest.raises(ValueError):
        wide_path.wide_path_scan(Xs, ys, ilams.cpu(), *tail)
    n, p = 1000, 2945
    assert not wide_path.scan_fits(n, p, 132)
    with pytest.raises(ValueError, match="do not fit"):
        wide_path.wide_path_scan(torch.zeros((n, p), device=dev),
                                 torch.zeros((n,), device=dev), ilams, *tail)


def test_tall_scan_kernel_largest_p(dev):
    """p = MAX_P is the most ``fits`` admits (the first batch kernel's 8p
    floats of shared memory; the scan kernel's blocks hold 7p) and Minv
    (207 MB) is past the L2; p + 1 is refused.  Three iterations at each of two
    lambdas: z within 1e-5 of the plain form's."""
    p = tall_path.MAX_P
    assert tall_path.fits(p) and not tall_path.fits(p + 1)
    Minv, Xty, ilams, rho = _tall_problem(dev, 300, p, 2, above=0.5)
    args = (Minv, Xty, ilams, rho, 1e-9, 1e-9, 1.0, 3)
    z, niter = tall_path.tall_path_scan(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = tall_path.tall_path_scan_reference(*args)
    assert niter.tolist() == n_ref.tolist() == [3, 3]
    assert float(z.abs().max()) > 0.0
    assert float((z - z_ref).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="tall path kernels take"):
        tall_path.tall_path_scan(torch.zeros((p + 1, p + 1), device=dev),
                                 torch.zeros((p + 1,), device=dev), ilams,
                                 rho, 1e-9, 1e-9, 1.0, 3)


def test_wide_kernel_largest_shape(dev):
    """n = 400, p = 18533 is the widest design the dispatch bound of
    ``fits`` admits at that n (3p + 5n <= 57600); p + 1 is past it and the
    wrapper refuses it.  Three iterations of two lanes: x within 1e-5 of
    the plain form's."""
    n, p = 400, 18533
    assert wide_path.fits(n, p) and not wide_path.fits(n, p + 1)
    Xs, ys, ilams, rhos, sprad, lambda0 = _wide_problem(dev, n, p, 2,
                                                        above=0.5)
    args = (Xs, ys, ilams, rhos, sprad, lambda0, 1e-9, 1e-9, 1.0, 3)
    x, niter = wide_path.wide_path_batch(*args)
    torch.cuda.synchronize()
    x_ref, n_ref = wide_path.wide_path_batch_reference(*args)
    assert niter.tolist() == n_ref.tolist() == [3, 3]
    assert float(x.abs().max()) > 0.0
    assert float((x - x_ref).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="wide path kernel takes"):
        wide_path.wide_path_batch(torch.zeros((n, p + 1), device=dev), ys,
                                  ilams, rhos, sprad, lambda0, 1e-9, 1e-9,
                                  1.0, 3)


# ---------------------------------------------------------------------------
# The LAD kernel's ring of bulk async copies, and the tall batch kernel as a
# cooperative grid whose blocks share each load of Minv among the lanes.
# ---------------------------------------------------------------------------

def _lad_problem(dev, n, p=12):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, p))
    y = X @ rng.normal(size=p) + rng.standard_t(2, size=n)
    Xs = torch.as_tensor(X, dtype=torch.float32, device=dev)
    ys = torch.as_tensor(y, dtype=torch.float32, device=dev)
    Ginv = chol_inverse(gram(Xs), jitter=1e-6)
    H = (Xs @ (Ginv @ Xs.mT)).contiguous()
    return X, y, Xs, ys, Ginv, H


@pytest.mark.parametrize("n", [997, 1000, 4097])
def test_lad_kernel_ragged_n_matches_plain(dev, n):
    """A whole solve at n = 997 (rows padded to 1000 floats), 1000 (blocks
    of 7 and 8 rows, the ring holding several iterations) and 4097 (rows
    padded to 4100 and cut into two stages of unequal length): the JAX
    package's bar, coefficients within 5e-3 and an L1 objective no more
    than 1.001x the plain form's, and niter within max(3, 5%)."""
    X, y, Xs, ys, Ginv, H = _lad_problem(dev, n)
    ynorm = torch.linalg.norm(ys)
    args = (H, ys, 5.0, 2e-5, 2e-5, ynorm, MAXIT)
    ay, az, niter = lad.lad_solve(*args)
    torch.cuda.synchronize()
    ay_ref, az_ref, n_ref = lad.lad_solve_reference(*args)
    assert 0 < int(niter) < MAXIT
    assert abs(int(niter) - int(n_ref)) <= max(3, int(0.05 * int(n_ref)))

    def coef_of(adj_y, adj_z):
        v = ys - adj_y / 5.0 + adj_z
        return (Ginv @ (Xs.mT @ v)).cpu().numpy().astype(np.float64)

    c, c_ref = coef_of(ay, az), coef_of(ay_ref, az_ref)
    obj = lambda c: np.abs(y - X @ c).sum()
    np.testing.assert_allclose(c, c_ref, atol=5e-3)
    assert obj(c) <= obj(c_ref) * 1.001


def test_lad_kernel_takes_ynorm_as_a_tensor_or_a_number(lad_args):
    """||ys|| as a 0-d tensor on the card (what ``lad_fit`` passes: no host
    read before the launch) or as a host number gives the same bits."""
    w = lad_args
    tail = (w["H"], w["ys"], 5.0, 1e-5, 1e-5)
    a = lad.lad_solve(*tail, torch.linalg.norm(w["ys"]), MAXIT)
    b = lad.lad_solve(*tail, w["ynorm"], MAXIT)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("maxit", [1, 2, 7])
def test_lad_kernel_stops_at_maxit(lad_args, maxit):
    """Solves that run out of iterations report ``maxit`` and the state the
    plain form reaches (the producer's copies still in flight land before
    the block ends)."""
    w = lad_args
    args = (w["H"], w["ys"], 5.0, 1e-9, 1e-9, w["ynorm"], maxit)
    ay, az, niter = lad.lad_solve(*args)
    torch.cuda.synchronize()
    ay_ref, az_ref, n_ref = lad.lad_solve_reference(*args)
    assert int(niter) == int(n_ref) == maxit
    assert float((ay - ay_ref).abs().max()) <= 1e-5
    assert float((az - az_ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("alpha", [1.0, 0.6])
@pytest.mark.parametrize("n,p,k", [(30, 5, 4), (90, 37, 1), (400, 203, 20),
                                   (300, 163, 130), (2500, 1030, 6)])
def test_tall_batch_kernel_ragged_shapes_and_lane_counts(dev, n, p, k,
                                                         alpha):
    """p that is no multiple of four (a padded leading dimension of the
    transposed Minv), fewer coordinates than the grid has blocks (p = 5,
    37), one lane, more lanes than one launch takes (130: two launches),
    on a lambda grid that starts above lambda0: z within 1e-5 and niter
    within 1 per lane of the plain form's."""
    args = (*_tall_problem(dev, n, p, k, above=1.2), 1e-5, 1e-5, alpha, MAXIT)
    before = kernels.launch_counts()["tall_path_batch"]
    z, niter = tall_path.tall_path_batch(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tall_path_batch"] == before + len(
        tall_path.batch_launch_plan(p, k, 132)["lane_groups"])
    z_ref, n_ref = tall_path.tall_path_batch_reference(*args)
    assert z.shape == (k, p) and niter.dtype == torch.int32
    assert torch.equal(z[0] == 0, z_ref[0] == 0)
    assert float((z - z_ref).abs().max()) <= 1e-5
    assert int((niter - n_ref).abs().max()) <= 1
    assert int(niter.max()) < MAXIT


@pytest.mark.parametrize("maxit", [1, 2, 7])
def test_tall_batch_kernel_lanes_at_maxit(tall_args, maxit):
    """Lanes that run out of iterations report ``maxit`` and the state they
    reached, as the plain form does."""
    args = (*tall_args, 1e-9, 1e-9, 0.6, maxit)
    z, niter = tall_path.tall_path_batch(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = tall_path.tall_path_batch_reference(*args)
    assert niter.tolist() == n_ref.tolist() == [maxit] * len(niter)
    assert float((z - z_ref).abs().max()) <= 1e-5


def test_tall_batch_lanes_that_finish_apart_equal_each_lane_alone(tall_args):
    """Ten lanes converge at different iterations; each must come out as if
    it had run alone (k = 1), to the bit."""
    Minv, Xty, ilams, rho = tall_args
    tail = (rho, 1e-5, 1e-5, 1.0, MAXIT)
    z, niter = tall_path.tall_path_batch(Minv, Xty, ilams, *tail)
    torch.cuda.synchronize()
    assert len(set(niter.tolist())) > 1 and int(niter.max()) < MAXIT
    for i in range(ilams.shape[0]):
        z1, n1 = tall_path.tall_path_batch(Minv, Xty,
                                           ilams[i:i + 1].contiguous(), *tail)
        assert int(n1[0]) == int(niter[i]) and torch.equal(z1[0], z[i])


def test_lad_and_tall_batch_launches_give_identical_bits(lad_args, tall_args):
    """No atomics and sums in a fixed order: the same inputs give the same
    bits and the same niter twice, for both kernels."""
    w = lad_args
    runs = [lad.lad_solve(w["H"], w["ys"], 5.0, 1e-5, 1e-5, w["ynorm"],
                          MAXIT) for _ in range(2)]
    torch.cuda.synchronize()
    for u, v in zip(*runs):
        assert torch.equal(u, v)
    runs = [tall_path.tall_path_batch(*tall_args, 1e-5, 1e-5, 0.6, MAXIT)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_tall_batch_kernel_largest_p(dev):
    """p = MAX_P with Minv (207 MB) past the L2, two lanes, three
    iterations: z within 1e-5 of the plain form's; p + 1 is refused."""
    p = tall_path.MAX_P
    Minv, Xty, ilams, rho = _tall_problem(dev, 300, p, 2, above=0.5)
    args = (Minv, Xty, ilams, rho, 1e-9, 1e-9, 1.0, 3)
    z, niter = tall_path.tall_path_batch(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = tall_path.tall_path_batch_reference(*args)
    assert niter.tolist() == n_ref.tolist() == [3, 3]
    assert float(z.abs().max()) > 0.0
    assert float((z - z_ref).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="tall path kernels take"):
        tall_path.tall_path_batch(torch.zeros((p + 1, p + 1), device=dev),
                                  torch.zeros((p + 1,), device=dev), ilams,
                                  rho, 1e-9, 1e-9, 1.0, 3)


def test_tall_cv_gives_the_same_bits_twice(dev):
    """``cv_lasso_path`` on the card: the full fit and every fold are
    launches of the tall batch kernel (1 + nfolds), and a second call on
    the same inputs gives the same cvm to the bit."""
    from admm_tpu_torch.models.cv import cv_lasso_path

    rng = np.random.default_rng(5)
    n, p = 400, 40
    X = rng.normal(size=(n, p))
    y = X[:, :5] @ np.array([1.5, -1.0, 0.8, 0.5, -0.3]) + rng.normal(size=n)
    kernels.reset_launch_counts()
    runs = [cv_lasso_path(X, y, nfolds=5, nlambda=20, device=dev)
            for _ in range(2)]
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "tall_path_batch": 12}
    assert np.array_equal(runs[0].cvm, runs[1].cvm)
    assert np.array_equal(runs[0].cvsd, runs[1].cvsd)
    assert runs[0].lambda_min == runs[1].lambda_min


def test_prediction_on_the_card_matches_the_host(dev):
    """``predict``, ``assess`` and ``path_table`` of a fit made on the card
    run there in float64 and agree with the same fit moved to the CPU to
    rtol 1e-10 (the products add in another order)."""
    import admm_tpu_torch as t
    from admm_tpu_torch.predict import _predict

    rng = np.random.default_rng(12)
    X = rng.normal(size=(300, 30))
    y = (X[:, 0] - X[:, 1] + rng.normal(size=300) > 0).astype(float)
    fit = t.logistic_lasso_path(X, y, nlambda=10, device=dev)
    host = fit._replace(**{k: v.cpu() for k, v in fit._asdict().items()
                           if isinstance(v, torch.Tensor)})
    lam = float(fit.lambdas[4])
    assert _predict(fit, X, lam, "response", "binomial", None,
                    None).device.type == "cuda"
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-10,
                                                    atol=1e-13)
    for kw in (dict(), dict(lam=lam, type="response", family="binomial")):
        close(t.predict(fit, X, **kw), t.predict(host, X, **kw))
    got, want = (t.assess(r, X, y, family="binomial") for r in (fit, host))
    for k in want:
        close(got[k], want[k])
    got, want = (t.path_table(r, X, y, family=t.binomial) for r in (fit, host))
    np.testing.assert_array_equal(got.df, want.df)
    close(got.dev_ratio, want.dev_ratio)


def test_traced_path_on_the_card_launches_nothing(dev):
    """A traced ``lasso_path`` runs the engine, never a kernel, and its
    trace equals the CPU engine's to 1e-5 (relative to each trace
    column's largest entry; the products add in another order)."""
    import admm_tpu_torch as t

    rng = np.random.default_rng(8)
    X = rng.normal(size=(200, 40))
    y = X[:, :5] @ np.ones(5) + 0.3 * rng.normal(size=200)
    for mode in ("scan", "batch"):
        kw = dict(nlambda=8, trace_len=64, path_mode=mode, rho=20.0,
                  dtype=torch.float64)
        kernels.reset_launch_counts()
        card = t.lasso_path(X, y, device=dev, **kw)
        assert not any(kernels.launch_counts().values())
        host = t.lasso_path(X, y, device="cpu", **kw)
        a, b = card.trace.cpu().numpy(), host.trace.numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b))
        scale = np.nanmax(np.abs(b), axis=1, keepdims=True)
        assert np.nanmax(np.abs(a - b) / scale) <= 1e-5
        assert torch.equal(card.niter.cpu(), host.niter)


def test_relaxed_path_runs_the_scan_kernel_as_its_plain_form(dev):
    """``relaxed_lasso_path`` reaches the tall scan kernel once; on the
    inputs it gave the kernel, the kernel equals its plain form (gap 0,
    identical niter)."""
    import admm_tpu_torch as t

    rng = np.random.default_rng(9)
    X = rng.normal(size=(300, 30))
    y = X[:, :4] @ np.r_[1.5, -1.0, 0.8, 0.5] + rng.normal(size=300)
    seen = []
    real = tall_path.tall_path_scan

    def keep(*a, **k):
        seen.append((a, k))
        return real(*a, **k)
    kernels.reset_launch_counts()
    tall_path.tall_path_scan = keep
    try:
        res = t.relaxed_lasso_path(X, y, nlambda=20, device=dev)
    finally:
        tall_path.tall_path_scan = real
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "tall_path_scan": 1}
    (a, k), = seen
    zk, nk = tall_path.tall_path_scan(*a, **k)
    zp, np_ = tall_path.tall_path_scan_reference(*a, **k)
    assert float((zk - zp).abs().max()) == 0.0 and torch.equal(nk, np_)
    assert torch.isfinite(res.coef).all()


def test_activeset_gives_the_same_bits_twice(dev):
    """The active-set path on the card, run twice on the same inputs (a
    support capped below p, so the refresh ranks ties): identical bits
    and niter."""
    import admm_tpu_torch as t
    from admm_tpu_torch.models import lasso as lasso_mod

    rng = np.random.default_rng(10)
    X = rng.normal(size=(100, 600))
    b = np.zeros(600)
    b[:8] = rng.uniform(1.0, 2.0, 8)
    y = X @ b + 0.5 * rng.normal(size=100)
    kernels.reset_launch_counts()
    runs = [t.lasso_path(X, y, nlambda=10, path_mode="activeset",
                         device=dev) for _ in range(2)]
    assert not any(kernels.launch_counts().values())
    assert torch.equal(runs[0].coef, runs[1].coef)
    assert torch.equal(runs[0].niter, runs[1].niter)
    Xs, ys = _std(X, y, dev)
    lams = torch.tensor(np.geomspace(1.0, 0.05, 6), dtype=torch.float32,
                        device=dev) * float(torch.max(torch.abs(Xs.mT @ ys)))
    capped = [lasso_mod._solve_path_wide_activeset(
        Xs, ys, lams, 1.0, MAXIT, 1e-5, 1e-5, 1.0, False, s_max=20)
        for _ in range(2)]
    assert torch.equal(capped[0][0], capped[1][0])
    assert torch.equal(capped[0][1], capped[1][1])


SECOND_FAMILIES = ["sqrt_lasso_path", "quantile_lasso_path", "slope_path",
                   "svm_path", "multitask_lasso_path",
                   "multitask_nuclear_path", "multinomial_lasso_path"]


@pytest.mark.parametrize("family", SECOND_FAMILIES)
def test_second_families_on_the_card_launch_nothing(dev, family):
    """The square-root, quantile, SLOPE, SVM, multi-task and multinomial
    paths run the engine on the card (no kernel launches) and equal their
    float64 runs on the CPU: coefficients within 1e-6, niter within 1 per
    path point."""
    import admm_tpu_torch as t

    rng = np.random.default_rng(11)
    n, p = 120, 10
    X = rng.normal(size=(n, p))
    B = np.zeros((p, 3))
    B[:3] = rng.normal(size=(3, 3))
    eta = X @ B
    y = eta[:, 0] + 0.5 * rng.normal(size=n)
    Y = eta + 0.5 * rng.normal(size=(n, 3))
    cls = np.argmax(eta + rng.gumbel(size=(n, 3)), axis=1)
    call = {
        "sqrt_lasso_path": lambda **kw: t.sqrt_lasso_path(X, y, nlambda=6,
                                                          **kw),
        "quantile_lasso_path": lambda **kw: t.quantile_lasso_path(
            X, y, tau=[0.3, 0.7], nlambda=3, eps_abs=1e-5, eps_rel=1e-5,
            **kw),
        "slope_path": lambda **kw: t.slope_path(X, y, nlambda=6, **kw),
        "svm_path": lambda **kw: t.svm_path(X, y > 0, nC=5, **kw),
        "multitask_lasso_path": lambda **kw: t.multitask_lasso_path(
            X, Y, nlambda=5, **kw),
        "multitask_nuclear_path": lambda **kw: t.multitask_nuclear_path(
            X, Y, nlambda=5, **kw),
        "multinomial_lasso_path": lambda **kw: t.multinomial_lasso_path(
            X, cls, nlambda=5, **kw),
    }[family]
    kernels.reset_launch_counts()
    card = call(device=dev, dtype=torch.float64)
    assert not any(kernels.launch_counts().values())
    host = call(device="cpu", dtype=torch.float64)
    assert card.coef.device.type == "cuda"
    np.testing.assert_allclose(card.coef.cpu().numpy(), host.coef.numpy(),
                               atol=1e-6, rtol=1e-7)
    gap = (card.niter.cpu().to(torch.int64) - host.niter).abs().max()
    assert int(gap) <= 1


def test_newton_schulz_prox_on_the_card_f32_against_f64(dev):
    """The graphical lasso's Newton-Schulz logdet prox in float32 on the
    card against its float64 run: within the JAX package's float32 bar
    for this prox against the eigh form (rel. Frobenius 5e-5,
    tests/test_glasso.py), which TF32 products (about three decimal
    digits) would miss by far."""
    from admm_tpu_torch.models import glasso

    rng = np.random.default_rng(12)
    B = rng.normal(size=(200, 200))
    G64 = torch.as_tensor(0.5 * (B + B.T), device=dev)
    for rho in (0.05, 1.0, 64.0):
        want = glasso._logdet_prox_newton(
            G64, torch.tensor(rho, dtype=torch.float64, device=dev))
        got = glasso._logdet_prox_newton(
            G64.float(), torch.tensor(rho, dtype=torch.float32, device=dev))
        rel = float(torch.linalg.norm(got.double() - want)
                    / torch.linalg.norm(want))
        assert rel < 5e-5, (rho, rel)


LAST_FAMILIES = ["cox_lasso_path", "glasso_path", "rpca"]


@pytest.mark.parametrize("family", LAST_FAMILIES)
def test_last_families_on_the_card_launch_nothing(dev, family):
    """The Cox path, the graphical lasso and robust PCA run the engine on
    the card (no kernel launches) and equal their float64 runs on the
    CPU: within 1e-6, niter within 1 per path point."""
    import admm_tpu_torch as t

    rng = np.random.default_rng(13)
    X = rng.normal(size=(120, 10))
    tt = rng.exponential(np.exp(-X[:, 0])) + 0.01
    ev = (rng.random(120) < 0.7) * 1.0
    M = rng.normal(size=(30, 2)) @ rng.normal(size=(2, 20))
    M[rng.random(M.shape) < 0.05] += 5.0
    call = {
        "cox_lasso_path": lambda **kw: t.cox_lasso_path(X, tt, ev, nlambda=5,
                                                        **kw),
        "glasso_path": lambda **kw: t.glasso_path(X, nlambda=5, **kw),
        "rpca": lambda **kw: t.rpca(M, **kw),
    }[family]
    kernels.reset_launch_counts()
    card = call(device=dev, dtype=torch.float64)
    assert not any(kernels.launch_counts().values())
    host = call(device="cpu", dtype=torch.float64)
    for a, b in zip(card, host):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            assert a.device.type == "cuda"
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-7)
    gap = (card.niter.cpu().to(torch.int64) - host.niter).abs().max()
    assert int(gap) <= 1


def test_glmnet_gaussian_launches_the_tall_scan_kernel_once(dev):
    """``glmnet(family="gaussian")`` is ``lasso_path``'s default scan: one
    launch of the tall scan kernel, nothing else, and the driver's own
    result to the bit."""
    import admm_tpu_torch as t

    rng = np.random.default_rng(14)
    X = rng.normal(size=(300, 40)).astype(np.float32)
    y = (X[:, :5].sum(axis=1) + rng.normal(size=300)).astype(np.float32)
    kernels.reset_launch_counts()
    fit = t.glmnet(X, y, "gaussian", nlambda=20, device=dev)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "tall_path_scan": 1}
    own = t.lasso_path(X, y, nlambda=20, device=dev)
    assert torch.equal(fit.coef, own.coef)
    assert torch.equal(fit.niter, own.niter)


def test_svt_on_the_card_f32_against_f64(dev):
    """The exact SVT of a float32 500 x 500 matrix on the card within 1e-4
    of its float64 run (cuSOLVER's float32 driver alone is 2.4e-3 off),
    and PCP in float32 on the card within one iteration of float64."""
    import admm_tpu_torch as t
    from admm_tpu_torch.models import rpca

    rng = np.random.default_rng(15)
    M = rng.normal(size=(500, 5)) @ rng.normal(size=(5, 500))
    hit = rng.uniform(size=M.shape) < 0.05
    M[hit] += 10 * rng.choice([-1.0, 1.0], size=hit.sum())
    A = torch.as_tensor(M, device=dev)
    got = rpca.svt(A.float(), 5.0)
    assert got.dtype == torch.float32
    assert float((got.double() - rpca.svt(A, 5.0)).abs().max()) < 1e-4
    kw = dict(maxit=2000, eps_abs=1e-6, eps_rel=1e-5, device=dev)
    n32 = int(t.rpca(M, dtype=torch.float32, **kw).niter)
    n64 = int(t.rpca(M, dtype=torch.float64, **kw).niter)
    assert abs(n32 - n64) <= 1, (n32, n64)


CONSENSUS_DRIVERS = ["lasso_tall", "lasso_wide", "enet", "group", "slope",
                     "zerosum", "bp", "logistic", "poisson", "multinomial",
                     "multitask_nuclear"]


def _consensus_call(driver):
    """A small seeded problem for each consensus driver."""
    import admm_tpu_torch as t

    rng = np.random.default_rng(21)
    X = rng.normal(size=(203, 24))
    b = np.zeros(24)
    b[:5] = rng.normal(size=5)
    eta = X @ b
    y = 1.0 + eta + 0.5 * rng.normal(size=203)
    Xw = rng.normal(size=(60, 90))
    yw = Xw[:, :6] @ rng.normal(size=6) + 0.3 * rng.normal(size=60)
    A = rng.normal(size=(30, 90)) / np.sqrt(30)
    x0 = np.zeros(90)
    x0[[4, 40, 77]] = [1.0, -1.5, 0.7]
    Y = np.stack([eta, -eta, 0.5 * eta], axis=1) + rng.normal(size=(203, 3))
    cls = np.argmax(np.stack([eta, -eta, 0 * eta], axis=1)
                    + rng.gumbel(size=(203, 3)), axis=1)
    counts = rng.poisson(np.exp(0.3 * np.clip(eta, -3, 3))) * 1.0
    return {
        "lasso_tall": lambda **kw: t.parallel_lasso_path(
            X, y, nworkers=4, nlambda=8, **kw),
        "lasso_wide": lambda **kw: t.parallel_lasso_path(
            Xw, yw, nworkers=2, nlambda=8, **kw),
        "enet": lambda **kw: t.parallel_enet_path(
            X, y, nworkers=3, alpha=0.6, nlambda=8, **kw),
        "group": lambda **kw: t.parallel_group_lasso_path(
            X, y, np.arange(24) // 4, nworkers=4, nlambda=6, **kw),
        "slope": lambda **kw: t.parallel_slope_path(X, y, nworkers=4,
                                                    nlambda=6, **kw),
        "zerosum": lambda **kw: t.parallel_zerosum_lasso_path(
            X, y, nworkers=4, nlambda=6, **kw),
        "bp": lambda **kw: t.parallel_bp_fit(A, A @ x0, nworkers=2, **kw),
        "logistic": lambda **kw: t.parallel_logistic_lasso_path(
            X, (eta > 0) * 1.0, nworkers=4, nlambda=5, **kw),
        "poisson": lambda **kw: t.parallel_poisson_lasso_path(
            X, counts, nworkers=4, nlambda=5, **kw),
        "multinomial": lambda **kw: t.parallel_multinomial_lasso_path(
            X, cls, nworkers=4, nlambda=5, **kw),
        "multitask_nuclear": lambda **kw: t.parallel_multitask_lasso_path(
            X, Y, nworkers=2, nlambda=5, penalty="nuclear", **kw),
    }[driver]


@pytest.mark.parametrize("driver", CONSENSUS_DRIVERS)
def test_consensus_on_the_card_launches_nothing_and_equals_the_cpu(dev,
                                                                   driver):
    """The consensus drivers in float64 on the card: no kernel launches,
    and the CPU run's coefficients within 1e-8, niter within 1 per
    lambda."""
    call = _consensus_call(driver)
    kernels.reset_launch_counts()
    card = call(device=dev, dtype=torch.float64)
    assert not any(kernels.launch_counts().values())
    host = call(device="cpu", dtype=torch.float64)
    assert card.coef.device.type == "cuda"
    np.testing.assert_allclose(card.coef.cpu().numpy(), host.coef.numpy(),
                               atol=1e-8, rtol=1e-7)
    gap = (card.niter.cpu().to(torch.int64) - host.niter).abs().max()
    assert int(gap) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_consensus_chunked_loop_equals_one_read_per_iteration_on_the_card(
        dev, dtype, monkeypatch):
    """One host read per ``_CHUNK`` iterations of the engine's host loop
    on the card: the same bits, niter and trace rows as a read every
    iteration (``_CHUNK = 1``)."""
    from admm_tpu_torch.core import engine

    call = _consensus_call("lasso_wide")
    chunked = call(device=dev, dtype=dtype, trace_len=64)
    assert engine._CHUNK > 1
    monkeypatch.setattr(engine, "_CHUNK", 1)
    single = call(device=dev, dtype=dtype, trace_len=64)
    for f in ("coef", "beta0", "niter"):
        assert torch.equal(getattr(chunked, f), getattr(single, f)), f
    assert torch.equal(torch.nan_to_num(chunked.trace, nan=-1.0),
                       torch.nan_to_num(single.trace, nan=-1.0))


@pytest.mark.parametrize("driver", ["lasso_tall", "lasso_wide", "group",
                                    "logistic", "multinomial"])
def test_consensus_graph_equals_the_eager_loop_on_the_card(dev, driver,
                                                           monkeypatch):
    """The host loop's group as a CUDA graph runs the op-by-op loop's
    kernels in its order: the same coefficients, niter and trace rows to
    the bit as with the route forced to the op-by-op loop (the group
    prox's segment sums are a product, not atomics), in float32."""
    from admm_tpu_torch.core import engine

    call = _consensus_call(driver)
    kw = dict(device=dev, dtype=torch.float32, trace_len=32)
    graphed = call(**kw)
    monkeypatch.setattr(engine, "_route", lambda *a: "eager")
    eager = call(**kw)
    for f in ("coef", "beta0", "niter"):
        assert torch.equal(getattr(graphed, f), getattr(eager, f)), f
    if graphed.trace is not None:     # the multinomial result has none
        assert torch.equal(torch.nan_to_num(graphed.trace, nan=-1.0),
                           torch.nan_to_num(eager.trace, nan=-1.0))


@pytest.mark.parametrize("regime", ["wide_scan", "tall_factors",
                                    "wide_traced", "tall_batch_factors",
                                    "wide_batch_traced"])
def test_engine_graph_equals_the_eager_loop_on_the_card(dev, regime,
                                                        monkeypatch):
    """The engine's host loop as CUDA graphs runs the op-by-op loop's
    kernels in its order, for a single solve, a traced one, batched lanes
    and traced lanes: ``lasso_path`` on the wide scan path (200 x 400,
    sent to the engine: the wide scan kernel would take it), the tall
    path with penalty factors, the wide path traced, the tall batch path
    with factors and the wide batch path traced give the same beta, niter,
    lambda and trace rows to the bit as with the route forced to the
    op-by-op loop.  Every device iteration of the graphed run is a
    graphed one, none of the eager run's; the second shape's call
    captures anew."""
    import admm_tpu_torch as t
    from admm_tpu_torch.core import engine
    from admm_tpu_torch.diag import profile
    from admm_tpu_torch.models import lasso

    tall = regime.startswith("tall")
    batch = "batch" in regime
    shapes = [(300, 40), (260, 30)] if tall else [(200, 400), (150, 320)]
    monkeypatch.setattr(lasso, "_use_kernel_wide_scan", lambda *a: False)

    def call(n, p):
        rng = np.random.default_rng(n + p)
        X = rng.normal(size=(n, p))
        y = X[:, :8] @ rng.uniform(-1, 1, 8) + 0.5 * rng.normal(size=n)
        kw = dict(nlambda=20, device=dev, dtype=torch.float32,
                  path_mode="batch" if batch else "scan")
        if "factors" in regime:
            kw["penalty_factor"] = np.linspace(0.2, 2.0, p)
        if "traced" in regime:
            kw["trace_len"] = 40
        with profile.record() as rec:
            res = t.lasso_path(X, y, **kw)
        assert res.coef.device.type == "cuda"
        assert (res.trace is not None) == ("traced" in regime)
        return res, rec

    graphed = [call(*s) for s in shapes]
    monkeypatch.setattr(engine, "_route", lambda *a: "eager")
    eager = [call(*s) for s in shapes]
    for (g, g_rec), (e, e_rec) in zip(graphed, eager):
        for f in ("coef", "beta0", "niter", "lambdas"):
            assert torch.equal(getattr(g, f), getattr(e, f)), f
        if g.trace is not None:
            assert torch.equal(torch.nan_to_num(g.trace, nan=-1.0),
                               torch.nan_to_num(e.trace, nan=-1.0))
        # A batched step moves every lane: the loop's iterations are the
        # slowest lane's.
        steps = int(g.niter.max() if batch else g.niter.sum())
        iters = g_rec.total("engine.iterations")
        assert iters >= steps > 0
        assert g_rec.total("engine.graphed_iterations") == iters
        assert e_rec.total("engine.iterations") == steps
        assert e_rec.total("engine.graphed_iterations") == 0


# ---------------------------------------------------------------------------
# Checkpointed drivers and the profiler on the card
# ---------------------------------------------------------------------------

def _resume_bits(driver, tmp_path, *args, **kw):
    """A run stopped after one chunk and resumed against the uninterrupted
    run on the card: the same coef, beta0 and niter to the bit, and no
    kernel launch (the drivers run the engines)."""
    import os

    kernels.reset_launch_counts()
    ck = str(tmp_path / "crash.npz")
    assert driver(*args, checkpoint=ck, _stop_after_chunks=1, **kw) is None
    res = driver(*args, checkpoint=ck, **kw)
    assert not os.path.exists(ck)
    full = driver(*args, checkpoint=str(tmp_path / "whole.npz"), **kw)
    for f in ("coef", "beta0", "niter"):
        assert torch.equal(getattr(res, f), getattr(full, f)), f
    assert res.coef.is_cuda
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("shape", [(200, 40), (60, 150)])
def test_checkpointed_lasso_resumes_to_the_bit_on_the_card(dev, tmp_path,
                                                           shape):
    from admm_tpu_torch.diag import checkpointed_lasso_path

    rng = np.random.default_rng(5)
    X = rng.normal(size=shape)
    y = X[:, :6] @ rng.normal(size=6) + 0.3 * rng.normal(size=shape[0])
    _resume_bits(checkpointed_lasso_path, tmp_path, X, y,
                 lambdas=np.geomspace(0.5, 0.01, 8), chunk_size=3,
                 device=dev)


def test_checkpointed_consensus_resumes_to_the_bit_on_the_card(dev,
                                                               tmp_path):
    """Each chunk captures its CUDA graph anew, the resumed run's too."""
    from admm_tpu_torch.diag import checkpointed_parallel_lasso_path

    rng = np.random.default_rng(6)
    X = rng.normal(size=(203, 24))
    y = X[:, :5] @ rng.normal(size=5) + 0.5 * rng.normal(size=203)
    _resume_bits(checkpointed_parallel_lasso_path, tmp_path, X, y,
                 lambdas=np.geomspace(0.5, 0.01, 8), chunk_size=3,
                 nworkers=2, device=dev)


def test_profiler_trace_holds_the_path_kernels(dev, tmp_path):
    """``diag.profile.trace`` sees the hand-written kernels (launched through
    ctypes): the scan path's and the builder's batch fit's, inside the
    ``annotate`` region."""
    import json
    import os

    import admm_tpu_torch as t
    from admm_tpu_torch.diag import annotate
    from admm_tpu_torch.diag.profile import trace

    rng = np.random.default_rng(7)
    X = rng.normal(size=(300, 40))
    y = X[:, :5] @ rng.normal(size=5) + 0.3 * rng.normal(size=300)
    kernels.reset_launch_counts()
    with trace(str(tmp_path), device=dev):
        with annotate("small-path"):
            t.lasso_path(X, y, nlambda=10, device=dev)
            t.admm_lasso(X, y, device=dev).fit()
    assert kernels.launch_counts()["tall_path_scan"] == 1
    assert kernels.launch_counts()["tall_path_batch"] == 1
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert "small-path" in names
    for kernel in ("tall_path_scan_kernel", "tall_path_batch_kernel"):
        assert any(kernel in n and e.get("cat") == "kernel"
                   for n, e in zip(names, events)), kernel


# ---------------------------------------------------------------------------
# Meshes on the card (admm_tpu_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------

def _mesh_problem(n=400, p=30, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.3)
    return X, (1.0 + X @ b + 0.5 * rng.normal(size=n)).astype(np.float32)


def test_four_position_mesh_on_the_card(dev):
    """A one-process mesh of 4 positions on the card: the consensus path
    (W = 8, two workers a position) and the CV (8 folds) equal their runs
    without a mesh to the bit; ``data_mesh`` and ``fold_mesh`` launch the
    tall kernels as often as the runs without a mesh do."""
    import admm_tpu_torch as t
    from admm_tpu_torch.parallel.mesh import make_mesh

    X, y = _mesh_problem()
    mesh = make_mesh(4, devices=[dev] * 4)
    a = t.parallel_lasso_path(X, y, nworkers=8, nlambda=10)
    b = t.parallel_lasso_path(X, y, nworkers=8, nlambda=10, mesh=mesh)
    assert torch.equal(a.coef, b.coef) and torch.equal(a.niter, b.niter)
    counts = []
    for fm in (None, mesh):
        kernels.reset_launch_counts()
        cv = t.cv_lasso_path(X, y, nfolds=8, nlambda=10, fold_mesh=fm)
        counts.append(kernels.launch_counts())
        if fm is None:
            ref = cv
    assert np.array_equal(cv.cvm, ref.cvm)
    assert counts[0] == counts[1] and counts[1]["tall_path_batch"] == 9
    for mode, name in (("scan", "tall_path_scan"),
                       ("batch", "tall_path_batch")):
        kernels.reset_launch_counts()
        sh = t.lasso_path(X, y, nlambda=10, path_mode=mode, data_mesh=mesh)
        assert kernels.launch_counts()[name] == 1
        one = t.lasso_path(X, y, nlambda=10, path_mode=mode)
        assert (sh.coef - one.coef).abs().max().item() < 1e-5
        assert (sh.niter - one.niter).abs().max().item() <= 1


def test_nccl_group_of_one_rank_captures_the_gather(dev):
    """A NCCL group of one rank in this process: the consensus chunk with
    its all-gather is captured as a CUDA graph and equals the run without
    a mesh to the bit, as does the tall ``data_mesh`` path."""
    import socket

    import torch.distributed as dist

    import admm_tpu_torch as t
    from admm_tpu_torch.core import engine
    from admm_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(group=dist.group.WORLD)
        assert engine._route(dev, True, mesh) == "graph"
        X, y = _mesh_problem()
        a = t.parallel_lasso_path(X, y, nworkers=4, nlambda=10)
        b = t.parallel_lasso_path(X, y, nworkers=4, nlambda=10, mesh=mesh)
        assert torch.equal(a.coef, b.coef) and torch.equal(a.niter, b.niter)
        a = t.lasso_path(X, y, nlambda=10)
        b = t.lasso_path(X, y, nlambda=10, data_mesh=mesh)
        assert torch.equal(a.coef, b.coef) and torch.equal(a.niter, b.niter)
    finally:
        dist.destroy_process_group()
