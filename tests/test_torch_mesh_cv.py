"""The port's ``fold_mesh`` (CV folds dealt over a mesh) and consensus
``mesh=`` (workers dealt over a mesh) against the port without a mesh and
against the JAX package on the 8 CPU devices of ``tests/conftest.py``, on
the same seeded numpy inputs; the port on an 8-position CPU mesh.

Bars.  ``fold_mesh``: the port's results equal its CV without a mesh to
the bit (folds are independent), and are within ``tests/test_cv.py``'s
bars of the JAX package's ``fold_mesh`` CV (cvm rtol 1e-4, the same
``lambda_min``).  Consensus: the same W without a mesh to the bit (the
positions of one process on one device run their workers as one batch).
Against the JAX package's consensus on a mesh of the same D, float64:
atol 1e-5 and niter identical (``tests/test_consensus.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch as t
from admm_tpu.parallel.mesh import make_mesh as jax_mesh
from admm_tpu_torch.parallel.consensus import _resolve_mesh
from admm_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(8), make_mesh(8, devices=["cpu"] * 8)


def _data(n=160, p=10, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:3] = [1.5, -1.0, 0.7]
    eta = X @ b
    return dict(
        X=X, y=eta + 0.5 * rng.normal(size=n),
        yb=(rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(float),
        yc=np.argmax(X[:, :3] + rng.normal(size=(n, 3)), axis=1),
        Y=np.stack([eta, X[:, 3] - X[:, 4]], 1)
        + 0.3 * rng.normal(size=(n, 2)),
        time=rng.exponential(np.exp(-0.5 * eta)),
        event=(rng.uniform(size=n) < 0.7).astype(float))


D = _data()
CV = dict(nfolds=8, seed=3)

# name -> call(package, fold_mesh, **extra) -> a result with cvm
CV_CASES = {
    "lasso": lambda m, fm, **kw: m.cv_lasso_path(
        D["X"], D["y"], nlambda=6, cv_mode="onepass", fold_mesh=fm, **CV,
        **kw),
    "logistic": lambda m, fm, **kw: m.cv_logistic_path(
        D["X"], D["yb"], nlambda=6, cv_mode="onepass", fold_mesh=fm, **CV,
        **kw),
    "multitask": lambda m, fm, **kw: m.cv_multitask_lasso_path(
        D["X"], D["Y"], nlambda=5, fold_mesh=fm, **CV, **kw),
    "multinomial": lambda m, fm, **kw: m.cv_multinomial_path(
        D["X"], D["yc"], nlambda=5, fold_mesh=fm, **CV, **kw),
    "cox": lambda m, fm, **kw: m.cv_cox_path(
        D["X"], D["time"], D["event"], nlambda=5, fold_mesh=fm, **CV,
        **kw),
    "glasso": lambda m, fm, **kw: m.cv_glasso_path(
        D["X"], nlambda=4, fold_mesh=fm, **CV, **kw),
    "svm": lambda m, fm, **kw: m.cv_svm_path(
        D["X"], D["yb"], nC=5, fold_mesh=fm, **CV, **kw),
}


def _lam_min(res):
    return getattr(res, "lambda_min", getattr(res, "C_min", None))


@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_fold_mesh_matches_no_mesh_and_jax(meshes, case):
    jmesh, tmesh = meshes
    call = CV_CASES[case]
    got = call(t, tmesh, device="cpu")
    plain = call(t, None, device="cpu")
    np.testing.assert_array_equal(got.cvm, plain.cvm)
    np.testing.assert_array_equal(got.cvsd, plain.cvsd)
    assert _lam_min(got) == _lam_min(plain)
    ref = call(admm_tpu, jmesh)
    np.testing.assert_allclose(got.cvm, np.asarray(ref.cvm), rtol=1e-4)
    grid = getattr(got, "lambdas", getattr(got, "Cs", None))
    rgrid = np.asarray(getattr(ref, "lambdas", getattr(ref, "Cs", None)))
    assert (int(np.argmin(np.abs(grid - _lam_min(got))))
            == int(np.argmin(np.abs(rgrid - _lam_min(ref)))))


@pytest.mark.parametrize("driver", ["dantzig", "group", "relaxed",
                                    "cv_glmnet"])
def test_fold_mesh_drivers_match_no_mesh(meshes, driver):
    """Every other driver that deals folds: its CV on the mesh is its CV
    without one, to the bit."""
    _, tmesh = meshes
    X, y = D["X"], D["y"]
    calls = {
        "dantzig": lambda **kw: t.cv_dantzig_path(X, y, nlambda=5, **CV,
                                                  **kw),
        "group": lambda **kw: t.cv_group_lasso_path(
            X, y, np.arange(10) % 5, nlambda=5, **CV, **kw),
        "relaxed": lambda **kw: t.cv_relaxed_lasso_path(
            X, y, nlambda=5, **CV, **kw),
        "cv_glmnet": lambda **kw: t.cv_glmnet(X, y, nlambda=5, **CV, **kw),
    }
    got = calls[driver](fold_mesh=tmesh, device="cpu")
    plain = calls[driver](device="cpu")
    cvm = (lambda r: r["cvm"]) if driver == "relaxed" else (
        lambda r: r.cvm)
    np.testing.assert_array_equal(cvm(got), cvm(plain))


def test_fold_mesh_needs_a_multiple_of_its_size(meshes):
    jmesh, tmesh = meshes
    with pytest.raises(ValueError):
        admm_tpu.cv_lasso_path(D["X"], D["y"], nfolds=6, nlambda=4,
                               cv_mode="onepass", fold_mesh=jmesh)
    with pytest.raises(ValueError, match="multiple of the fold_mesh"):
        t.cv_lasso_path(D["X"], D["y"], nfolds=6, nlambda=4,
                        fold_mesh=tmesh, device="cpu")


F64 = dict(dtype=torch.float64, device="cpu")
JF64 = dict(dtype=jnp.float64)

# name -> call(package, mesh, **extra)
CONSENSUS = {
    "lasso": lambda m, mesh, **kw: m.parallel_lasso_path(
        D["X"], D["y"], nworkers=16, mesh=mesh, nlambda=5, **kw),
    "bp": lambda m, mesh, **kw: m.parallel_bp_fit(
        *_bp(), nworkers=16, mesh=mesh, **kw),
    "multitask": lambda m, mesh, **kw: m.parallel_multitask_lasso_path(
        D["X"], D["Y"], nworkers=16, mesh=mesh, nlambda=4, **kw),
    "logistic": lambda m, mesh, **kw: m.parallel_logistic_lasso_path(
        D["X"], D["yb"], nworkers=16, mesh=mesh, nlambda=4, **kw),
    "multinomial": lambda m, mesh, **kw: m.parallel_multinomial_lasso_path(
        D["X"], D["yc"], nworkers=16, mesh=mesh, nlambda=4, **kw),
}


def _bp(n=48, p=160, seed=6):
    rng = np.random.default_rng(seed)
    x0 = np.zeros(p)
    x0[rng.choice(p, 6, replace=False)] = rng.normal(size=6)
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    return A, A @ x0


@pytest.mark.parametrize("case", sorted(CONSENSUS))
def test_consensus_mesh_matches_no_mesh_and_jax(meshes, case):
    jmesh, tmesh = meshes
    call = CONSENSUS[case]
    got = call(t, tmesh, **F64)
    plain = call(t, None, **F64)
    assert torch.equal(got.coef, plain.coef)
    assert torch.equal(got.niter, plain.niter)
    ref = call(admm_tpu, jmesh, **JF64)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=1e-5)
    np.testing.assert_array_equal(np.atleast_1d(got.niter.numpy()),
                                  np.atleast_1d(np.asarray(ref.niter)))


def test_consensus_float32_mesh_bits(meshes):
    """The float32 Lasso (the card's dtype) on 8 positions gives the
    no-mesh bits."""
    _, tmesh = meshes
    kw = dict(nworkers=16, nlambda=5, device="cpu")
    a = t.parallel_lasso_path(D["X"], D["y"], **kw)
    b = t.parallel_lasso_path(D["X"], D["y"], mesh=tmesh, **kw)
    assert torch.equal(a.coef, b.coef) and torch.equal(a.niter, b.niter)


def test_consensus_mesh_rules(meshes):
    """W defaults to the mesh size; without a mesh the auto mesh is the
    largest device count dividing W (one device: no mesh); W not a
    multiple of an explicit mesh's size raises the JAX package's
    ValueError."""
    jmesh, tmesh = meshes
    assert _resolve_mesh(None, tmesh) == (8, tmesh)
    assert _resolve_mesh(None, None, "cpu") == (1, None)
    assert _resolve_mesh(6, None, "cpu") == (6, None)
    with pytest.raises(ValueError) as ref:
        admm_tpu.parallel_lasso_path(D["X"], D["y"], nworkers=12,
                                     mesh=jmesh, nlambda=3)
    with pytest.raises(ValueError) as got:
        t.parallel_lasso_path(D["X"], D["y"], nworkers=12, mesh=tmesh,
                              nlambda=3, device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("devices, batches", [
    (["cpu"] * 4, [8]),
    (["cpu", "cpu", "cpu:0", "cpu:0"], [4, 4]),
    (["cpu", "cpu:0", "cpu", "cpu:0"], [2, 2, 2, 2]),
])
def test_consensus_mesh_batches_a_device_once(devices, batches):
    """The positions of one process on one device build and run their
    workers as one batch; positions on other devices (here ``cpu:0``,
    which ``torch.device`` tells apart from ``cpu``) as batches of their
    own.  The gathered x rows come back in worker order."""
    from admm_tpu_torch.parallel.consensus import _mesh_x_update

    seen = []

    def make(Xb, yb, rho):
        seen.append(Xb.shape[0])
        return lambda z, y, rho_, x_prev: x_prev + z

    W = 8
    upd = _mesh_x_update(make, torch.zeros(W, 3, 2), torch.zeros(W, 3),
                         torch.tensor(1.0), W, make_mesh(4, devices=devices))
    x = torch.arange(2.0 * W).reshape(W, 2)
    out = upd(torch.ones(2), torch.zeros(W, 2), torch.tensor(1.0), x)
    assert seen == batches
    assert torch.equal(out, x + 1)


def test_consensus_route_of_a_two_device_mesh():
    """A CUDA graph captures one device's work: a one-process mesh over
    two devices runs op by op, one over a single device (or no mesh) as a
    graph; a hook that reads the host, or the CPU, never captures."""
    from admm_tpu_torch.core.engine import _route

    two = make_mesh(2, devices=["cuda:0", "cuda:1"])
    one = make_mesh(2, devices=["cuda:0"] * 2)
    assert not two.capturable and one.capturable
    assert _route("cuda:0", True, two) == "eager"
    assert _route("cuda:0", True, one) == "graph"
    assert _route("cuda:0", True, None) == "graph"
    assert _route("cuda:0", False, one) == "eager"
    assert _route("cpu", True, None) == "eager"
