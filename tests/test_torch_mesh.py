"""The port's ``data_mesh`` (``admm_tpu_torch.parallel.mesh``, rows of X
sharded over a mesh; columns of A for Basis Pursuit) against the JAX
package's, on the same seeded numpy inputs: the port on an 8-position
CPU mesh, the JAX package on the 8 CPU devices of ``tests/conftest.py``.

Bars, the JAX package's own for its sharded runs
(``tests/test_sharded_linalg.py``): each result within atol 1e-4 of the
JAX package's sharded run and of the port's run without a mesh, niter
within 3.  The paths run in float32 (the port's default, the tall kernels'
plain forms on the CPU); LAD, the quantile fit, BP, the GLM and the
graphical lasso in float64 on both sides (``tests/conftest.py`` turns x64
on), where the float32 bars of ``PERF.md`` section 2 would be looser.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch as t
from admm_tpu.parallel.mesh import make_mesh as jax_mesh
from admm_tpu_torch.parallel.mesh import Sharded, make_mesh

torch.set_num_threads(1)

BAR, NITER = 1e-4, 3
F64 = dict(dtype=torch.float64)


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh(8), make_mesh(8, devices=["cpu"] * 8)


def _problem(n, p, seed, k=4):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[:k] = [1.5, -1.0, 0.5, 2.0][:k]
    X = rng.normal(size=(n, p)).astype(np.float32)
    return X, (1.0 + X @ b + 0.5 * rng.normal(size=n)).astype(np.float32)


TALL = _problem(256, 12, 11)
WIDE = _problem(64, 96, 3)


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def _close(got, ref, fields, niter=True):
    for f in fields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(ref, f)), atol=BAR,
                                   err_msg=f)
    if niter:
        gap = np.abs(_np(got.niter) - _np(ref.niter))
        assert gap.max() <= NITER, f"niter gap {gap.max()}"


def _binary(n=256, p=10, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    eta = 0.2 + 1.5 * X[:, 0] - X[:, 1]
    return X, (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(float)


def _classes(n=240, p=8, C=3, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    return X, np.argmax(X[:, :C] + rng.normal(size=(n, C)), axis=1)


def _tasks(n=240, p=10, K=3, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    B = np.zeros((p, K))
    B[:3] = rng.normal(size=(3, K))
    return X, X @ B + 0.3 * rng.normal(size=(n, K))


def _lad(n=256, p=8, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(scale=2.0, size=(n, p))
    return X, X @ rng.uniform(size=p) + rng.standard_t(3, size=n)


def _bp(n=32, p=128, seed=6):
    rng = np.random.default_rng(seed)
    x0 = np.zeros(p)
    x0[rng.choice(p, 5, replace=False)] = rng.normal(size=5)
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    return A, A @ x0


# name -> (call(package, mesh, **extra), result fields, niter compared)
CASES = {
    "lasso_tall_scan": (lambda m, mesh, **kw: m.lasso_path(
        *TALL, nlambda=5, rho=20.0, data_mesh=mesh, **kw),
        ("coef", "beta0"), True),
    "lasso_tall_batch": (lambda m, mesh, **kw: m.lasso_path(
        *TALL, nlambda=5, rho=20.0, path_mode="batch", data_mesh=mesh,
        **kw), ("coef", "beta0"), True),
    "lasso_wide_batch": (lambda m, mesh, **kw: m.lasso_path(
        *WIDE, nlambda=5, path_mode="batch", data_mesh=mesh, **kw),
        ("coef", "beta0"), False),
    "dantzig": (lambda m, mesh, **kw: m.dantzig_path(
        *TALL, lambdas=np.array([0.3, 0.1]), data_mesh=mesh, **kw),
        ("coef", "beta0"), False),
    "lad": (lambda m, mesh, **kw: m.lad_fit(
        *_lad(), data_mesh=mesh, **kw), ("coef", "beta0"), True),
    "quantile": (lambda m, mesh, **kw: m.quantile_fit(
        *_lad(), tau=0.3, data_mesh=mesh, **kw), ("coef", "beta0"), True),
    "bp": (lambda m, mesh, **kw: m.bp_fit(
        *_bp(), data_mesh=mesh, **kw), ("coef",), True),
    "logistic": (lambda m, mesh, **kw: m.logistic_lasso_path(
        *_binary(), lambdas=np.array([0.03, 0.01]), data_mesh=mesh, **kw),
        ("coef", "beta0"), True),
    "group": (lambda m, mesh, **kw: m.group_lasso_path(
        *TALL, np.arange(12) % 4, nlambda=5, data_mesh=mesh, **kw),
        ("coef", "beta0"), True),
    "genlasso": (lambda m, mesh, **kw: m.gen_lasso_path(
        *TALL, admm_tpu.difference_matrix(12, 1), nlambda=5,
        data_mesh=mesh, **kw), ("coef", "beta0"), True),
    "sqrt": (lambda m, mesh, **kw: m.sqrt_lasso_path(
        *TALL, nlambda=5, data_mesh=mesh, **kw), ("coef", "beta0"), False),
    "svm": (lambda m, mesh, **kw: m.svm_path(
        _binary()[0], _binary()[1], nC=4, data_mesh=mesh, **kw),
        ("coef", "intercept"), False),
    "multinomial": (lambda m, mesh, **kw: m.multinomial_lasso_path(
        *_classes(), nlambda=4, data_mesh=mesh, **kw),
        ("coef", "beta0"), False),
    "multitask": (lambda m, mesh, **kw: m.multitask_lasso_path(
        *_tasks(), nlambda=4, data_mesh=mesh, **kw), ("coef", "beta0"),
        False),
    "glasso": (lambda m, mesh, **kw: m.glasso_path(
        _tasks()[0], nlambda=3, data_mesh=mesh, **kw), ("precision",),
        True),
}
# Families run in float64 on both sides (module docstring).
DOUBLE = {"lad", "quantile", "bp", "logistic", "glasso", "genlasso"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_mesh_matches_jax_and_no_mesh(meshes, case):
    call, fields, niter = CASES[case]
    jmesh, tmesh = meshes
    kw = dict(F64) if case in DOUBLE else {}
    ref = call(admm_tpu, jmesh,
               **(dict(dtype=jnp.float64) if case in DOUBLE else {}))
    got = call(t, tmesh, device="cpu", **kw)
    plain = call(t, None, device="cpu", **kw)
    _close(got, ref, fields, niter)
    _close(got, plain, fields, niter)


@pytest.mark.parametrize("driver", ["enet", "adaptive", "relaxed",
                                    "glmnet", "wide_scan", "activeset"])
def test_data_mesh_drivers_on_lasso_path(meshes, driver):
    """The drivers built on ``lasso_path`` forward ``data_mesh`` to it;
    each equals its run without a mesh within the bars."""
    _, tmesh = meshes
    calls = {
        "enet": lambda **kw: t.enet_path(*TALL, alpha=0.6, nlambda=5,
                                         **kw),
        "adaptive": lambda **kw: t.adaptive_lasso_path(*TALL, nlambda=5,
                                                       **kw),
        "relaxed": lambda **kw: t.relaxed_lasso_path(*TALL, nlambda=5,
                                                     **kw),
        "glmnet": lambda **kw: t.glmnet(*TALL, nlambda=5, **kw),
        "wide_scan": lambda **kw: t.lasso_path(*WIDE, nlambda=5, **kw),
        "activeset": lambda **kw: t.lasso_path(
            *WIDE, nlambda=5, path_mode="activeset", **kw),
    }
    got = calls[driver](data_mesh=tmesh, device="cpu")
    plain = calls[driver](device="cpu")
    fields = ("coef",) if driver == "relaxed" else ("coef", "beta0")
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(plain, f).numpy(), atol=BAR,
                                   err_msg=f)


def test_one_position_mesh_is_the_unsharded_bits():
    """A mesh of one position sums one block: the tall path's moments,
    Gram and X'y, and so its result, are the bits of the run without a
    mesh (the NCCL group of one rank on the card relies on it)."""
    one = make_mesh(1, devices=["cpu"])
    for mode in ("scan", "batch"):
        a = t.lasso_path(*TALL, nlambda=5, path_mode=mode, device="cpu")
        b = t.lasso_path(*TALL, nlambda=5, path_mode=mode, data_mesh=one,
                         device="cpu")
        assert torch.equal(a.coef, b.coef) and torch.equal(a.niter, b.niter)


def test_each_position_holds_its_rows_only(meshes, monkeypatch):
    """The blocks that reach the solver: n split as ``tensor_split``
    splits it (no padding), never the whole of X on one position; the
    tall path keeps its kernel (its plain form here) on the mesh."""
    from admm_tpu_torch.kernels import tall_path
    from admm_tpu_torch.models import lasso

    _, tmesh = meshes
    seen, launches = [], []
    real_setup, real_batch = lasso._tall_setup, tall_path.tall_path_batch

    def spy_setup(Xs, *a):
        seen.append(Xs)
        return real_setup(Xs, *a)

    def spy_batch(*a, **kw):
        launches.append(1)
        return real_batch(*a, **kw)

    monkeypatch.setattr(lasso, "_tall_setup", spy_setup)
    monkeypatch.setattr(tall_path, "tall_path_batch", spy_batch)
    X, y = _problem(203, 12, 2)
    t.lasso_path(X, y, nlambda=4, path_mode="batch", data_mesh=tmesh,
                 device="cpu")
    (Xs,) = seen
    assert isinstance(Xs, Sharded)
    assert [b.shape for b in Xs.blocks] == [
        torch.Size((len(r), 12)) for r in np.array_split(np.arange(203), 8)]
    assert launches == [1]


def test_specs_place_blocks_and_replicas(meshes):
    """``row_sharding``/``replicated`` are the specs ``put`` takes: rows
    split as ``tensor_split`` splits them, each block on its position,
    or the whole array on the home device."""
    from admm_tpu_torch.parallel.mesh import put, replicated, row_sharding

    _, tmesh = meshes
    X = np.arange(30.0).reshape(10, 3)
    sh = put(X, row_sharding(tmesh), torch.float64)
    parts = torch.tensor_split(torch.as_tensor(X), 8)
    assert len(sh.blocks) == 8 and sh.shape == (10, 3)
    for b, ref in zip(sh.blocks, parts):
        assert torch.equal(b, ref)
    rep = put(X, replicated(tmesh))
    assert torch.equal(rep, torch.as_tensor(X)) and rep.device == tmesh.home
    # The products: X'v sums over the mesh, X b is gathered.
    v, b = np.arange(10.0), np.array([1.0, -2.0, 0.5])
    assert np.allclose((sh.mT @ torch.as_tensor(v)).numpy(), X.T @ v)
    assert np.allclose((sh @ torch.as_tensor(b)).numpy(), X @ b)
