"""The port's robust PCA, PCP path, entry-holdout CV and matrix completion
(``admm_tpu_torch.models.rpca``) against the JAX package's, on the same
seeded numpy inputs and ``device="cpu"``.

The partial SVT starts from the QR of a normal draw: the JAX package's
from ``PRNGKey(0)``, the port's from a CPU ``torch.Generator`` seeded 0.
The bases differ, so only the low-rank and sparse parts are compared
(unique once the subspace has converged), never the basis or the bits.

Bars: float64 low-rank and sparse parts within 1e-6 and ``niter`` within
1 (exact SVT, masked, matrix completion, the path); the partial SVT's
parts within 1e-6 with ``niter`` free (another start basis); float32
against the JAX package's float64 run within the larger of 2e-4 and the
JAX package's own float32 gap to its float64 run on the same input
(measured in the test), the convention of the port's earlier parity
tests.  CV: cvm rtol 1e-6 in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.models import rpca as jrpca
from admm_tpu_torch.interop import from_reference
from admm_tpu_torch.models import rpca

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def planted():
    rng = np.random.default_rng(1)
    m, n, r = 30, 24, 2
    L0 = rng.normal(size=(m, r)) @ rng.normal(size=(r, n))
    S0 = np.zeros((m, n))
    idx = rng.random((m, n)) < 0.05
    S0[idx] = rng.normal(scale=5.0, size=idx.sum())
    return L0 + S0, L0, rng.random((m, n)) > 0.2


def _parts(got, ref, atol=1e-6, niter=True):
    np.testing.assert_allclose(got.low_rank.numpy(),
                               np.asarray(ref.low_rank), atol=atol)
    np.testing.assert_allclose(got.sparse.numpy(), np.asarray(ref.sparse),
                               atol=atol)
    if niter:
        assert np.all(np.abs(got.niter.numpy().astype(int)
                             - np.asarray(ref.niter)) <= 1)


@pytest.mark.parametrize("case", ["exact", "masked", "lam", "rho"])
def test_rpca_matches_jax_f64(planted, case):
    M, _, obs = planted
    kw = {"exact": {}, "masked": {"observed": obs}, "lam": {"lam": 0.3},
          "rho": {"rho": 0.5}}[case]
    got = admm_tpu_torch.rpca(M, **kw, **F64)
    ref = admm_tpu.rpca(M, dtype=jnp.float64, **kw)
    _parts(got, ref)
    assert got.rank_saturated is None and ref.rank_saturated is None
    assert float(got.lam) == pytest.approx(float(ref.lam), rel=1e-15)


@pytest.mark.parametrize("observed", [False, True])
def test_rpca_partial_svt_matches_jax_low_rank_and_sparse(planted, observed):
    M, _, obs = planted
    kw = {"rank": 3, "observed": obs if observed else None}
    got = admm_tpu_torch.rpca(M, **kw, **F64)
    ref = admm_tpu.rpca(M, dtype=jnp.float64, **kw)
    _parts(got, ref, niter=False)
    assert bool(got.rank_saturated) == bool(ref.rank_saturated)


def test_rpca_f32_at_the_jax_float32_gap(planted):
    M = planted[0]
    got = admm_tpu_torch.rpca(M, dtype=torch.float32, device="cpu")
    r64 = admm_tpu.rpca(M, dtype=jnp.float64)
    r32 = admm_tpu.rpca(M, dtype=jnp.float32)
    for f in ("low_rank", "sparse"):
        ref64 = np.asarray(getattr(r64, f))
        bar = max(2e-4, np.abs(np.asarray(getattr(r32, f)) - ref64).max())
        assert np.abs(getattr(got, f).numpy() - ref64).max() <= bar, f


def test_rpca_traced_matches_jax(planted):
    M = planted[0]
    got = admm_tpu_torch.rpca(M, trace_len=32, maxit=40, **F64)
    ref = admm_tpu.rpca(M, trace_len=32, maxit=40, dtype=jnp.float64)
    _parts(got, ref)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(ref.trace),
                               rtol=1e-8)


def test_svt_partial_equals_svt_on_its_converged_subspace():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(20, 3)) @ rng.normal(size=(3, 15))
    A += 1e-3 * rng.normal(size=A.shape)
    V0 = rpca._start_basis(15, 6, torch.float64, "cpu")
    L, V = rpca.svt_partial(torch.as_tensor(A), 0.5, V0, power_iters=6)
    ref = rpca.svt(torch.as_tensor(A), 0.5)
    np.testing.assert_allclose(L.numpy(), ref.numpy(), atol=1e-10)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jrpca.svt(A, 0.5)),
                               atol=1e-12)
    np.testing.assert_allclose(V.mT @ V, np.eye(6), atol=1e-12)


@pytest.mark.parametrize("rank", [None, 3])
def test_rpca_path_matches_jax(planted, rank):
    """The default 4-point grid; with ``rank=3`` its lower three points:
    at the top one L has rank 14, past the 3 + 8 directions of the partial
    basis, where the truncated decomposition depends on the basis (the
    JAX package's ``rank_saturated`` case) and is not unique."""
    M = planted[0]
    kw = ({"nlambda": 4} if rank is None
          else {"lambdas": np.geomspace(3.0, 1 / 3.0, 4)[1:] / np.sqrt(30)})
    got = admm_tpu_torch.rpca_path(M, rank=rank, **kw, **F64)
    ref = admm_tpu.rpca_path(M, rank=rank, dtype=jnp.float64, **kw)
    _parts(got, ref, niter=rank is None)
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(ref.lambdas),
                               rtol=1e-15)
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(ref.rank))
    np.testing.assert_array_equal(got.nnz.numpy(), np.asarray(ref.nnz))


@pytest.mark.parametrize("score", ["mae", "mse"])
def test_cv_rpca_matches_jax(planted, score):
    M, _, obs = planted
    kw = dict(nlambda=4, nfolds=3, score=score, observed=obs)
    got = admm_tpu_torch.cv_rpca(M, **kw, **F64)
    ref = admm_tpu.cv_rpca(M, dtype=jnp.float64, **kw)
    np.testing.assert_array_equal(got.foldid, ref.foldid)
    np.testing.assert_allclose(got.cvm, ref.cvm, rtol=1e-6)
    np.testing.assert_allclose(got.cvsd, ref.cvsd, rtol=1e-6)
    assert got.lambda_min == pytest.approx(ref.lambda_min, rel=1e-15)
    assert got.lambda_1se == pytest.approx(ref.lambda_1se, rel=1e-15)
    _parts(got.fit, ref.fit)


@pytest.mark.parametrize("case", ["mask", "nonzero", "trace", "f32"])
def test_matrix_complete_matches_jax(planted, case):
    _, L0, obs = planted
    if case == "f32":
        got, _ = admm_tpu_torch.matrix_complete(L0, obs, dtype=torch.float32,
                                                device="cpu")
        r64 = np.asarray(admm_tpu.matrix_complete(L0, obs,
                                                  dtype=jnp.float64)[0])
        r32 = np.asarray(admm_tpu.matrix_complete(L0, obs,
                                                  dtype=jnp.float32)[0])
        bar = max(2e-4, np.abs(r32 - r64).max())
        assert np.abs(got.numpy() - r64).max() <= bar
        return
    M = L0 * obs
    args = {"mask": (L0, obs), "nonzero": (M,), "trace": (L0, obs)}[case]
    kw = {"trace_len": 16, "maxit": 20} if case == "trace" else {}
    got = admm_tpu_torch.matrix_complete(*args, **kw, **F64)
    ref = admm_tpu.matrix_complete(*args, dtype=jnp.float64, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    assert abs(int(got[1]) - int(ref[1])) <= 1
    if case == "trace":
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=1e-8)


def test_rpca_results_convert_from_jax(planted):
    M = planted[0]
    ref = admm_tpu.rpca_path(M, nlambda=2, dtype=jnp.float64)
    port = from_reference(ref)
    assert isinstance(port, rpca.RPCAPathResult)
    np.testing.assert_array_equal(port.low_rank.numpy(),
                                  np.asarray(ref.low_rank))
    single = from_reference(admm_tpu.rpca(M, maxit=3, dtype=jnp.float64))
    assert isinstance(single, rpca.RPCAResult) and single.trace is None


@pytest.mark.parametrize("call", [
    lambda M: admm_tpu_torch.rpca(M[0], device="cpu"),
    lambda M: admm_tpu_torch.rpca(M, observed=np.ones((2, 2), bool),
                                  device="cpu"),
    lambda M: admm_tpu_torch.cv_rpca(M, score="l1", device="cpu"),
    lambda M: admm_tpu_torch.cv_rpca(M, nfolds=1, device="cpu"),
    lambda M: admm_tpu_torch.matrix_complete(M, np.ones(3, bool),
                                             device="cpu")])
def test_rpca_errors(planted, call):
    with pytest.raises(ValueError):
        call(planted[0])
