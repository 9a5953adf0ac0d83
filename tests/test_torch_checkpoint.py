"""The port's checkpoint / resume container and its first six drivers
(``admm_tpu_torch.diag.checkpoint``: Lasso, Dantzig, group Lasso, GLM,
generalized Lasso and consensus Lasso) against the JAX package's, on the
same seeded numpy inputs, the port on ``device="cpu"``.

Each driver is held in float64 against the JAX package's driver (the
references run once per module) and the port's own one-shot scan path,
at the bar ``tests/test_checkpoint.py`` holds the JAX driver to against
its plain path (1e-5; 1e-3 for the wide Lasso, the Dantzig and the group
Lasso; 2e-3 for consensus), with ``niter`` within 1 per lambda; power
iteration starts from the JAX start vector (``jax_start_vector``).  In
float32, the default, a run stopped after one chunk and resumed equals
the uninterrupted run to the bit.  Every refusal of
``tests/test_checkpoint.py`` has a counterpart here, and a state saved by
either package loads in the other to the bit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu_torch as t
from admm_tpu.core.engine import ADMMState as JADMMState
from admm_tpu.core.engine import make_state as jmake_state
from admm_tpu.diag import checkpoint as jck
from admm_tpu.models.glm import binomial as jbinomial
from admm_tpu.models.glm import huber as jhuber
from admm_tpu.models.glm import poisson as jpoisson
from admm_tpu.parallel.mesh import make_mesh
from admm_tpu_torch.core.engine import ADMMState, make_state
from admm_tpu_torch import diag
from admm_tpu_torch.diag import checkpoint as tck
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.models.genlasso import difference_matrix
from admm_tpu_torch.models.glm import binomial, huber, poisson

from _torch_parity import assert_path_close, crash_and_resume
from _torch_parity import jax_start_vector  # noqa: F401  (a fixture)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
F32 = dict(dtype=torch.float32, device="cpu")
LAMS = np.geomspace(0.5, 0.005, 8)


def _problem(n=120, p=12, seed=7):
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.5)
    X = rng.normal(size=(n, p))
    return X, 1.5 + X @ b + 0.3 * rng.normal(size=n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's driver on the float64 problem, run once per
    module and key."""
    cache = {}

    def run(key, driver, *args, **kw):
        if key not in cache:
            ck = str(tmp_path_factory.mktemp("jax") / "ref.npz")
            cache[key] = driver(*args, checkpoint=ck, dtype=jnp.float64,
                                **kw)
        return cache[key]

    return run


def _leaves_equal(got, want):
    for f, a in zip(got._fields, got):
        b = getattr(want, f)
        if a is None:
            assert b is None, f
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------

def test_pytree_roundtrip(tmp_path):
    st = make_state(torch.arange(4.0), torch.ones(4), torch.zeros(4), 1.0,
                    0.1, aux=(torch.full((2, 3), 0.5), None))
    f = str(tmp_path / "st.npz")
    tck.save_pytree(f, st, tag=np.asarray(42))
    like = make_state(torch.zeros(4), torch.zeros(4), torch.zeros(4), 0.0,
                      0.0, aux=(torch.zeros((2, 3)), None))
    st2, extras = tck.load_pytree(f, like)
    assert int(extras["tag"]) == 42
    assert isinstance(st2, ADMMState) and st2.aux[1] is None
    np.testing.assert_array_equal(st2.aux[0].numpy(), st.aux[0].numpy())
    _leaves_equal(st2._replace(aux=None), st._replace(aux=None))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_pytree(f, st._replace(aux=None))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_jax_saved_state_loads_into_port(tmp_path, dtype):
    """A file the JAX package's ``save_pytree`` writes for its
    ``ADMMState`` (the same field order) loads into the port's to the bit,
    dtypes and the None leaf included."""
    rng = np.random.default_rng(3)
    jst = jmake_state(*(jnp.asarray(rng.normal(size=5), dtype)
                        for _ in range(3)), 1.7, 0.3)
    jst = jst._replace(it=jnp.asarray(17, jnp.int32),
                       done=jnp.asarray(True))
    f = str(tmp_path / "jax.npz")
    jck.save_pytree(f, jst, k_done=np.asarray(3))
    like = from_reference(jst)._replace(it=torch.zeros((), dtype=torch.int32))
    st, extras = tck.load_pytree(f, like)
    assert int(extras["k_done"]) == 3
    _leaves_equal(st, jst)


def test_port_saved_state_loads_into_jax(tmp_path):
    """And the reverse: the JAX ``load_pytree`` reads the port's file as
    ``interop.to_reference`` converts the same state."""
    rng = np.random.default_rng(4)
    st = make_state(*(torch.as_tensor(rng.normal(size=6)) for _ in range(3)),
                    2.5, 0.1, aux=torch.as_tensor(rng.normal(size=6)))
    f = str(tmp_path / "port.npz")
    tck.save_pytree(f, st)
    want = to_reference(st, JADMMState)
    got, _ = jck.load_pytree(f, want)
    assert isinstance(got, JADMMState)
    for f_, a in zip(got._fields, got):
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(getattr(want, f_)))


# ---------------------------------------------------------------------------
# 1. The Lasso
# ---------------------------------------------------------------------------

CASES = {"tall": ((120, 12), LAMS, 1e-5), "wide": ((30, 60),
                                                   np.geomspace(0.3, 0.01, 8),
                                                   1e-3)}


@pytest.mark.parametrize("case", ["tall", "wide"])
def test_lasso_matches_jax(case, jax_ref, tmp_path, jax_start_vector):
    (n, p), lams, bar = CASES[case]
    X, y = _problem(n, p)
    ref = jax_ref(("lasso", case), jck.checkpointed_lasso_path, X, y,
                  lambdas=lams, chunk_size=3)
    got = diag.checkpointed_lasso_path(X, y, lambdas=lams, chunk_size=3,
                                         checkpoint=str(tmp_path / "a.npz"),
                                         **F64)
    assert_path_close(got, ref, bar)
    plain = t.lasso_path(X, y, lambdas=lams, **F64)
    assert_path_close(got, plain, bar)


@pytest.mark.parametrize("case", ["tall", "wide"])
def test_lasso_crash_and_resume_identical(case, tmp_path):
    (n, p), lams, _ = CASES[case]
    X, y = _problem(n, p)
    crash_and_resume(diag.checkpointed_lasso_path, tmp_path, X, y,
                     lambdas=lams, chunk_size=3,
                     fields=("coef", "beta0", "niter"), **F32)


def test_uninterrupted_checkpoint_matches_plain_path(tmp_path):
    """Float32: the checkpointed engine chain against ``lasso_path``'s
    scan (its kernel's plain form here): coefficients within 1e-5 and
    ``niter`` within 1; the file is gone afterwards."""
    X, y = _problem()
    ck = str(tmp_path / "run.npz")
    res = diag.checkpointed_lasso_path(X, y, lambdas=LAMS, checkpoint=ck,
                                         chunk_size=3, **F32)
    plain = t.lasso_path(X, y, lambdas=LAMS, **F32)
    assert_path_close(res, plain, 1e-5)
    assert not os.path.exists(ck)


def _refusal_cases():
    X, y = _problem()
    X2, y2 = _problem(seed=99)
    Xrow = X.copy()
    Xrow[77, 5] += 1.0                 # an interior entry, row 0 untouched
    lin = np.linspace(0.5, 0.005, 8)   # same endpoints and count as LAMS
    Xw, yw = _problem(30, 60)
    wl = np.geomspace(0.3, 0.01, 8)
    return {
        "foreign": ((X, y), {}, (X2, y2), {}),
        "interior row": ((X, y), dict(standardize_x=False), (Xrow, y),
                         dict(standardize_x=False)),
        "interior grid": ((X, y), {}, (X, y), dict(lambdas=lin)),
        "options": ((Xw, yw), dict(lambdas=wl, _enet_scale=True), (Xw, yw),
                    dict(lambdas=wl, _enet_scale=False)),
        "other regime": ((X, y), {}, (Xw, yw), {}),
    }


@pytest.mark.parametrize("case", ["foreign", "interior row",
                                  "interior grid", "options",
                                  "other regime"])
def test_refuses_a_different_problem(case, tmp_path):
    """Another problem, an interior row of X (unstandardized, so the
    solved matrix is X itself), an interior grid point with the same
    endpoints, an option that changes the solve, or a problem whose state
    has another shape (a tall run's file, a wide call) refuse to
    resume."""
    args, kw, args2, kw2 = _refusal_cases()[case]
    ck = str(tmp_path / "ck.npz")
    base = dict(lambdas=LAMS, chunk_size=3, **F32)
    assert diag.checkpointed_lasso_path(
        *args, checkpoint=ck, _stop_after_chunks=1,
        **{**base, **kw}) is None
    with pytest.raises(ValueError, match="different"):
        diag.checkpointed_lasso_path(*args2, checkpoint=ck,
                                       **{**base, **kw2})


def test_fingerprint_digest_compared_exactly(tmp_path):
    """A digest lane one ulp away (far inside allclose's rtol) refuses."""
    X, y = _problem()
    ck = str(tmp_path / "digest.npz")
    assert diag.checkpointed_lasso_path(X, y, lambdas=LAMS, checkpoint=ck,
                                          chunk_size=3, _stop_after_chunks=1,
                                          **F32) is None
    with np.load(ck) as d:
        payload = {k: d[k] for k in d.files}
    payload["fingerprint"][-1] = np.nextafter(payload["fingerprint"][-1],
                                              np.inf)
    np.savez(ck, **payload)
    with pytest.raises(ValueError, match="different"):
        diag.checkpointed_lasso_path(X, y, lambdas=LAMS, checkpoint=ck,
                                       chunk_size=3, **F32)


def test_validates_chunk_size_and_lambdas(tmp_path):
    X, y = _problem(60, 10)
    ck = str(tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="chunk_size"):
        diag.checkpointed_lasso_path(X, y, lambdas=LAMS, checkpoint=ck,
                                       chunk_size=0, **F32)
    with pytest.raises(ValueError, match="non-empty"):
        diag.checkpointed_lasso_path(X, y, lambdas=np.array([]),
                                       checkpoint=ck, chunk_size=3, **F32)


# ---------------------------------------------------------------------------
# 2-5. Dantzig, group Lasso, GLM, generalized Lasso
# ---------------------------------------------------------------------------

def test_dantzig_matches_jax_and_resumes(jax_ref, tmp_path,
                                         jax_start_vector):
    X, y = _problem(120, 12)
    lams = np.geomspace(0.4, 0.02, 8)
    ref = jax_ref("dantzig", jck.checkpointed_dantzig_path, X, y,
                  lambdas=lams, chunk_size=3)
    got = diag.checkpointed_dantzig_path(
        X, y, lambdas=lams, chunk_size=3,
        checkpoint=str(tmp_path / "a.npz"), **F64)
    assert_path_close(got, ref, 1e-3)
    assert_path_close(got, t.dantzig_path(X, y, lambdas=lams, **F64), 1e-3)
    crash_and_resume(diag.checkpointed_dantzig_path, tmp_path, X, y,
                     lambdas=lams, chunk_size=3, **F32)


def _groups_problem():
    rng = np.random.default_rng(11)
    n, p = 120, 12
    groups = np.arange(p) % 4
    b = np.zeros(p)
    b[groups == 1] = 1.5
    X = rng.normal(size=(n, p))
    return X, X @ b + 0.3 * rng.normal(size=n), groups


def test_group_lasso_matches_jax_resumes_and_fingerprints_groups(
        jax_ref, tmp_path, jax_start_vector):
    X, y, groups = _groups_problem()
    lams = np.geomspace(0.5, 0.01, 8)
    ref = jax_ref("group", jck.checkpointed_group_lasso_path, X, y, groups,
                  lambdas=lams, chunk_size=3)
    got = diag.checkpointed_group_lasso_path(
        X, y, groups, lambdas=lams, chunk_size=3,
        checkpoint=str(tmp_path / "a.npz"), **F64)
    assert_path_close(got, ref, 1e-3)
    assert_path_close(got, t.group_lasso_path(X, y, groups, lambdas=lams,
                                              **F64), 1e-3)
    # Another grouping refuses to resume.
    crash_and_resume(diag.checkpointed_group_lasso_path, tmp_path, X, y,
                     groups, refuse=((X, y, np.arange(12) % 2), {}),
                     lambdas=lams, chunk_size=3, **F32)


def _glm_problem(seed=13):
    rng = np.random.default_rng(seed)
    n, p = 120, 10
    b = np.concatenate([[1.5, -1.0], np.zeros(p - 2)])
    X = rng.normal(size=(n, p))
    yb = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ b)))).astype(float)
    yp = rng.poisson(np.exp(0.2 * (X @ b))).astype(float)
    return X, yb, yp


@pytest.mark.parametrize("family", ["binomial", "poisson"])
def test_glm_matches_jax_and_resumes(family, jax_ref, tmp_path):
    """Binomial takes the fixed majorizer, Poisson the exact Hessian
    ("auto"); both against the plain scan on the same Hessian."""
    X, yb, yp = _glm_problem()
    y = yb if family == "binomial" else yp
    fams = {"binomial": (binomial, jbinomial), "poisson": (poisson,
                                                           jpoisson)}
    tfam, jfam = fams[family]
    lams = np.geomspace(0.1, 0.005, 8)
    ref = jax_ref(("glm", family), jck.checkpointed_glm_path, X, y, jfam(),
                  lambdas=lams, chunk_size=3)
    got = diag.checkpointed_glm_path(X, y, tfam(), lambdas=lams,
                                       chunk_size=3,
                                       checkpoint=str(tmp_path / "a.npz"),
                                       **F64)
    assert_path_close(got, ref, 1e-5)
    hess = "fixed" if family == "binomial" else "exact"
    plain = t.glm_lasso_path(X, y, tfam(), lambdas=lams, path_mode="scan",
                             hessian=hess, **F64)
    assert_path_close(got, plain, 1e-5)
    crash_and_resume(diag.checkpointed_glm_path, tmp_path, X, y, tfam(),
                     lambdas=lams, chunk_size=3, **F32)


def test_glm_refuses_another_family_or_weights_and_adaptive(tmp_path):
    X, yb, _ = _glm_problem(14)
    lams = np.geomspace(0.1, 0.01, 8)
    ck = str(tmp_path / "fam.npz")
    kw = dict(lambdas=lams, chunk_size=4, **F32)
    assert diag.checkpointed_glm_path(X, yb, binomial(), checkpoint=ck,
                                        _stop_after_chunks=1, **kw) is None
    with pytest.raises(ValueError, match="different"):
        diag.checkpointed_glm_path(X, yb, huber(1.345), checkpoint=ck,
                                     **kw)
    w = np.random.default_rng(14).uniform(0.5, 2.0, X.shape[0])
    with pytest.raises(ValueError, match="different"):
        diag.checkpointed_glm_path(X, yb, binomial(), checkpoint=ck,
                                     weights=w, **kw)
    with pytest.raises(ValueError, match="adaptive"):
        diag.checkpointed_glm_path(X, yb, poisson(), checkpoint=ck,
                                     hessian="adaptive", **kw)
    # The JAX driver accepts the same calls (the refusals are the port's
    # and the JAX package's alike).
    with pytest.raises(ValueError, match="adaptive"):
        jck.checkpointed_glm_path(X, yb, jhuber(1.345), lambdas=lams,
                                  checkpoint=str(tmp_path / "j.npz"),
                                  hessian="adaptive")


def test_gen_lasso_matches_jax_resumes_and_fingerprints_D(jax_ref,
                                                          tmp_path):
    rng = np.random.default_rng(15)
    n, p = 120, 12
    X = rng.normal(size=(n, p))
    y = 0.5 + X @ np.repeat([1.0, -0.5, 0.8], 4) + 0.3 * rng.normal(size=n)
    D = difference_matrix(p, 1)
    lams = np.geomspace(0.2, 0.01, 8)
    ref = jax_ref("genlasso", jck.checkpointed_gen_lasso_path, X, y, D,
                  lambdas=lams, chunk_size=3)
    got = diag.checkpointed_gen_lasso_path(
        X, y, D, lambdas=lams, chunk_size=3,
        checkpoint=str(tmp_path / "a.npz"), **F64)
    assert_path_close(got, ref, 1e-5)
    assert_path_close(got, t.gen_lasso_path(X, y, D, lambdas=lams,
                                            path_mode="scan", **F64), 1e-5)
    # Another D refuses to resume.
    crash_and_resume(diag.checkpointed_gen_lasso_path, tmp_path, X, y, D,
                     refuse=((X, y, difference_matrix(p, 2)), {}),
                     lambdas=lams, chunk_size=3, **F32)


# ---------------------------------------------------------------------------
# 6. Consensus
# ---------------------------------------------------------------------------

def test_consensus_matches_jax_and_resumes(jax_ref, tmp_path):
    """W = 4 workers; the JAX side on a one-device mesh (the port's
    layout).  The consensus state ``(x, y, z, rho)`` crosses the chunks."""
    X, y = _problem(120, 12)
    lams = np.geomspace(0.5, 0.01, 8)
    kw = dict(lambdas=lams, nworkers=4, chunk_size=3)
    ref = jax_ref("consensus", jck.checkpointed_parallel_lasso_path, X, y,
                  mesh=make_mesh(1), **kw)
    got = diag.checkpointed_parallel_lasso_path(
        X, y, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 2e-3)
    plain = t.parallel_lasso_path(X, y, lambdas=lams, nworkers=4, **F64)
    assert_path_close(got, plain, 2e-3)
    crash_and_resume(diag.checkpointed_parallel_lasso_path, tmp_path, X,
                     y, fields=("coef", "beta0", "niter"), **kw, **F32)
    with pytest.raises(NotImplementedError, match="mesh"):
        diag.checkpointed_parallel_lasso_path(
            X, y, checkpoint=str(tmp_path / "m.npz"), mesh=object(), **kw,
            **F32)
