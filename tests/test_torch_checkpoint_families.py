"""The port's checkpointed drivers of the other families
(``admm_tpu_torch.diag.checkpoint``: multi-task, multinomial, SLOPE,
graphical lasso, SVM, Cox, square-root, constrained, relaxed, quantile and
robust PCA) against the JAX package's, on the same seeded numpy inputs,
the port on ``device="cpu"``.

As in ``tests/test_torch_checkpoint.py``: each driver in float64 against
the JAX package's driver (run once per module) and the port's one-shot
scan, at the bar ``tests/test_checkpoint.py`` holds the JAX driver to
against its plain path (1e-5; 1e-4 nuclear, 2e-5 glasso, square-root and
constrained, 2e-4 relaxed, 1e-3 quantile, 1e-4 robust PCA and 1e-3 with
``rank=``), ``niter`` within 1 (not with ``rank=``: the partial SVT's
start basis differs between the packages, so only L and S are held);
power iteration from the JAX start vector.  A run stopped after one chunk
and resumed equals the uninterrupted run to the bit: in float32, and for
the quantile and robust-PCA paths, whose engine loops are the slowest
here, in float64 on the parity run itself.  The quantile path runs at
eps 1e-4 on a 50 x 5 problem (the port's host loop takes about 1 ms an
iteration here).  The glasso driver validates ``xupdate`` as
``glasso_path`` does; the JAX driver's fall-through to the eigh prox is
not pinned.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu_torch as t
from admm_tpu.diag import checkpoint as jck
from admm_tpu_torch import diag
from admm_tpu_torch.models.slope import bh_sequence

from _torch_parity import assert_path_close, crash_and_resume
from _torch_parity import jax_start_vector  # noqa: F401  (a fixture)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
F32 = dict(dtype=torch.float32, device="cpu")


def _problem(n=120, p=12, seed=7):
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.5)
    X = rng.normal(size=(n, p))
    return X, 1.5 + X @ b + 0.3 * rng.normal(size=n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's driver in float64, run once per module and key."""
    cache = {}

    def run(key, driver, *args, **kw):
        if key not in cache:
            ck = str(tmp_path_factory.mktemp("jax") / "ref.npz")
            cache[key] = driver(*args, checkpoint=ck, dtype=jnp.float64,
                                **kw)
        return cache[key]

    return run


# ---------------------------------------------------------------------------
# 7-8. Multi-task and multinomial
# ---------------------------------------------------------------------------

def _multitask_problem(K, rank=None, seed=23):
    rng = np.random.default_rng(seed)
    n, p = 120, 10
    X = rng.normal(size=(n, p))
    if rank is None:
        B = np.zeros((p, K))
        B[:3] = rng.uniform(0.5, 1.5, (3, K))
    else:
        B = rng.normal(size=(p, rank)) @ rng.normal(size=(rank, K))
    return X, X @ B + 0.3 * rng.normal(size=(n, K))


@pytest.mark.parametrize("penalty", ["rows", "nuclear"])
def test_multitask_matches_jax_and_resumes(penalty, jax_ref, tmp_path,
                                           jax_start_vector):
    X, Y = (_multitask_problem(3) if penalty == "rows"
            else _multitask_problem(4, rank=2, seed=31))
    lams = (np.geomspace(0.3, 0.01, 8) if penalty == "rows"
            else np.geomspace(0.5, 0.02, 8))
    bar = 1e-5 if penalty == "rows" else 1e-4
    kw = dict(lambdas=lams, chunk_size=3, penalty=penalty)
    ref = jax_ref(("multitask", penalty),
                  jck.checkpointed_multitask_lasso_path, X, Y, **kw)
    got = diag.checkpointed_multitask_lasso_path(
        X, Y, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, bar)
    plain = (t.multitask_lasso_path if penalty == "rows"
             else t.multitask_nuclear_path)(X, Y, lambdas=lams,
                                            path_mode="scan", **F64)
    assert_path_close(got, plain, bar)
    # A nuclear run's checkpoint refuses a rows-penalty call, and back.
    other = "rows" if penalty == "nuclear" else "nuclear"
    crash_and_resume(diag.checkpointed_multitask_lasso_path, tmp_path, X, Y,
                     refuse=((X, Y), dict(penalty=other)), **kw, **F32)


def test_multinomial_matches_jax_resumes_and_fingerprints_grouped(
        jax_ref, tmp_path):
    X, _ = _multitask_problem(3)
    ylab = np.random.default_rng(24).integers(0, 3, X.shape[0])
    kw = dict(lambdas=np.geomspace(0.1, 0.01, 8), chunk_size=3)
    ref = jax_ref("multinomial", jck.checkpointed_multinomial_path, X, ylab,
                  **kw)
    got = diag.checkpointed_multinomial_path(
        X, ylab, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 1e-5)
    assert_path_close(got, t.multinomial_lasso_path(
        X, ylab, path_mode="scan", lambdas=kw["lambdas"], **F64), 1e-5)
    crash_and_resume(diag.checkpointed_multinomial_path, tmp_path, X, ylab,
                     refuse=((X, ylab), dict(grouped=True)), **kw, **F32)


# ---------------------------------------------------------------------------
# 9-11. SLOPE, graphical lasso, SVM
# ---------------------------------------------------------------------------

def test_slope_matches_jax_resumes_and_fingerprints_the_sequence(
        jax_ref, tmp_path, jax_start_vector):
    rng = np.random.default_rng(41)
    X = rng.normal(size=(120, 12))
    y = X[:, :3] @ np.array([2.0, -1.0, 1.0]) + 0.3 * rng.normal(size=120)
    kw = dict(lambdas=np.geomspace(0.3, 0.01, 8), chunk_size=3)
    ref = jax_ref("slope", jck.checkpointed_slope_path, X, y, **kw)
    got = diag.checkpointed_slope_path(
        X, y, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 1e-5)
    assert_path_close(got, t.slope_path(X, y, lambdas=kw["lambdas"],
                                        path_mode="scan", **F64), 1e-5)
    crash_and_resume(diag.checkpointed_slope_path, tmp_path, X, y,
                     refuse=((X, y), dict(lam_seq=bh_sequence(12, 0.3))),
                     **kw, **F32)


def _cov():
    A = np.random.default_rng(31).normal(size=(200, 10))
    return A.T @ A / 200 + np.eye(10)


@pytest.mark.parametrize("xupdate", ["newton", "eigh"])
def test_glasso_matches_jax_and_resumes(xupdate, jax_ref, tmp_path):
    """The adaptive rho rides the saved state."""
    S = _cov()
    kw = dict(cov=S, lambdas=np.geomspace(0.5, 0.02, 8), chunk_size=3,
              xupdate=xupdate)
    ref = jax_ref(("glasso", xupdate), jck.checkpointed_glasso_path, **kw)
    got = diag.checkpointed_glasso_path(
        checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 2e-5, fields=("precision",))
    plain = t.glasso_path(cov=S, lambdas=kw["lambdas"], path_mode="scan",
                          xupdate=xupdate, **F64)
    assert_path_close(got, plain, 2e-5, fields=("precision",))
    # The penalty convention is part of the problem.
    crash_and_resume(diag.checkpointed_glasso_path, tmp_path,
                     fields=("precision", "niter"),
                     refuse=((), dict(penalize_diagonal=True)), **kw, **F32)


def test_glasso_validates_xupdate(tmp_path):
    """An unknown ``xupdate`` raises ``glasso_path``'s error (the JAX
    driver runs the eigh prox for any string)."""
    kw = dict(cov=_cov(), lambdas=[0.5, 0.1], xupdate="cholesky", **F32)
    with pytest.raises(ValueError, match="xupdate must be") as want:
        t.glasso_path(**kw)
    with pytest.raises(ValueError, match="xupdate must be") as got:
        diag.checkpointed_glasso_path(checkpoint=str(tmp_path / "x.npz"),
                                      **kw)
    assert str(got.value) == str(want.value)


def test_svm_matches_jax_resumes_and_fingerprints_the_loss(jax_ref,
                                                           tmp_path):
    rng = np.random.default_rng(32)
    X = rng.normal(size=(120, 12))
    y = (X @ rng.normal(size=12) > 0).astype(int)
    kw = dict(Cs=np.geomspace(2.0, 0.02, 8), chunk_size=3)
    ref = jax_ref("svm", jck.checkpointed_svm_path, X, y, **kw)
    got = diag.checkpointed_svm_path(X, y, checkpoint=str(tmp_path / "a.npz"),
                                     **kw, **F64)
    assert_path_close(got, ref, 1e-5, fields=("coef", "intercept"),
                      grid="Cs")
    plain = t.svm_path(X, y, Cs=kw["Cs"], path_mode="scan", **F64)
    assert_path_close(got, plain, 1e-5, fields=("coef", "intercept"),
                      grid="Cs")
    crash_and_resume(diag.checkpointed_svm_path, tmp_path, X, y,
                     fields=("coef", "intercept", "niter"),
                     refuse=((X, y), dict(loss="hinge")), **kw, **F32)


def test_checkpointed_svm_carries_class_labels(tmp_path):
    """``predict(type="class")`` on a checkpointed fit maps back to the
    original labels."""
    rng = np.random.default_rng(33)
    X = rng.normal(size=(80, 6))
    y = np.where(X @ rng.normal(size=6) > 0, 7, 2)
    res = diag.checkpointed_svm_path(X, y, Cs=[1.0, 0.1],
                                     checkpoint=str(tmp_path / "s.npz"),
                                     chunk_size=1, **F32)
    assert res.classes == (2, 7)
    lab = t.predict(res, X, type="class", lam=1.0)
    assert set(np.unique(lab)) <= {2, 7}


# ---------------------------------------------------------------------------
# 12. Cox
# ---------------------------------------------------------------------------

def _cox_problem():
    rng = np.random.default_rng(21)
    n, p = 120, 8
    X = rng.normal(size=(n, p))
    b = np.concatenate([[0.8, -0.6], np.zeros(p - 2)])
    t_ = rng.exponential(np.exp(-(X @ b)))
    d = (rng.uniform(size=n) < 0.75).astype(float)
    extra = {"start": t_ * rng.uniform(0, 0.7, n),
             "strata": rng.integers(0, 2, n)}
    return X, t_, d, extra


@pytest.mark.parametrize("case", ["plain", "start", "strata"])
def test_cox_matches_jax_and_resumes(case, jax_ref, tmp_path):
    X, t_, d, extra = _cox_problem()
    opt = {} if case == "plain" else {case: extra[case]}
    kw = dict(lambdas=np.exp(np.linspace(np.log(0.2), np.log(0.01), 8)),
              chunk_size=3, **opt)
    ref = jax_ref(("cox", case), jck.checkpointed_cox_path, X, t_, d, **kw)
    got = diag.checkpointed_cox_path(X, t_, d,
                                     checkpoint=str(tmp_path / "a.npz"),
                                     **kw, **F64)
    assert_path_close(got, ref, 1e-5, fields=("coef",))
    plain = t.cox_lasso_path(X, t_, d, lambdas=kw["lambdas"], **opt, **F64)
    assert_path_close(got, plain, 1e-5, fields=("coef",))
    # Other survival times (the same X and events) define other risk
    # sets: refused.
    t2 = t_.copy()
    t2[0] *= 2.0
    crash_and_resume(diag.checkpointed_cox_path, tmp_path, X, t_, d,
                     refuse=((X, t2, d), {}), **kw, **F32)


# ---------------------------------------------------------------------------
# 13-15. Square-root, constrained and relaxed lasso
# ---------------------------------------------------------------------------

def test_sqrt_lasso_matches_jax_and_resumes(jax_ref, tmp_path,
                                            jax_start_vector):
    """The concomitant chain's (state, sigma) carry crosses the chunks."""
    X, y = _problem()
    kw = dict(lambdas=np.geomspace(0.3, 0.01, 8), chunk_size=3)
    ref = jax_ref("sqrt", jck.checkpointed_sqrt_lasso_path, X, y, **kw)
    got = diag.checkpointed_sqrt_lasso_path(
        X, y, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 2e-5)
    assert_path_close(got, t.sqrt_lasso_path(X, y, lambdas=kw["lambdas"],
                                             path_mode="scan", **F64), 2e-5)
    crash_and_resume(diag.checkpointed_sqrt_lasso_path, tmp_path, X, y,
                     **kw, **F32)


def test_constrained_lasso_matches_jax_resumes_and_fingerprints_C(
        jax_ref, tmp_path, jax_start_vector):
    X, y = _problem(120, 12)
    C = np.ones((1, 12))
    kw = dict(lambdas=np.geomspace(0.2, 0.005, 8), chunk_size=3)
    ref = jax_ref("conlasso", jck.checkpointed_constrained_lasso_path, X, y,
                  C, **kw)
    got = diag.checkpointed_constrained_lasso_path(
        X, y, C, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 2e-5)
    assert_path_close(got, t.constrained_lasso_path(
        X, y, C, lambdas=kw["lambdas"], path_mode="scan", **F64), 2e-5)
    full = crash_and_resume(diag.checkpointed_constrained_lasso_path,
                            tmp_path, X, y, C, refuse=((X, y, 2.0 * C), {}),
                            **kw, **F32)
    # The zero-sum constraint holds along the whole path.
    assert float(full.coef.sum(dim=1).abs().max()) < 1e-3


def test_relaxed_lasso_matches_jax_and_resumes(jax_ref, tmp_path,
                                               jax_start_vector):
    X, y = _problem()
    kw = dict(lambdas=np.geomspace(0.4, 0.02, 8), chunk_size=3)
    ref = jax_ref("relaxed", jck.checkpointed_relaxed_lasso_path, X, y,
                  **kw)
    got = diag.checkpointed_relaxed_lasso_path(
        X, y, checkpoint=str(tmp_path / "a.npz"), **kw, **F64)
    assert_path_close(got, ref, 2e-4,
                      fields=("coef", "beta0", "refit_coef", "refit_beta0"),
                      niter=False)
    assert_path_close(got.fit, ref.fit, 2e-4)
    plain = t.relaxed_lasso_path(X, y, lambdas=kw["lambdas"], **F64)
    assert_path_close(got, plain, 2e-4, fields=("coef", "beta0"),
                      niter=False)
    full = crash_and_resume(diag.checkpointed_relaxed_lasso_path, tmp_path,
                            X, y, fields=("coef", "beta0", "refit_coef"),
                            **kw, **F32)
    # The gamma = 1 lane is the lasso path itself.
    np.testing.assert_array_equal(full.coef[-1].numpy(),
                                  full.fit.coef.numpy())


# ---------------------------------------------------------------------------
# 16-17. Quantile and robust PCA
# ---------------------------------------------------------------------------

def test_quantile_matches_jax_resumes_and_fingerprints_taus(jax_ref,
                                                            tmp_path):
    """One lane per tau; the lanes' scans advance together."""
    X, y = _problem(50, 5)
    kw = dict(tau=np.array([0.3, 0.7]), lambdas=np.geomspace(0.1, 0.02, 3),
              chunk_size=2, eps_abs=1e-4, eps_rel=1e-4)
    ref = jax_ref("quantile", jck.checkpointed_quantile_lasso_path, X, y,
                  **kw)
    got = crash_and_resume(diag.checkpointed_quantile_lasso_path, tmp_path,
                           X, y, fields=("coef", "beta0", "niter"),
                           refuse=((X, y), dict(tau=np.array([0.25, 0.75]))),
                           **kw, **F64)
    assert got.coef.shape == (2, 3, 5) and got.niter.shape == (2, 3)
    assert_path_close(got, ref, 1e-3)


def _rpca_problem():
    rng = np.random.default_rng(21)
    L0 = rng.normal(size=(30, 3)) @ rng.normal(size=(3, 20))
    S0 = np.zeros((30, 20))
    idx = rng.uniform(size=(30, 20)) < 0.08
    S0[idx] = 8 * rng.choice([-1.0, 1.0], size=idx.sum())
    return L0 + S0


@pytest.mark.parametrize("rank", [None, 3])
def test_rpca_matches_jax_and_resumes(rank, jax_ref, tmp_path):
    """The exact SVT on the full grid; ``rank=3`` (the partial SVT, its
    warm basis in the saved state) on the grid's slice at and below
    ``1/sqrt(30)``, where the planted rank-3 part is the solution."""
    M = _rpca_problem()
    lams = np.geomspace(3, 1 / 3, 6) / np.sqrt(30)
    if rank is not None:
        lams = lams[lams <= 1 / np.sqrt(30) + 1e-12][:2]
    kw = dict(lambdas=lams, chunk_size=2 if rank is None else 1, rank=rank,
              maxit=2000)
    ref = jax_ref(("rpca", rank), jck.checkpointed_rpca_path, M, **kw)
    got = crash_and_resume(diag.checkpointed_rpca_path, tmp_path, M,
                           fields=("low_rank", "sparse", "niter"), **kw,
                           **F64)
    fields = ("low_rank", "sparse")
    assert_path_close(got, ref, 1e-4 if rank is None else 1e-3,
                      fields=fields, niter=rank is None)
    if rank is None:
        assert_path_close(got, t.rpca_path(M, lambdas=lams, maxit=2000,
                                           **F64), 1e-4, fields=fields)
