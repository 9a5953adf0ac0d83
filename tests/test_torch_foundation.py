"""The port's foundation against the JAX package on the same inputs:
standardization, linear algebra, power iteration, the proximal
operators, the engines and the interop conversions.

Inputs come from numpy with fixed seeds.  Bars: standardize/recover
atol 1e-12 (float64); products and SPD inverses rtol 1e-6 in float32 and
1e-12 in float64 (norm-wise: the two libraries sum in different orders);
power iteration rtol 1e-6 from the JAX package's own start vector and
1e-4 from the port's; the prox functions, the momentum step and the rho
ladder exactly at float64 (the same IEEE operations in the same order);
the engines' final states atol 1e-10 at float64 with equal ``it``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu.core.engine as jeng
import admm_tpu.core.prox as jprox
import admm_tpu.data.standardize as jstd
import admm_tpu.linalg as jlin
import admm_tpu.models.lasso as jlasso
from admm_tpu.ops._common import fadmm_momentum as j_momentum
from admm_tpu_torch import interop
from admm_tpu_torch.core import engine as teng
from admm_tpu_torch.core import prox as tprox
from admm_tpu_torch.data import standardize as tstd
from admm_tpu_torch import linalg as tlin
from admm_tpu_torch.kernels._common import fadmm_momentum as t_momentum
from admm_tpu_torch.models import lasso as tlasso

torch.set_num_threads(1)


def _t(a, dtype=None):
    return interop.to_torch(a, dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# standardize / recover
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def std_data():
    rng = np.random.default_rng(5)
    n, p = 40, 6
    X = rng.normal(size=(n, p)) * rng.uniform(0.5, 3, p) + rng.normal(0, 4, p)
    X[:, 2] = 7.25                       # a constant column: the _guard path
    y = 3.0 + X[:, :3] @ np.array([1.0, -2.0, 0.5]) + rng.normal(size=n)
    w = rng.uniform(0.2, 2.0, n)
    coef = rng.normal(size=(5, p))
    return X, y, w, coef


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("standardize_x,intercept",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_standardize_and_recover_match(std_data, standardize_x, intercept,
                                       weighted):
    X, y, w, coef = std_data
    kw = dict(standardize_x=standardize_x, intercept=intercept)
    Xj, yj, sj = jstd.standardize(jnp.asarray(X), jnp.asarray(y),
                                  weights=jnp.asarray(w) if weighted else None,
                                  **kw)
    Xt, yt, st = tstd.standardize(_t(X), _t(y),
                                  weights=_t(w) if weighted else None, **kw)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-12)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-12)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    b0j, cj = jstd.recover(sj, jnp.asarray(coef), **kw)
    b0t, ct = tstd.recover(st, _t(coef), **kw)
    np.testing.assert_allclose(b0t.numpy(), np.asarray(b0j), atol=1e-12)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-12)


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("np_dtype,bar", [(np.float32, 1e-6),
                                          (np.float64, 1e-12)])
def test_products_and_spd_inverses_match(np_dtype, bar):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(30, 12)).astype(np_dtype)
    v = rng.normal(size=12).astype(np_dtype)
    Xj, Xt = jnp.asarray(X), _t(X)
    assert _rel(tlin.dot(Xt, _t(v)).numpy(), jlin.dot(Xj, jnp.asarray(v))) <= bar
    assert _rel(tlin.gram(Xt).numpy(), jlin.gram(Xj)) <= bar
    assert _rel(tlin.tgram(Xt).numpy(), jlin.tgram(Xj)) <= bar
    S = X.T @ X
    assert _rel(tlin.ridge_inverse(_t(S), 0.7).numpy(),
                jlin.ridge_inverse(jnp.asarray(S), 0.7)) <= bar
    # jitter adds jitter * mean(diag) to the diagonal
    assert _rel(tlin.chol_inverse(_t(S), jitter=1e-3).numpy(),
                jlin.chol_inverse(jnp.asarray(S), jitter=1e-3)) <= bar
    assert _rel(tlin.chol_inverse(_t(S), jitter=1e-3).numpy(),
                jlin.chol_inverse(jnp.asarray(S))) > 10 * bar


def test_power_iteration_matches():
    # A shared factor gives each matrix a clear spectral gap, so 50 steps
    # converge from any start and the two start vectors agree to 1e-4.
    rng = np.random.default_rng(7)
    X = (rng.normal(size=(40, 25))
         + np.outer(rng.normal(size=40), np.ones(25))).astype(np.float32)
    Xw = (rng.normal(size=(20, 50))
          + np.outer(rng.normal(size=20), np.ones(50))).astype(np.float32)
    S = X.T @ X
    v0 = lambda d: np.asarray(jax.random.normal(jax.random.PRNGKey(0), (d,),
                                                dtype=jnp.float32))
    ref = float(jlin.spectral_radius_sym(jnp.asarray(S)))
    got = float(tlin.spectral_radius_sym(_t(S), v0=_t(v0(25))))
    assert got == pytest.approx(ref, rel=1e-6)
    assert float(tlin.spectral_radius_sym(_t(S))) == pytest.approx(ref,
                                                                  rel=1e-4)
    for A, dim in ((X, 25), (Xw, 20)):
        ref = float(jlin.spectral_radius_gram(jnp.asarray(A)))
        got = float(tlin.spectral_radius_gram(_t(A), v0=_t(v0(dim))))
        assert got == pytest.approx(ref, rel=1e-6)
        assert float(tlin.spectral_radius_gram(_t(A))) == pytest.approx(
            ref, rel=1e-4)


def test_power_iteration_generator_is_explicit():
    rng = np.random.default_rng(8)
    S = _t((lambda a: a.T @ a)(rng.normal(size=(30, 10))))
    a = tlin.spectral_radius_sym(S, generator=torch.Generator().manual_seed(3))
    b = tlin.spectral_radius_sym(S, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tlin.spectral_radius_sym(S, v0=torch.ones(9, dtype=S.dtype))


# ---------------------------------------------------------------------------
# prox, momentum, rho ladder: exact at float64
# ---------------------------------------------------------------------------

def test_prox_functions_exact():
    rng = np.random.default_rng(9)
    v = rng.normal(size=(4, 50))
    v[0, :5] = 0.0
    pen = rng.uniform(0.1, 1.0, size=(4, 1))
    for a, b in ((tprox.soft_threshold(_t(v), _t(pen)),
                  jprox.soft_threshold(jnp.asarray(v), jnp.asarray(pen))),
                 (tprox.enet_prox(_t(v), _t(pen), 0.6),
                  jprox.enet_prox(jnp.asarray(v), jnp.asarray(pen), 0.6)),
                 (tprox.box_clamp_neg(_t(v), 0.3),
                  jprox.box_clamp_neg(jnp.asarray(v), 0.3)),
                 (tprox.sqnorm(_t(v[1])), jprox.sqnorm(jnp.asarray(v[1]))),
                 (tprox.l2norm(_t(v[1])), jprox.l2norm(jnp.asarray(v[1])))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fadmm_momentum_exact():
    rng = np.random.default_rng(10)
    k, p = 6, 20
    vec = lambda: rng.normal(size=(k, p))
    colv = lambda lo, hi: rng.uniform(lo, hi, size=(k, 1))
    z_new, y_new, z, y, az, ay = (vec() for _ in range(6))
    adj_a, r_pri, extra = colv(1, 3), colv(0, 1), colv(0, 1)
    adj_c = np.array([[1e-3], [5.0], [0.2], [9999.0], [0.5], [1.0]])
    now_done = np.array([[False], [True], [False], [False], [True], [False]])
    args = (now_done, 0.8, r_pri, extra, z_new, y_new, z, y, az, ay, adj_a,
            adj_c, 0.999)
    ref = j_momentum(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                       for a in args))
    got = t_momentum(*(_t(a) if isinstance(a, np.ndarray) else a
                       for a in args))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adaptive_rho_exact():
    rng = np.random.default_rng(11)
    m = 64
    rho = rng.uniform(0.1, 5, m)
    r_pri, r_dua = rng.uniform(0, 2, m) ** 4, rng.uniform(0, 2, m) ** 4
    e_pri, e_dua = rng.uniform(0.01, 1, m), rng.uniform(0.01, 1, m)
    ref = jeng._adaptive_rho(*(jnp.asarray(a) for a in
                               (rho, r_pri, e_pri, r_dua, e_dua)))
    got = teng._adaptive_rho(*(_t(a) for a in
                               (rho, r_pri, e_pri, r_dua, e_dua)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# engines on the lasso ProblemOps, float64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(50, 8))
    y = X @ np.array([1.0, 0, 0, -0.5, 0, 2.0, 0, 0]) + 0.3 * rng.normal(size=50)
    Xw = rng.normal(size=(10, 24))
    yw = Xw[:, :3].sum(axis=1) + 0.1 * rng.normal(size=10)
    return dict(X=X, y=y, Xw=Xw, yw=yw)


def _assert_states_match(st_t, st_j):
    ref = interop.from_reference(st_j)
    for name, a, b in zip(st_t._fields, st_t, ref):
        if a is None:
            assert b is None, name
        elif a.dtype in (torch.bool, torch.int32):
            assert torch.equal(a, b.to(a.dtype)), name
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-10,
                                       err_msg=name)


def _tall_toy(toy, alpha):
    X, y = toy["X"], toy["y"]
    S = X.T @ X
    rho = 1.3
    Minv = np.asarray(jlin.ridge_inverse(jnp.asarray(S), rho))
    Xty = X.T @ y
    lam = 0.2 * np.abs(Xty).max()
    ops_j = jlasso._tall_ops(jnp.asarray(Minv), jnp.asarray(Xty), alpha, 8)
    ops_t = tlasso._tall_ops(_t(Minv), _t(Xty), alpha, 8)
    return ops_j, ops_t, rho, lam, Xty


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_fadmm_engine_and_warm_start_match(toy, alpha):
    ops_j, ops_t, rho, lam, _ = _tall_toy(toy, alpha)
    sj = jax.jit(jeng.make_fadmm_solver(ops_j), static_argnums=1)
    st_ = teng.make_fadmm_solver(ops_t)
    z = np.zeros(8)
    a = jeng.make_state(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), rho,
                        lam, dtype=jnp.float64)
    b = teng.make_state(_t(z), _t(z), _t(z), rho, lam, dtype=torch.float64)
    for lam_k in (lam, 0.5 * lam, 0.2 * lam):
        a = sj(jeng.warm_start(a, lam_k), 500, 1e-6, 1e-6)
        b = st_(teng.warm_start(b, lam_k), 500, 1e-6, 1e-6)
        _assert_states_match(b, a)
        assert int(b.it) > 1


def test_admm_engine_adaptive_rho_matches(toy):
    Xw, yw = toy["Xw"], toy["yw"]
    sprad = float(np.linalg.eigvalsh(Xw @ Xw.T).max())
    lambda0 = float(np.abs(Xw.T @ yw).max())
    ops_j = jlasso._wide_ops(jnp.asarray(Xw), jnp.asarray(yw), jnp.asarray(sprad),
                             jnp.asarray(lambda0), 1.0, 10, 24)
    ops_t = tlasso._wide_ops(_t(Xw), _t(yw), _t(sprad), _t(lambda0), 1.0, 10,
                             24)
    sj = jax.jit(jeng.make_admm_solver(ops_j), static_argnums=1)
    z = np.zeros(10)
    a = jeng.make_state(jnp.zeros(24), jnp.asarray(z), jnp.asarray(z), 0.5,
                        0.3 * lambda0, aux=jnp.asarray(z), dtype=jnp.float64)
    b = teng.make_state(torch.zeros(24, dtype=torch.float64), _t(z), _t(z),
                        0.5, 0.3 * lambda0, aux=_t(z))
    a = sj(a, 800, 1e-6, 1e-6)
    b = teng.make_admm_solver(ops_t)(b, 800, 1e-6, 1e-6)
    _assert_states_match(b, a)
    assert float(b.rho) != 0.5          # the ladder moved rho


def test_batched_engine_freezes_lanes_like_jax(toy):
    ops_j, ops_t, rho, lam, _ = _tall_toy(toy, 1.0)
    ilams = lam * np.array([1.5, 1.0, 0.3, 0.05, 0.01])
    st_j = jlasso._batched_cold_states(5, 8, rho, jnp.asarray(ilams),
                                       jnp.float64)
    st_t = tlasso._batched_cold_states(5, 8, rho, _t(ilams))
    _assert_states_match(st_t, st_j)
    bj = jax.jit(jeng.make_batched_solver(jeng.make_fadmm_solver(ops_j)),
                 static_argnums=1)
    a = bj(st_j, 1000, 1e-7, 1e-7)
    b = teng.make_batched_solver(teng.make_fadmm_solver(ops_t))(
        st_t, 1000, 1e-7, 1e-7)
    _assert_states_match(b, a)
    assert bool(b.done.all()) and len(set(b.it.tolist())) > 1


def test_batched_engine_stops_at_maxit(toy):
    ops_j, ops_t, rho, lam, _ = _tall_toy(toy, 1.0)
    ilams = lam * np.array([1.0, 0.01])
    bj = jeng.make_batched_solver(jeng.make_fadmm_solver(ops_j))
    a = bj(jlasso._batched_cold_states(2, 8, rho, jnp.asarray(ilams),
                                       jnp.float64), 3, 1e-12, 1e-12)
    b = teng.make_batched_solver(teng.make_fadmm_solver(ops_t))(
        tlasso._batched_cold_states(2, 8, rho, _t(ilams)), 3, 1e-12, 1e-12)
    _assert_states_match(b, a)
    assert b.it.tolist() == [3, 3] and not bool(b.done.any())


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------

def test_interop_round_trips(std_data):
    X, y, _, coef = std_data
    _, _, sj = jstd.standardize(jnp.asarray(X), jnp.asarray(y),
                                standardize_x=True, intercept=True)
    st = interop.from_reference(sj)
    assert isinstance(st, tstd.StdStats)
    back = interop.to_reference(st, jstd.StdStats)
    for a, b in zip(back, sj):
        np.testing.assert_array_equal(a, np.asarray(b))
    z = jnp.zeros(4)
    state = jeng.make_state(z, z, z, 1.0, 0.5, dtype=jnp.float64)
    ts = interop.from_reference(state, dtype=torch.float32)
    assert isinstance(ts, teng.ADMMState) and ts.aux is None
    assert ts.rho.dtype == torch.float32 and ts.it.dtype == torch.int32
    assert isinstance(interop.to_reference(ts, jeng.ADMMState), jeng.ADMMState)
    res = jlasso.PathResult(jnp.ones(3), jnp.zeros(3), jnp.asarray(coef[:3]),
                            jnp.arange(3))
    tres = interop.from_reference(res)
    assert isinstance(tres, tlasso.PathResult) and tres.trace is None
    np.testing.assert_array_equal(tres.coef.numpy(), coef[:3])
    with pytest.raises(TypeError):
        interop.to_reference(tres, jstd.StdStats)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of ``admm_tpu_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or ``admm_tpu``, and the package imports where JAX is absent."""
    import re
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = sorted(path for path in (root / "admm_tpu_torch").rglob("*.py")
                   if "_build" not in path.parts)  # build outputs: no sources
    files.append(root / "chip_smoke.py")
    assert len(files) > 15
    pat = re.compile(r"^\s*(from|import)\s+(jax|admm_tpu)(\.|\s|$)", re.M)
    for path in files:
        assert not pat.search(path.read_text()), path
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['admm_tpu'] = None; import admm_tpu_torch as t; "
            "import admm_tpu_torch.interop; "
            "print(len(t.__all__), sorted(t.kernels.launch_counts()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "bp_batch_solve" in out.stdout and "lad_solve" in out.stdout
