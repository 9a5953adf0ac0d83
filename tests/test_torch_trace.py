"""The traced solves of the port (``core.engine.make_traced_solve``,
``make_batched_traced_solve``, ``admm_tpu_torch.diag``) against the JAX
package's, on the same seeded numpy inputs and ``device="cpu"``.

Bars: the (trace_len, 5) buffers within rtol 1e-4 in float64 (atol 1e-10
of each trace's largest entry in its column, for the residuals that fall
to rounding noise); rows past convergence NaN in both, and the count of
recorded rows within 1 of the JAX package's; ``format_trace`` gives the
same table layout.  Every comparison sets rho (the power-iteration start
vector differs between the packages).  A traced call never reaches a
kernel: the kernel wrappers are spied on.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu.diag import format_trace as jformat_trace
from admm_tpu.diag import traced_solve as jtraced_solve
from admm_tpu_torch.diag import format_trace, traced_solve
from admm_tpu_torch.diag.trace import trace_from_buffer
from admm_tpu_torch.kernels import bp as bp_kernel
from admm_tpu_torch.kernels import glm as glm_kernel
from admm_tpu_torch.kernels import lad as lad_kernel
from admm_tpu_torch.kernels import tall_path, wide_path

from _torch_parity import jax_start_vector  # noqa: F401  (a fixture)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
TALL_RHO, WIDE_RHO = 20.0, 1.0


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    return X, X[:, :4] @ np.ones(4) + 0.1 * rng.normal(size=n)


@pytest.fixture(scope="module")
def tall():
    return _problem(120, 20, 0)


@pytest.fixture(scope="module")
def wide():
    return _problem(30, 60, 1)


@pytest.fixture
def kernel_spy(monkeypatch):
    """Every call of a kernel wrapper (on the CPU the plain forms run and
    count no launch, so the calls are what tells the engine from a
    kernel)."""
    calls = []
    for mod, name in ((tall_path, "tall_path_batch"),
                      (tall_path, "tall_path_scan"),
                      (wide_path, "wide_path_batch"),
                      (lad_kernel, "lad_solve"),
                      (bp_kernel, "bp_batch_solve"),
                      (glm_kernel, "glm_batch_path")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_traces_match(got, ref):
    """Two buffers of (..., trace_len, 5): same shape, NaN rows in the same
    places up to one row, values within rtol 1e-4."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    rows_g = (~np.isnan(got[..., 0])).sum(axis=-1)
    rows_r = (~np.isnan(ref[..., 0])).sum(axis=-1)
    assert np.abs(rows_g - rows_r).max() <= 1
    # Each recorded row is all finite, each other row all NaN.
    for buf in (got, ref):
        rec = ~np.isnan(buf[..., 0])
        assert np.isfinite(buf[rec]).all() and np.isnan(buf[~rec]).all()
    both = ~np.isnan(got[..., 0]) & ~np.isnan(ref[..., 0])
    # atol: 1e-10 of the trace's largest entry in each column, for the
    # residuals that fall to rounding noise.
    scale = np.nanmax(np.abs(ref), axis=-2, keepdims=True)
    tol = 1e-4 * np.abs(ref) + 1e-10 * scale
    assert (np.abs(got - ref) <= tol)[both].all()


@pytest.mark.parametrize("regime,mode", [
    ("tall", "scan"), ("tall", "batch"), ("wide", "scan"), ("wide", "batch"),
    ("wide", "activeset")])
def test_traced_lasso_path_matches_jax(tall, wide, kernel_spy, regime, mode):
    """Scan records the warm-started sequence, batch each cold lane,
    "activeset" falls back to the traced scan; float64 buffers agree."""
    X, y = tall if regime == "tall" else wide
    rho = TALL_RHO if regime == "tall" else WIDE_RHO
    kw = dict(nlambda=5, trace_len=64, path_mode=mode, rho=rho)
    ref = admm_tpu.lasso_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.lasso_path(X, y, **kw, **F64)
    assert kernel_spy == []
    assert got.trace.shape == (5, 64, 5) and got.trace.dtype == torch.float64
    _assert_traces_match(got.trace, ref.trace)
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(ref.niter))
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                               atol=1e-9)


@pytest.mark.parametrize("mode", ["scan", "batch"])
def test_traced_float32_path_launches_nothing_and_keeps_the_solution(
        tall, kernel_spy, mode):
    """A float32 traced path takes the engine (the untraced one takes the
    kernels' route): same coefficients to 1e-5, niter within 1, and the
    recorded rows are the per-lambda niter (up to trace_len)."""
    X, y = tall
    kw = dict(nlambda=5, path_mode=mode, rho=TALL_RHO, device="cpu")
    traced = admm_tpu_torch.lasso_path(X, y, trace_len=16, **kw)
    assert kernel_spy == []
    plain = admm_tpu_torch.lasso_path(X, y, **kw)
    assert kernel_spy == [f"tall_path_{mode}"]
    np.testing.assert_allclose(traced.coef.numpy(), plain.coef.numpy(),
                               atol=1e-5)
    niter = traced.niter.numpy()
    assert np.abs(niter - plain.niter.numpy()).max() <= 1
    rec = (~np.isnan(traced.trace.numpy()[..., 0])).sum(axis=1)
    np.testing.assert_array_equal(rec, np.minimum(niter, 16))
    ref = admm_tpu.lasso_path(X, y, nlambda=5, path_mode=mode, rho=TALL_RHO,
                              trace_len=16)
    assert np.abs(niter - np.asarray(ref.niter)).max() <= 1


def test_traced_lad_bp_dantzig_glm_match_jax(tall, wide, kernel_spy,
                                            jax_start_vector):
    """The single-solve engines (LAD, BP), the Dantzig scan and the GLM
    scan, each traced in float64 against the JAX package's trace (the
    Dantzig step scales with sprad: power iteration starts from the JAX
    package's vector)."""
    X, y = tall
    A, b = wide
    ref = admm_tpu.lad_fit(X, y, trace_len=128, dtype=jnp.float64)
    got = admm_tpu_torch.lad_fit(X, y, trace_len=128, **F64)
    _assert_traces_match(got.trace, ref.trace)
    ref = admm_tpu.bp_fit(A, b, trace_len=64, dtype=jnp.float64)
    got = admm_tpu_torch.bp_fit(A, b, trace_len=64, **F64)
    _assert_traces_match(got.trace, ref.trace)
    kw = dict(nlambda=3, trace_len=32, rho=1.0, path_mode="batch")
    ref = admm_tpu.dantzig_path(X, y, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.dantzig_path(X, y, **kw, **F64)
    assert got.trace.shape == (3, 32, 5)     # tracing implies "scan"
    _assert_traces_match(got.trace, ref.trace)
    yb = (y > np.median(y)).astype(float)
    kw = dict(nlambda=3, trace_len=32, path_mode="batch")
    ref = admm_tpu.logistic_lasso_path(X, yb, dtype=jnp.float64, **kw)
    got = admm_tpu_torch.logistic_lasso_path(X, yb, **kw, **F64)
    _assert_traces_match(got.trace, ref.trace)
    assert kernel_spy == []
    # float32 LAD and BP take the engine when traced, too.
    admm_tpu_torch.lad_fit(X, y, trace_len=8, device="cpu")
    admm_tpu_torch.bp_fit(A, b, trace_len=8, device="cpu")
    assert kernel_spy == []


def test_builders_trace_and_format_like_jax(tall):
    """``.opts(trace=...)``: True is 512 rows, an int that many (at most
    maxit), 0 a ValueError; ``fit.format_trace(i)`` prints the JAX
    package's table, row for row."""
    X, y = tall
    ref = admm_tpu.admm_lasso(X, y).penalty(nlambda=4).opts(
        path_mode="scan", rho=TALL_RHO, trace=True).fit()
    got = admm_tpu_torch.admm_lasso(X, y, device="cpu").penalty(
        nlambda=4).opts(path_mode="scan", rho=TALL_RHO, trace=True).fit()
    assert isinstance(got.trace, np.ndarray)
    assert got.trace.shape == ref.trace.shape == (4, 512, 5)
    t_ref, t_got = ref.format_trace(2), got.format_trace(2)
    lines_r, lines_g = t_ref.splitlines(), t_got.splitlines()
    assert abs(len(lines_g) - len(lines_r)) <= 1
    assert lines_g[:5] == lines_r[:5] and lines_g[-1] == lines_r[-1]
    assert [ln[:7] for ln in lines_g[5:-1]] == \
        [f"{i:<7}" for i in range(len(lines_g) - 6)]
    lad = admm_tpu_torch.admm_lad(X, y, device="cpu").opts(
        maxit=40, trace=100).fit()
    assert lad.trace.shape == (40, 5)     # clamped to maxit, as in JAX
    assert "resid_dual" in lad.format_trace()
    for pkg, kw in ((admm_tpu, {}), (admm_tpu_torch, dict(device="cpu"))):
        with pytest.raises(ValueError, match="positive int"):
            pkg.admm_lasso(X, y, **kw).opts(trace=0)
        with pytest.raises(ValueError, match="no trace recorded"):
            pkg.admm_lad(X, y, **kw).opts(maxit=5).fit().format_trace()


def test_traced_solve_and_format_trace_match_jax(tall):
    """``diag.traced_solve`` (a fixed number of body steps, frozen once
    done) against the JAX package's, on the tall Lasso's ops; and the
    table of ``format_trace`` from a buffer."""
    from admm_tpu.core.engine import make_fadmm_solver as jfadmm
    from admm_tpu.core.engine import make_state as jstate
    from admm_tpu.linalg import chol_inverse, dot, gram
    from admm_tpu.models.lasso import _tall_ops as jtall_ops
    from admm_tpu_torch.core.engine import make_fadmm_solver, make_state
    from admm_tpu_torch.models.lasso import _tall_ops

    X, y = tall
    X, y = X[:60, :10], y[:60]
    rho = 5.0
    jX, jy = jnp.asarray(X), jnp.asarray(y)
    Minv = chol_inverse(gram(jX) + rho * jnp.eye(10))
    jsolve = jfadmm(jtall_ops(Minv, dot(jX.T, jy), 1.0, 10), adapt_rho=False)
    z = jnp.zeros(10)
    jfin, jtr = jtraced_solve(partial(jsolve.body, eps_abs=1e-5,
                                      eps_rel=1e-5),
                              jstate(z, z, z, rho, 0.5), 100)
    tX, ty = torch.as_tensor(X), torch.as_tensor(y)
    tMinv = torch.as_tensor(np.array(Minv))
    solve = make_fadmm_solver(_tall_ops(tMinv, tX.mT @ ty, 1.0, 10),
                              adapt_rho=False)
    zt = torch.zeros(10, dtype=torch.float64)
    eps = torch.tensor(1e-5, dtype=torch.float64)
    fin, tr = traced_solve(lambda s: solve.body(s, eps, eps),
                           make_state(zt, zt, zt, rho, 0.5), 100)
    assert int(fin.it) == int(jfin.it)
    np.testing.assert_allclose(fin.z.numpy(), np.asarray(jfin.z), atol=1e-12)
    for f in ("eps_primal", "resid_primal", "eps_dual", "resid_dual", "rho"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jtr, f)), rtol=1e-8,
                                   atol=1e-14)
    got, ref = format_trace(tr), jformat_trace(jtr)
    assert got.splitlines()[:5] == ref.splitlines()[:5]
    assert len(got.splitlines()) == len(ref.splitlines())
    buf = np.full((8, 5), np.nan)
    buf[:3] = np.arange(15).reshape(3, 5)
    t = trace_from_buffer(torch.as_tensor(buf))
    assert t.niter == 3 and np.array_equal(t.rho, buf[:, 4], equal_nan=True)
