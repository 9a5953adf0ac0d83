"""The port's LAD / quantile regression and Basis Pursuit, end to end,
against the JAX package.

The same numpy inputs go through ``admm_tpu`` and ``admm_tpu_torch``
(``device="cpu"``).  ``tests/conftest.py`` turns JAX's x64 flag on, so the
JAX side's default precision is float64 here while the port's is float32:
every comparison passes ``dtype=`` on both sides.

Bars.  float64 runs the generic engine on both sides, the same arithmetic
in the same order: coefficients within 1e-9 and equal ``niter``.  float32
runs the port's kernel route (the kernels' plain forms here: products and
norms accumulated in float64) against the JAX package's float32 engine.
For BP that is coefficients within 1e-5 and ``niter`` within max(3, 5%).
For LAD the terminal state is path-dependent near the L1 kinks, so, as in
``tests/test_pallas_kernels.py``, the bar is coefficients within 5e-3 and
the L1 (or check-loss) objective within 0.1% of the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh
from admm_tpu.models.bp import BPResult as JBPResult
from admm_tpu.models.lad import LADResult as JLADResult
from admm_tpu_torch import interop

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def lad_data():
    rng = np.random.default_rng(8)
    n, p = 300, 20
    X = rng.normal(0.3, 1.5, (n, p))
    y = 1.5 + X @ rng.normal(size=p) + rng.standard_t(2, size=n)
    return X, y


@pytest.fixture(scope="module")
def bp_data():
    rng = np.random.default_rng(12)
    n, p, m, k = 60, 160, 5, 6
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    X0 = np.zeros((m, p))
    for i in range(m):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    return A, X0 @ A.T, X0


def _check_loss(X, y, beta0, coef, tau=0.5):
    r = y - float(beta0) - X @ np.asarray(coef, np.float64)
    return float(np.sum(r * (tau - (r < 0))))


def _assert_lad_match(X, y, ref, got, dtype, tau=0.5):
    coef = got.coef.numpy()
    assert coef.shape == (X.shape[1],) and got.niter.dtype == torch.int32
    if dtype == "float64":
        np.testing.assert_allclose(coef, np.asarray(ref.coef), atol=1e-9)
        np.testing.assert_allclose(float(got.beta0), float(ref.beta0),
                                   atol=1e-9)
        assert int(got.niter) == int(ref.niter)
    else:
        np.testing.assert_allclose(coef, np.asarray(ref.coef), atol=5e-3)
        np.testing.assert_allclose(float(got.beta0), float(ref.beta0),
                                   atol=5e-3)
        assert (_check_loss(X, y, got.beta0, coef, tau)
                <= _check_loss(X, y, ref.beta0, ref.coef, tau) * 1.001)
        assert 0 < int(got.niter) < 10000


@pytest.mark.parametrize("intercept", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lad_fit_matches_reference(lad_data, dtype, intercept):
    X, y = lad_data
    jdt, tdt = DTYPES[dtype]
    ref = admm_tpu.lad_fit(X, y, intercept=intercept, dtype=jdt)
    got = admm_tpu_torch.lad_fit(X, y, intercept=intercept, dtype=tdt,
                                 device="cpu")
    assert got.coef.dtype == tdt
    _assert_lad_match(X, y, ref, got, dtype)
    if not intercept:
        assert float(got.beta0) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lad_fit_explicit_rho_and_eps_match_reference(lad_data, dtype):
    """The reference's literal defaults, rho = 1 and eps 1e-4."""
    X, y = lad_data
    jdt, tdt = DTYPES[dtype]
    kw = dict(rho=1.0, eps_abs=1e-4, eps_rel=1e-4)
    _assert_lad_match(X, y, admm_tpu.lad_fit(X, y, dtype=jdt, **kw),
                      admm_tpu_torch.lad_fit(X, y, dtype=tdt, device="cpu",
                                             **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quantile_fit_matches_reference(lad_data, dtype):
    """tau = 0.3 takes the engine on both sides in either precision; in
    float32 the two engines' sums still differ in order."""
    X, y = lad_data
    jdt, tdt = DTYPES[dtype]
    ref = admm_tpu.quantile_fit(X, y, tau=0.3, dtype=jdt)
    got = admm_tpu_torch.quantile_fit(X, y, tau=0.3, dtype=tdt, device="cpu")
    _assert_lad_match(X, y, ref, got, dtype, tau=0.3)


def test_quantile_tau_half_equals_lad(lad_data):
    X, y = lad_data
    for dtype in (torch.float32, torch.float64):
        a = admm_tpu_torch.lad_fit(X, y, dtype=dtype, device="cpu")
        b = admm_tpu_torch.quantile_fit(X, y, tau=0.5, dtype=dtype,
                                        device="cpu")
        assert torch.equal(a.coef, b.coef) and int(a.niter) == int(b.niter)


def test_quantile_fit_validates():
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(30, 3)), rng.normal(size=30)
    with pytest.raises(ValueError, match="tau"):
        admm_tpu_torch.quantile_fit(X, y, tau=1.5, device="cpu")
    with pytest.raises(ValueError, match="greater than ncol"):
        admm_tpu_torch.quantile_fit(X[:3], y[:3], tau=0.3, device="cpu")


def test_precision_rule_of_the_port(lad_data, bp_data):
    """``dtype=None`` is float32 with eps 2e-5; float64 is explicit and
    gets the reference's eps 1e-4 (a looser stop: fewer iterations than
    float64 at 2e-5)."""
    X, y = lad_data
    assert admm_tpu_torch.lad_fit(X, y, device="cpu").coef.dtype \
        == torch.float32
    loose = admm_tpu_torch.lad_fit(X, y, dtype=torch.float64, device="cpu")
    tight = admm_tpu_torch.lad_fit(X, y, dtype=torch.float64, device="cpu",
                                   eps_abs=2e-5, eps_rel=2e-5)
    assert loose.coef.dtype == torch.float64
    assert int(loose.niter) < int(tight.niter)
    A, B, _ = bp_data
    assert admm_tpu_torch.bp_fit(A, B[0], device="cpu").coef.dtype \
        == torch.float32
    assert admm_tpu_torch.bp_fit_batch(A, B, device="cpu").coef.dtype \
        == torch.float32


def _assert_bp_match(ref, got, dtype):
    coef, niter = got.coef.numpy(), np.atleast_1d(got.niter.numpy())
    n_ref = np.atleast_1d(np.asarray(ref.niter))
    assert got.niter.dtype == torch.int32
    if dtype == "float64":
        np.testing.assert_allclose(coef, np.asarray(ref.coef), atol=1e-9)
        np.testing.assert_array_equal(niter, n_ref)
    else:
        np.testing.assert_allclose(coef, np.asarray(ref.coef), atol=1e-5)
        for a, b in zip(niter, n_ref):
            assert abs(int(a) - int(b)) <= max(3, int(0.05 * int(b)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bp_fit_matches_reference(bp_data, dtype):
    A, B, X0 = bp_data
    jdt, tdt = DTYPES[dtype]
    ref = admm_tpu.bp_fit(A, B[0], dtype=jdt)
    got = admm_tpu_torch.bp_fit(A, B[0], dtype=tdt, device="cpu")
    assert got.coef.shape == (A.shape[1],) and got.niter.dim() == 0
    _assert_bp_match(ref, got, dtype)
    # eps 2e-5 in float32, 1e-4 in float64: both recover the signal.
    np.testing.assert_allclose(got.coef.numpy(), X0[0], atol=3e-3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bp_fit_explicit_rho_and_eps_match_reference(bp_data, dtype):
    A, B, X0 = bp_data
    jdt, tdt = DTYPES[dtype]
    kw = dict(rho=1.0, eps_abs=1e-6, eps_rel=1e-6, maxit=3000)
    got = admm_tpu_torch.bp_fit(A, B[1], dtype=tdt, device="cpu", **kw)
    _assert_bp_match(admm_tpu.bp_fit(A, B[1], dtype=jdt, **kw), got, dtype)
    np.testing.assert_allclose(got.coef.numpy(), X0[1], atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bp_fit_batch_matches_reference(bp_data, dtype):
    A, B, X0 = bp_data
    jdt, tdt = DTYPES[dtype]
    ref = admm_tpu.bp_fit_batch(A, B, dtype=jdt)
    got = admm_tpu_torch.bp_fit_batch(A, B, dtype=tdt, device="cpu")
    assert got.coef.shape == X0.shape and got.niter.shape == (X0.shape[0],)
    _assert_bp_match(ref, got, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bp_batch_matches_serial(bp_data, dtype):
    """m signals as lanes equal m serial solves (``niter`` within 1: the
    serial solve builds its cache ``A'(AA')^-1 b`` in another order)."""
    A, B, X0 = bp_data
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, dtype=dtype, device="cpu")
    batch = admm_tpu_torch.bp_fit_batch(A, B, **kw)
    for i in range(B.shape[0]):
        ser = admm_tpu_torch.bp_fit(A, B[i], **kw)
        np.testing.assert_allclose(batch.coef[i].numpy(), ser.coef.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(batch.coef[i].numpy(), X0[i], atol=1e-3)
        assert abs(int(batch.niter[i]) - int(ser.niter)) <= 1
    one = admm_tpu_torch.bp_fit_batch(A, B[0], **kw)      # a 1-D b is m = 1
    assert one.coef.shape == (1, A.shape[1])


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def test_lad_builder_matches_reference(lad_data):
    """The JAX builder runs float64 here (x64 is on); the port's builder
    is given ``dtype=torch.float64`` to meet it, and its float32 default
    lands within the LAD bar of that."""
    X, y = lad_data
    ref = admm_tpu.admm_lad(X, y).opts(maxit=5000).fit()
    got = admm_tpu_torch.admm_lad(X, y, device="cpu",
                                  dtype=torch.float64).opts(maxit=5000).fit()
    assert isinstance(got, admm_tpu_torch.ADMMLADFit)
    assert got.beta.shape == ref.beta.shape == (X.shape[1] + 1,)
    np.testing.assert_allclose(got.beta, ref.beta, atol=1e-9)
    assert got.niter == ref.niter and isinstance(got.niter, int)
    f32 = admm_tpu_torch.admm_lad(X, y, device="cpu").fit()
    np.testing.assert_allclose(f32.beta, ref.beta, atol=5e-3)
    noint = admm_tpu_torch.admm_lad(X, y, intercept=False, device="cpu",
                                    dtype=torch.float64).fit()
    ref0 = admm_tpu.admm_lad(X, y, intercept=False).fit()
    np.testing.assert_allclose(noint.beta, ref0.beta, atol=1e-9)
    assert noint.beta[0] == 0.0 and "niter" in repr(noint)


def test_bp_builder_matches_reference(bp_data):
    A, B, X0 = bp_data
    ref = admm_tpu.admm_bp(A, B[0]).opts(rho=2.0).fit()
    got = admm_tpu_torch.admm_bp(A, B[0], device="cpu",
                                 dtype=torch.float64).opts(rho=2.0).fit()
    assert isinstance(got, admm_tpu_torch.ADMMBPFit)
    assert got.beta.shape == ref.beta.shape == (A.shape[1], 1)
    np.testing.assert_allclose(got.beta.toarray(), ref.beta.toarray(),
                               atol=1e-9)
    assert got.niter == ref.niter
    f32 = admm_tpu_torch.admm_bp(A, B[0], device="cpu").fit()
    np.testing.assert_allclose(f32.beta.toarray()[:, 0], X0[0], atol=1e-3)
    assert admm_tpu_torch.admm_bp(A, B[0]).parallel(nthread=1).nthread == 1


def test_builder_eps_defaults_follow_dtype(bp_data, lad_data):
    A, B, _ = bp_data
    for make in (lambda **kw: admm_tpu_torch.admm_bp(A, B[0], **kw),
                 lambda **kw: admm_tpu_torch.admm_lad(*lad_data, **kw)):
        b = make()
        assert b.eps_abs == b.eps_rel == 2e-5 and b.rho is None
        b = make(dtype=torch.float64)
        assert b.eps_abs == b.eps_rel == 1e-4
        b.opts(eps_abs=1e-7)
        assert b.eps_abs == 1e-7 and b.eps_rel == 1e-4
        b.opts()                                   # opts() resets to defaults
        assert b.eps_abs == 1e-4 and "eps_abs=0.0001" in repr(b)


@pytest.mark.parametrize("case", [
    "bp_shape", "bp_nan", "bp_rows", "bp_maxit", "bp_eps_abs", "bp_eps_rel",
    "bp_rho", "bp_trace", "lad_shape", "lad_nan_y", "lad_ndim", "lad_maxit",
    "lad_eps", "lad_rho", "lad_trace",
])
def test_builders_validate_like_reference(lad_data, bp_data, case):
    """Every ``ValueError`` of the JAX builders, on both packages."""
    X, y = lad_data
    A, B, _ = bp_data
    bad = A.copy()
    bad[0, 0] = np.nan
    ybad = y.copy()
    ybad[3] = np.inf
    calls = {
        "bp_shape": lambda m: m.admm_bp(X, y),               # p <= n
        "bp_nan": lambda m: m.admm_bp(bad, B[0]),
        "bp_rows": lambda m: m.admm_bp(A, B[0][:-1]),
        "bp_maxit": lambda m: m.admm_bp(A, B[0]).opts(maxit=0),
        "bp_eps_abs": lambda m: m.admm_bp(A, B[0]).opts(eps_abs=-1.0),
        "bp_eps_rel": lambda m: m.admm_bp(A, B[0]).opts(eps_rel=-1.0),
        "bp_rho": lambda m: m.admm_bp(A, B[0]).opts(rho=0.0),
        "bp_trace": lambda m: m.admm_bp(A, B[0]).opts(trace=-2),
        "lad_shape": lambda m: m.admm_lad(A, B[0]),          # n <= p
        "lad_nan_y": lambda m: m.admm_lad(X, ybad),
        "lad_ndim": lambda m: m.admm_lad(X[:, 0], y),
        "lad_maxit": lambda m: m.admm_lad(X, y).opts(maxit=-1),
        "lad_eps": lambda m: m.admm_lad(X, y).opts(eps_rel=-1e-3),
        "lad_rho": lambda m: m.admm_lad(X, y).opts(rho=-1.0),
        "lad_trace": lambda m: m.admm_lad(X, y).opts(trace=0),
    }
    with pytest.raises(ValueError) as ref:
        calls[case](admm_tpu)
    with pytest.raises(ValueError) as got:
        calls[case](admm_tpu_torch)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("option", [
    "lad_trace_len", "lad_data_mesh", "quantile_trace_len",
    "quantile_data_mesh", "bp_trace_len", "bp_data_mesh", "bp_builder_trace",
    "bp_builder_trace_int", "bp_builder_parallel", "bp_fit_plot",
    "lad_builder_trace", "lad_fit_plot",
])
def test_options_not_ported_raise(lad_data, bp_data, option):
    """``data_mesh`` runs on a 4-position CPU mesh and agrees with the
    solve without one (its parity with the JAX package's is
    ``tests/test_torch_mesh.py``); the traced solves are ported and must
    record a trace (their parity with the JAX package is
    ``tests/test_torch_trace.py``), ``admm_bp().parallel(2)`` sets the
    consensus solver (``tests/test_torch_consensus.py``) and ``plot``
    draws (``tests/test_torch_plotting.py``)."""
    X, y = lad_data
    A, B, _ = bp_data
    t = admm_tpu_torch
    cpu = dict(device="cpu")
    mesh = make_mesh(4, devices=["cpu"] * 4)
    calls = {
        "lad_trace_len": lambda: t.lad_fit(X, y, trace_len=8, **cpu),
        "lad_data_mesh": lambda: t.lad_fit(X, y, data_mesh=mesh, **cpu),
        "quantile_trace_len": lambda: t.quantile_fit(X, y, tau=0.3,
                                                     trace_len=8, **cpu),
        "quantile_data_mesh": lambda: t.quantile_fit(
            X, y, tau=0.3, data_mesh=mesh, **cpu),
        "bp_trace_len": lambda: t.bp_fit(A, B[0], trace_len=8, **cpu),
        "bp_data_mesh": lambda: t.bp_fit(A, B[0], data_mesh=mesh, **cpu),
        "bp_builder_trace": lambda: t.admm_bp(A, B[0], **cpu).opts(
            trace=True).fit(),
        "bp_builder_trace_int": lambda: t.admm_bp(A, B[0], **cpu).opts(
            trace=16).fit(),
        "bp_builder_parallel": lambda: t.admm_bp(A, B[0]).parallel(nthread=2),
        "bp_fit_plot": lambda: t.admm_bp(A, B[0], **cpu).opts(
            maxit=5).fit().plot(),
        "lad_builder_trace": lambda: t.admm_lad(X, y, **cpu).opts(
            trace=True).fit(),
        "lad_fit_plot": lambda: t.admm_lad(X, y, **cpu).opts(
            maxit=5).fit().plot(),
    }
    if "trace" in option:
        res = calls[option]()
        rows = {"bp_builder_trace_int": 16}.get(
            option, 8 if option.endswith("trace_len") else 512)
        assert res.trace.shape == (rows, 5)
        nrec = int((~np.isnan(np.asarray(res.trace[:, 0]))).sum())
        assert nrec == min(int(res.niter), rows)
        return
    if option == "bp_builder_parallel":
        assert calls[option]().nthread == 2
        return
    if option.endswith("_plot"):
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        ax = calls[option]()
        assert ax.get_title() == {"bp_fit_plot": "Basis Pursuit solution",
                                  "lad_fit_plot": "LAD fit"}[option]
        plt.close(ax.figure)
        return
    plain = {"lad_data_mesh": lambda: t.lad_fit(X, y, **cpu),
             "quantile_data_mesh": lambda: t.quantile_fit(X, y, tau=0.3,
                                                          **cpu),
             "bp_data_mesh": lambda: t.bp_fit(A, B[0], **cpu)}[option]
    got, ref = calls[option](), plain()
    np.testing.assert_allclose(got.coef.numpy(), ref.coef.numpy(),
                               atol=5e-4 if option == "bp_data_mesh"
                               else 5e-3)


def test_lad_parallel_raises_as_in_reference(lad_data):
    X, y = lad_data
    with pytest.raises(NotImplementedError) as ref:
        admm_tpu.admm_lad(X, y).parallel()
    with pytest.raises(NotImplementedError) as got:
        admm_tpu_torch.admm_lad(X, y).parallel()
    assert str(got.value) == str(ref.value)


def test_tensor_input_stays_on_its_device(lad_data, bp_data):
    X, y = lad_data
    A, B, _ = bp_data
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    # The default device is "cuda"; tensors stay where they are.
    res = admm_tpu_torch.lad_fit(t32(X), t32(y), maxit=20)
    assert res.coef.device.type == "cpu" and res.coef.shape == (X.shape[1],)
    res = admm_tpu_torch.bp_fit_batch(t32(A), t32(B), maxit=20)
    assert res.coef.device.type == "cpu" and res.coef.shape == (5, A.shape[1])
    fit = admm_tpu_torch.admm_bp(t32(A), t32(B[0])).opts(maxit=20).fit()
    assert fit.beta.shape == (A.shape[1], 1)
    fit = admm_tpu_torch.admm_lad(t32(X), t32(y)).opts(maxit=20).fit()
    assert fit.beta.shape == (X.shape[1] + 1,)


def test_interop_round_trips_lad_and_bp_results(lad_data, bp_data):
    X, y = lad_data
    A, B, _ = bp_data
    jl = admm_tpu.lad_fit(X, y, dtype=jnp.float32, maxit=30)
    tl = interop.from_reference(jl)
    assert isinstance(tl, admm_tpu_torch.LADResult) and tl.trace is None
    assert tl.niter.dtype == torch.int32
    back = interop.to_reference(tl, JLADResult)
    assert isinstance(back, JLADResult)
    np.testing.assert_array_equal(back.coef, np.asarray(jl.coef))
    tb = admm_tpu_torch.bp_fit_batch(A, B, device="cpu", maxit=30)
    jb = interop.to_reference(tb, JBPResult)
    assert isinstance(jb, JBPResult)
    again = interop.from_reference(jb, dtype=torch.float64)
    assert isinstance(again, admm_tpu_torch.BPResult)
    assert again.coef.dtype == torch.float64
    assert again.niter.dtype == torch.int32
    np.testing.assert_array_equal(again.coef.numpy(), tb.coef.numpy())
    with pytest.raises(TypeError):
        interop.to_reference(tb, JLADResult)
