"""The port's consensus ADMM (``admm_tpu_torch.parallel.consensus``: the
13 ``parallel_*`` drivers and the builders' ``.parallel(nthread)``)
against the JAX package's, on the same seeded numpy inputs, the JAX side
on a one-device mesh (``mesh=make_mesh(1)``, the port's layout: all W
workers as a batch axis) and the port on ``device="cpu"``.

Bars: float64 coefficients and intercepts within 1e-8 and ``niter``
within 1 per lambda for every driver; the float32 tall Lasso within 1e-5
(plus rtol 1e-5) and ``niter`` within 1, the wide one within the larger
of 1e-5 and the JAX package's own float32-to-float64 gap there.  A path
resumed from the other package's state after two lambdas (``interop``)
must equal the uninterrupted one.  The host loop's two routes are held
to each other in ``tests/test_torch_engine_chunks.py``.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
import admm_tpu_torch
from admm_tpu_torch.parallel.mesh import make_mesh as torch_mesh
from admm_tpu.parallel import consensus as jcons
from admm_tpu.parallel.mesh import make_mesh
from admm_tpu_torch.interop import from_reference, to_reference
from admm_tpu_torch.parallel import consensus as tcons

from _torch_parity import assert_path_close

torch.set_num_threads(1)

F64 = dict(dtype=jnp.float64), dict(dtype=torch.float64, device="cpu")
F32 = dict(dtype=jnp.float32), dict(dtype=torch.float32, device="cpu")


def _regression(n, p, seed):
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.5)
    X = rng.normal(size=(n, p))
    return X, 2.0 + X @ b + 0.5 * rng.normal(size=n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X, y = _regression(400, 40, 0)
    Xw, yw = _regression(80, 120, 1)
    Xg = rng.normal(size=(300, 10))
    eta = 0.3 + Xg[:, :3] @ np.array([1.0, -0.8, 0.6])
    labels = (rng.uniform(size=300) < 1 / (1 + np.exp(-eta))) * 1.0
    counts = rng.poisson(np.exp(0.3 * eta)) * 1.0
    noisy = eta + 0.3 * rng.standard_t(3, size=300)
    Xc = rng.normal(size=(300, 8))
    logits = Xc[:, :2] @ np.array([[1.0, -1.0, 0.0], [0.0, 0.8, -0.8]])
    pr = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    classes = np.array([rng.choice(3, p=pi) for pi in pr])
    Xm = rng.normal(size=(200, 12))
    Ym = Xm[:, :3] @ rng.uniform(0.5, 1.5, (3, 3)) \
        + 0.5 * rng.normal(size=(200, 3))
    x0 = np.zeros(150)
    x0[rng.choice(150, 12, replace=False)] = rng.normal(size=12)
    A = rng.normal(size=(59, 150)) / np.sqrt(59)
    return dict(X=X, y=y, Xw=Xw, yw=yw, Xg=Xg, labels=labels,
                counts=counts, noisy=noisy, gw=rng.uniform(0.5, 2.0, 300),
                Xc=Xc, classes=classes, Xm=Xm, Ym=Ym, A=A, b=A @ x0,
                C=rng.normal(size=(2, 40)), d=np.array([0.5, -0.25]))


# name -> (driver name, positional data keys, keyword arguments, fields)
CASES = {
    "lasso_tall": ("parallel_lasso_path", ("X", "y"),
                   dict(nworkers=4, nlambda=6), ("coef", "beta0")),
    # 400 rows over 3 workers: the last block is zero-padded.
    "lasso_padded": ("parallel_lasso_path", ("X", "y"),
                     dict(nworkers=3, nlambda=6), ("coef", "beta0")),
    # 40-row blocks of 120 columns: the Woodbury x-update.
    "lasso_wide": ("parallel_lasso_path", ("Xw", "yw"),
                   dict(nworkers=2, nlambda=6), ("coef", "beta0")),
    "lasso_weights_user_grid": ("parallel_lasso_path", ("X", "y"),
                                dict(nworkers=4, lambdas=[0.3, 0.05, 0.01],
                                     weights="gw400", standardize=False),
                                ("coef", "beta0")),
    "enet": ("parallel_enet_path", ("X", "y"),
             dict(nworkers=4, alpha=0.6, nlambda=6), ("coef", "beta0")),
    "group": ("parallel_group_lasso_path", ("X", "y", "groups"),
              dict(nworkers=4, nlambda=6), ("coef", "beta0")),
    "sparse_group": ("parallel_group_lasso_path", ("X", "y", "groups"),
                     dict(nworkers=4, nlambda=6, l1_ratio=0.3),
                     ("coef", "beta0")),
    "slope": ("parallel_slope_path", ("X", "y"), dict(nworkers=4, nlambda=6),
              ("coef", "beta0")),
    "constrained": ("parallel_constrained_lasso_path", ("X", "y", "C", "d"),
                    dict(nworkers=4, nlambda=6), ("coef", "beta0")),
    "zerosum": ("parallel_zerosum_lasso_path", ("X", "y"),
                dict(nworkers=3, nlambda=6), ("coef", "beta0")),
    # 59 rows over 4 workers: padded rows under the jittered projection.
    "bp": ("parallel_bp_fit", ("A", "b"), dict(nworkers=4), ("coef",)),
    "glm_weighted": ("parallel_glm_lasso_path", ("Xg", "labels", "binomial"),
                     dict(nworkers=4, nlambda=5, weights="gw"),
                     ("coef", "beta0")),
    "logistic": ("parallel_logistic_lasso_path", ("Xg", "labels"),
                 dict(nworkers=4, nlambda=5), ("coef", "beta0")),
    "logistic_exact_enet": ("parallel_logistic_lasso_path", ("Xg", "labels"),
                            dict(nworkers=2, nlambda=5, hessian="exact",
                                 alpha=0.5), ("coef", "beta0")),
    "huber": ("parallel_huber_lasso_path", ("Xg", "noisy"),
              dict(nworkers=4, nlambda=5), ("coef", "beta0")),
    "poisson": ("parallel_poisson_lasso_path", ("Xg", "counts"),
                dict(nworkers=4, nlambda=5), ("coef", "beta0")),
    "multinomial": ("parallel_multinomial_lasso_path", ("Xc", "classes"),
                    dict(nworkers=4, nlambda=5), ("coef", "beta0")),
    "multinomial_grouped": ("parallel_multinomial_lasso_path",
                            ("Xc", "classes"),
                            dict(nworkers=3, nlambda=5, grouped=True),
                            ("coef", "beta0")),
    "multitask_rows": ("parallel_multitask_lasso_path", ("Xm", "Ym"),
                       dict(nworkers=2, nlambda=5), ("coef", "beta0")),
    "multitask_rows_wide_enet": ("parallel_multitask_lasso_path",
                                 ("Xm40", "Ym40"),
                                 dict(nworkers=2, nlambda=5, alpha=0.7),
                                 ("coef", "beta0")),
    "multitask_nuclear": ("parallel_multitask_lasso_path", ("Xm", "Ym"),
                          dict(nworkers=2, nlambda=5, penalty="nuclear"),
                          ("coef", "beta0")),
}


def _args(data, keys, pkg):
    out = []
    for k in keys:
        if k == "groups":
            out.append(np.arange(40) // 4)
        elif k == "binomial":
            out.append(pkg.binomial())
        elif k in ("Xm40", "Ym40"):
            out.append(data[k[:2]][:40])
        else:
            out.append(data[k])
    return out


def _kwargs(data, kw):
    kw = dict(kw)
    if kw.get("weights") == "gw":
        kw["weights"] = data["gw"]
    elif kw.get("weights") == "gw400":
        kw["weights"] = np.resize(data["gw"], 400)
    return kw


@pytest.fixture(scope="module")
def pair(data):
    """``pair(case, dtypes)``: (port result, JAX result, fields), each
    computed once per module."""
    memo = {}

    def get(case, dtypes):
        key = (case, str(dtypes[1]["dtype"]))
        if key not in memo:
            memo[key] = _run_pair(data, case, dtypes)
        return memo[key]
    return get


def _run_pair(data, case, dtypes):
    name, keys, kw, fields = CASES[case]
    kw = _kwargs(data, kw)
    jx, tx = dtypes
    ref = getattr(admm_tpu, name)(*_args(data, keys, admm_tpu),
                                  mesh=make_mesh(1), **kw, **jx)
    got = getattr(admm_tpu_torch, name)(*_args(data, keys, admm_tpu_torch),
                                        **kw, **tx)
    return got, ref, fields


@pytest.mark.parametrize("case", list(CASES))
def test_driver_matches_jax_float64(pair, case):
    got, ref, fields = pair(case, F64)
    if case == "bp":
        np.testing.assert_allclose(got.coef.numpy(), np.asarray(ref.coef),
                                   atol=1e-8)
        assert abs(int(got.niter) - int(ref.niter)) <= 1
        return
    assert_path_close(got, ref, 1e-8, fields=fields)


@pytest.mark.parametrize("case", ["lasso_tall", "lasso_wide"])
def test_lasso_float32_matches_jax(pair, case):
    """1e-5; in the wide case the larger of that and the JAX package's
    own float32-to-float64 gap on the same problem (1.7e-5 here: the
    smallest lambda's Woodbury solves round differently in float32)."""
    got, ref, fields = pair(case, F32)
    assert got.coef.dtype == torch.float32
    bar = 1e-5
    if case == "lasso_wide":
        _, ref64, _ = pair(case, F64)
        own = np.abs(np.asarray(ref.coef, np.float64)
                     - np.asarray(ref64.coef)).max()
        assert own < 5e-5
        bar = max(bar, own)
    assert_path_close(got, ref, bar, fields=fields)


@pytest.mark.parametrize("case", ["lasso", "bp"])
def test_trace_rows_match_jax(data, case):
    """Row ``min(it, trace_len - 1)`` of each lambda's NaN buffer, written
    only while the state runs; r_pri is the lagged residual."""
    if case == "lasso":
        ref = admm_tpu.parallel_lasso_path(
            data["X"], data["y"], nworkers=4, mesh=make_mesh(1), nlambda=4,
            trace_len=16, dtype=jnp.float64)
        got = admm_tpu_torch.parallel_lasso_path(
            data["X"], data["y"], nworkers=4, nlambda=4, trace_len=16,
            dtype=torch.float64, device="cpu")
        niter = got.niter.numpy()
    else:
        ref = admm_tpu.parallel_bp_fit(data["A"], data["b"], nworkers=2,
                                       mesh=make_mesh(1), trace_len=300)
        got = admm_tpu_torch.parallel_bp_fit(
            data["A"], data["b"], nworkers=2, trace_len=300,
            dtype=torch.float64, device="cpu")
        niter = got.niter.numpy()[None]
    trace, rtrace = got.trace.numpy(), np.asarray(ref.trace)
    np.testing.assert_array_equal(np.isnan(trace), np.isnan(rtrace))
    np.testing.assert_allclose(trace, rtrace, atol=1e-8, rtol=1e-7)
    recorded = (~np.isnan(trace.reshape(-1, *trace.shape[-2:])[:, :, 0])
                ).sum(axis=1)
    np.testing.assert_array_equal(recorded,
                                  np.minimum(niter, trace.shape[-2]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_from_the_other_packages_state(data, direction):
    """The state ``(x, y, z, rho)`` after lambdas 1-2 in one package,
    carried across through ``interop``, then lambdas 3-4 from ``init=``
    in the other, equal the JAX package's uninterrupted path."""
    from admm_tpu.data.standardize import standardize

    W, eps = 4, 1e-5
    Xs, ys, st = standardize(jnp.asarray(data["X"]), jnp.asarray(data["y"]),
                             standardize_x=True, intercept=True)
    ilams = jnp.asarray([0.3, 0.2, 0.1, 0.05]) * 400 / st.scale_y
    Xb, yb, _ = jcons._partition_rows(Xs, ys, W)
    jsolver = partial(jcons._consensus_lasso_shard, nworkers=W,
                      tall_block=True)
    jrun = partial(jcons._run_consensus, Xb, yb, maxit=10000, eps_abs=eps,
                   eps_rel=eps, mesh=None, axis=None, D=1, solver=jsolver)
    tsolver = tcons._consensus_lasso_solver(W, True)
    Xb_t, yb_t, il_t = (torch.from_numpy(np.array(a))
                        for a in (Xb, yb, ilams))
    trun = partial(tcons._run_consensus, Xb_t, yb_t, maxit=10000,
                   eps_abs=eps, eps_rel=eps, solver=tsolver)
    full = jrun(ilams, rho=-1.0)
    if direction == "jax_to_port":
        _, _, state = jrun(ilams[:2], rho=-1.0)
        x, y, z, rho = from_reference(tuple(state))
        coefs, niter, _, _ = trun(il_t[2:], rho=rho, init=(x, y, z))
        coefs, niter = coefs.numpy(), niter.numpy()
    else:
        _, _, state, _ = trun(il_t[:2], rho=-1.0)
        x, y, z, rho = to_reference(state, tuple)
        assert all(isinstance(a, np.ndarray) for a in (x, y, z, rho))
        coefs, niter, _ = jrun(ilams[2:], rho=rho, init=(x, y, z))
        coefs, niter = np.asarray(coefs), np.asarray(niter)
    np.testing.assert_allclose(coefs, np.asarray(full[0])[2:], atol=1e-8)
    assert np.abs(niter - np.asarray(full[1])[2:]).max() <= 1


# -- The builders' .parallel() dispatch and its errors -------------------

@pytest.mark.parametrize("builder", ["lasso", "enet", "bp"])
def test_builder_parallel_dispatches_to_consensus(data, builder,
                                                  monkeypatch):
    """``.parallel(nthread > 1).fit()`` is the consensus driver's result
    (as the JAX builders are, tests/test_api.py and
    tests/test_consensus_models.py), and ``nthread=1`` the serial one."""
    calls = []
    for name in ("parallel_lasso_path", "parallel_enet_path",
                 "parallel_bp_fit"):
        real = getattr(admm_tpu_torch.api, name)
        monkeypatch.setattr(admm_tpu_torch.api, name,
                            lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    if builder == "bp":
        make = lambda m, **kw: m.admm_bp(data["A"], data["b"], **kw)
        ref = make(admm_tpu).parallel(nthread=2).fit()
        got = make(admm_tpu_torch, device="cpu",
                   dtype=torch.float64).parallel(nthread=2).fit()
        assert calls == ["parallel_bp_fit"]
        np.testing.assert_allclose(got.beta.toarray(), ref.beta.toarray(),
                                   atol=1e-8)
        assert abs(got.niter - ref.niter) <= 1
        return
    X, y = data["X"], data["y"]
    alpha = dict(alpha=0.6) if builder == "enet" else {}
    make = lambda m, **kw: getattr(m, f"admm_{builder}")(X, y, **kw).penalty(
        nlambda=6, **alpha)
    ref = make(admm_tpu).parallel(nthread=2).fit()
    got = make(admm_tpu_torch, device="cpu").parallel(nthread=2).fit()
    assert calls == [f"parallel_{builder}_path"]
    np.testing.assert_allclose(got.lambda_, ref.lambda_, rtol=1e-6)
    np.testing.assert_allclose(got.beta.toarray(), ref.beta.toarray(),
                               atol=1e-5, rtol=1e-5)
    assert np.abs(got.niter - ref.niter).max() <= 1
    serial = make(admm_tpu_torch, device="cpu").parallel(nthread=1).fit()
    assert len(calls) == 1 and serial.beta.shape == got.beta.shape


def test_builder_consensus_trace(data):
    """``.opts(trace=...)`` rides the consensus loop (tests/test_trace.py,
    ``test_builder_trace_consensus``)."""
    fit = (admm_tpu_torch.admm_lasso(data["X"], data["y"], device="cpu")
           .penalty(nlambda=3).parallel(4).opts(trace=64).fit())
    assert fit.trace.shape == (3, 64, 5)
    nrec = int((~np.isnan(fit.trace[0, :, 0])).sum())
    assert nrec == min(int(fit.niter[0]), 64)
    assert "lambda index 0" in fit.format_trace(0)


@pytest.mark.parametrize("case", [
    "nthread_over_ncol", "penalty_factor", "enet_limits", "bp_requires_wide",
    "lad_parallel", "dantzig_parallel",
])
def test_builder_errors_as_reference(data, case):
    """The JAX builders' errors, with the same messages."""
    X, y = data["X"], data["y"]
    Xn = X[:, :16]
    calls = {
        "nthread_over_ncol": (ValueError,
                              lambda m: m.admm_lasso(Xn, y).parallel(4)),
        "penalty_factor": (NotImplementedError, lambda m: m.admm_lasso(X, y)
                           .penalty(penalty_factor=np.ones(40))
                           .parallel(2).fit()),
        "enet_limits": (NotImplementedError, lambda m: m.admm_enet(X, y)
                        .penalty(alpha=0.5, lower_limits=0.0)
                        .parallel(2).fit()),
        "bp_requires_wide": (ValueError, lambda m: m.parallel_bp_fit(
            X[:20, :10], y[:20], nworkers=2,
            **({"mesh": make_mesh(1)} if m is admm_tpu
               else {"device": "cpu"}))),
        "lad_parallel": (NotImplementedError,
                         lambda m: m.admm_lad(X, y).parallel(2)),
        "dantzig_parallel": (NotImplementedError,
                             lambda m: m.admm_dantzig(X, y).parallel(2)),
    }
    exc, call = calls[case]
    with pytest.raises(exc) as ref:
        call(admm_tpu)
    with pytest.raises(exc) as got:
        call(admm_tpu_torch)
    assert str(got.value) == str(ref.value)


def test_mesh_is_not_ported_and_default_is_one_worker(data):
    """``mesh=`` deals the workers over its positions: two per position
    on a 2-position CPU mesh give the bits of W = 4 without one
    (``tests/test_torch_mesh_cv.py`` holds it against the JAX package's
    meshes); without a mesh the default is one worker per device, so 1
    on the CPU."""
    kw = dict(nworkers=4, nlambda=3, device="cpu")
    meshed = admm_tpu_torch.parallel_lasso_path(
        data["X"], data["y"], mesh=torch_mesh(2, devices=["cpu"] * 2), **kw)
    plain = admm_tpu_torch.parallel_lasso_path(data["X"], data["y"], **kw)
    assert torch.equal(meshed.coef, plain.coef)
    assert torch.equal(meshed.niter, plain.niter)
    one = admm_tpu_torch.parallel_lasso_path(data["X"], data["y"],
                                             nlambda=3, device="cpu")
    ref = admm_tpu.parallel_lasso_path(data["X"], data["y"], nworkers=1,
                                       mesh=make_mesh(1), nlambda=3)
    assert_path_close(one, ref, 1e-5)


def test_numpy_inputs_default_to_cuda(data):
    """Entry points put numpy inputs on the card unless told otherwise."""
    import inspect

    for name in tcons.__all__:
        default = inspect.signature(getattr(tcons, name)).parameters.get(
            "device")
        assert default is None or default.default == "cuda", name
