"""The engine's one host loop (``core/engine.py::_host_loop``): its graph
route, groups of ``_CHUNK`` guarded iterations with one host read a
group, run op by op on the CPU without capture, gives the coefficients,
``niter``, rho and trace rows of its op-by-op route (one host read an
iteration), to the bit, for every caller: a single solve on the wide and
the tall Lasso's hooks, a traced one, batched lanes, traced lanes,
lanes that enter out of step, a returned state passed back in,
consensus, and where ``maxit`` falls inside a group.  Only hooks that declare themselves capturable take the
route (``_route``): ``ProblemOps.graph_safe`` is False unless set, and a
row-sharded X leaves the wide hooks unsafe.  On the card the route is a CUDA graph
(``tests/test_torch_kernels_gpu.py``)."""
import numpy as np
import pytest
import torch

import admm_tpu_torch
from admm_tpu_torch.core import engine
from admm_tpu_torch.data.standardize import standardize
from admm_tpu_torch.models import lasso
from admm_tpu_torch.parallel.mesh import make_mesh, put_dim_sharded

torch.set_num_threads(1)

GROUP_MAXIT = 3 * engine._CHUNK // 2 + 1    # ends inside a group


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    y = X[:, :6] @ rng.uniform(-1, 1, 6) + 0.5 * rng.normal(size=n)
    f32 = dict(dtype=torch.float32)
    Xs, ys = standardize(torch.as_tensor(X, **f32), torch.as_tensor(y, **f32),
                         standardize_x=True, intercept=True)[:2]
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0, lam0 * 1e-2, 12),
                         dtype=torch.float32)
    return Xs, ys, ilams


def _factors(p):
    pf = torch.linspace(0.2, 2.0, p)
    return pf * p / pf.sum()


def _scan(regime, maxit, trace_len=None):
    """A scan path on the engine: the final state's fields, each lambda's
    reported iterate with its rho appended, niter and the traces."""
    if regime == "wide":
        Xs, ys, ilams = _problem(40, 90, 0)
        st0, solve, report = lasso._wide_engine(Xs, ys, ilams[0], -1.0, 1.0,
                                                False)
    else:
        Xs, ys, ilams = _problem(120, 20, 1)
        st0, solve, report = lasso._tall_engine(Xs, ys, ilams[0], -1.0, 0.9,
                                                pf=_factors(20))
    if maxit != 10000:
        # The same solve first at another maxit: its static state is
        # built again for the second.
        lasso._scan_path(st0, solve, report, ilams, 10000, 1e-5, 1e-5)
    st, out, niter, traces = lasso._scan_path(
        st0, solve, lambda s: torch.cat([report(s), s.rho[None]]), ilams,
        maxit, 1e-5, 1e-5, trace_len)
    return [*st, out, niter, traces]


def _batch(regime, maxit, trace_len=None):
    """The batch path's lanes on the engine (penalty factors keep it off
    the kernels): coefficients, niter, traces."""
    if regime == "wide":
        Xs, ys, ilams = _problem(40, 90, 0)
        return list(lasso._solve_path_wide_batch(
            Xs, ys, ilams, -1.0, maxit, 1e-5, 1e-5, 1.0, False, trace_len,
            _factors(90)))
    Xs, ys, ilams = _problem(120, 20, 1)
    return list(lasso._solve_path_tall_batch(
        Xs, ys, ilams, -1.0, maxit, 1e-5, 1e-5, 0.9, trace_len,
        _factors(20)))


def _lanes_out_of_step():
    """Lanes that enter at different ``it`` (as the square-root lasso's
    re-armed lanes do): a lane at ``maxit`` that is not done steps on
    while another lane runs, as in the JAX package's batched loop."""
    Xs, ys, ilams = _problem(40, 90, 0)
    st0, solve, _ = lasso._wide_engine(Xs, ys, ilams[0], -1.0, 1.0, False)
    k = ilams.shape[0]
    st = engine.ADMMState(*(None if a is None else
                            a.expand((k,) + a.shape).clone() for a in st0))
    it0 = 3 * torch.arange(k, dtype=torch.int32)
    st = st._replace(lam=ilams.clone(), it=it0)
    st = engine.make_batched_solver(solve)(st, GROUP_MAXIT, 1e-5, 1e-5)
    return [st.x, st.rho, st.it - it0]


def _reentered():
    """A returned state passed back in, as it is and after out-of-place
    changes (``_replace``): the graph route copies in only what is not
    the last call's answer, so the changed fields must reach it."""
    Xs, ys, ilams = _problem(40, 90, 0)
    st0, solve, _ = lasso._wide_engine(Xs, ys, ilams[0], -1.0, 1.0, False)
    run = lambda st: solve(st, GROUP_MAXIT, 1e-5, 1e-5)
    zero = torch.zeros_like(st0.it)
    st1 = run(st0)
    st2 = run(st1._replace(it=zero))
    st3 = run(st2._replace(x=st2.x * 0.5, rho=st2.rho * 2.0, it=zero))
    return [*st1, *st2, *st3, st3.it, st3.rho]


def _consensus(maxit):
    X, y = _problem(80, 120, 1)[:2]
    res = admm_tpu_torch.parallel_lasso_path(
        X, y, nworkers=2, nlambda=5, trace_len=40, maxit=maxit,
        device="cpu")
    return [res.coef, res.beta0, res.niter, res.trace]


CASES = {
    "wide": lambda: _scan("wide", 10000),
    "tall_factors": lambda: _scan("tall", 10000),
    "maxit_in_chunk": lambda: _scan("wide", GROUP_MAXIT),
    "single_traced": lambda: _scan("wide", 10000, trace_len=25),
    "batched": lambda: _batch("tall", 10000),
    "batched_traced": lambda: _batch("wide", 10000, trace_len=25),
    "batched_maxit_in_chunk": lambda: _batch("wide", GROUP_MAXIT,
                                             trace_len=4),
    "lanes_out_of_step": _lanes_out_of_step,
    "reentered_maxit_in_chunk": _reentered,
    "consensus": lambda: _consensus(10000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_guarded_chunks_equal_the_op_by_op_loop(case, monkeypatch):
    want = CASES[case]()
    monkeypatch.setattr(engine, "_route", lambda *a: "graph")
    got = CASES[case]()
    niter = want[-2]
    if case == "lanes_out_of_step":
        # Every lane took the first lane's GROUP_MAXIT steps, those that
        # entered at or past maxit too.
        assert bool((want[-1] == GROUP_MAXIT).all())
    elif "maxit" in case:
        assert bool((niter == GROUP_MAXIT).any())
        assert GROUP_MAXIT % engine._CHUNK
    else:
        assert bool((niter < 10000).all())
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, i
        else:           # NaN rows of a trace compare as equal
            assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                               torch.nan_to_num(b, nan=-1.0)), i


def test_only_declared_and_unsharded_hooks_are_graph_safe():
    f = lambda *a: None
    assert not engine.ProblemOps(f, f, f, f, f, f, None, 3, 2).graph_safe
    Xs, ys, ilams = _problem(40, 90, 0)
    one = torch.ones(())
    assert lasso._wide_ops(Xs, ys, one, one, 1.0, 40, 90).graph_safe
    assert lasso._tall_ops(torch.eye(4), torch.ones(4), 1.0, 4).graph_safe
    mesh = make_mesh(2, devices=["cpu"] * 2)
    Xsh = put_dim_sharded(Xs, mesh, 0)
    assert not lasso._wide_ops(Xsh, ys, one, one, 1.0, 40, 90).graph_safe
    # On the CPU the route is the op-by-op loop whatever the hooks say.
    st0, solve, _ = lasso._wide_engine(Xs, ys, ilams[0], -1.0, 1.0, False)
    assert solve.graph_safe
    assert engine._route(st0.rho.device, solve.graph_safe) == "eager"
    assert engine._route("cuda:0", solve.graph_safe) == "graph"
    assert engine._route("cuda:0", False) == "eager"
