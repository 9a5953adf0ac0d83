"""The engine's graph route (``core/engine.py::_chunked``), run op by op
on the CPU: chunks of ``_CHUNK`` guarded iterations with one host read a
chunk give the coefficients, ``niter`` and rho of the loop that reads
``done`` every iteration (``_run``), to the bit, on the wide and the tall
Lasso's hooks and where ``maxit`` falls inside a chunk.  Only hooks that
declare themselves capturable take the route: ``ProblemOps.graph_safe``
is False unless set, and a row-sharded X leaves the wide hooks unsafe.
On the card the route is a CUDA graph
(``tests/test_torch_kernels_gpu.py``)."""
import numpy as np
import pytest
import torch

from admm_tpu_torch.core import engine
from admm_tpu_torch.data.standardize import standardize
from admm_tpu_torch.models import lasso
from admm_tpu_torch.parallel.mesh import make_mesh, put_dim_sharded

torch.set_num_threads(1)


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


def _wide():
    Xs, ys, ilams = _problem(40, 90, 0)
    return lambda: lasso._wide_engine(Xs, ys, ilams[0], -1.0, 1.0, False), \
        ilams


def _tall_factors():
    Xs, ys, ilams = _problem(120, 20, 1)
    pf = torch.linspace(0.2, 2.0, 20)
    pf = pf * 20 / pf.sum()
    return lambda: lasso._tall_engine(Xs, ys, ilams[0], -1.0, 0.9, pf=pf), \
        ilams


def _path(make, ilams, maxit, solve=None):
    """The scan path's final state, and each lambda's reported iterate
    with its rho appended, and niter."""
    st0, eager, report = make()
    st, out, niter, _ = lasso._scan_path(
        st0, solve or eager, lambda s: torch.cat([report(s), s.rho[None]]),
        ilams, maxit, 1e-5, 1e-5)
    return st, out, niter


@pytest.mark.parametrize("case", ["wide", "tall_factors", "maxit_in_chunk"])
def test_guarded_chunks_equal_the_op_by_op_loop(case):
    make, ilams = _tall_factors() if case == "tall_factors" else _wide()
    maxit = 3 * engine._CHUNK // 2 + 1 if case == "maxit_in_chunk" else 10000
    want_st, want, want_niter = _path(make, ilams, maxit)
    run = engine._chunked(make()[1].body)
    if case == "maxit_in_chunk":
        # The same run, first at another maxit: its static state is
        # built again for the second.
        _path(make, ilams, 10000, run)
        assert bool((want_niter == maxit).any())
        assert maxit % engine._CHUNK
    got_st, got, got_niter = _path(make, ilams, maxit, run)
    assert torch.equal(got, want)            # coefficients and rho
    assert torch.equal(got_niter, want_niter)
    for f, a, b in zip(engine.ADMMState._fields, got_st, want_st):
        assert (a is None and b is None) or torch.equal(a, b), f


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
    st0 = _wide()[0]()[0]
    assert engine._route(st0, lasso._wide_ops(Xs, ys, one, one, 1.0, 40,
                                              90)) == "eager"
