"""The wide scan kernel's plain form and its route, on the CPU.

``kernels/wide_path.py::wide_path_scan_reference`` is the warm-started
wide path that ``models/lasso.py::_solve_path_wide`` computed on the
engine (``_scan_path`` over ``_wide_engine``), with its products and
squared norms summed in float64 where the engine sums in the data's
dtype.  Bars: in float64, ``niter`` within 1 per lambda and coefficients
within 2e-4, the wide path's parity bar (``tests/test_torch_lasso.py``).
In float32 the engine's float32 sums can move a lambda's stopping point
by an iteration, and the warm start carries that into the next lambda's
rho ladder.  Over the five cases on seeds 1-7 and 22 (15 lambdas, 50 x
110), the largest gap at one lambda was 16 iterations (``given_rho``,
seed 22), at most 2 lambdas of a path were more than 1 apart, and the
paths' totals at most 1.7% apart.  So float32 holds coefficients within
2e-4, each lambda's ``niter`` within 32 (twice the largest gap), at most
4 lambdas more than 1 apart (twice the most), and the total within 2%.
The route: float32 on one device, no factors, boxes or traces take the
kernel's wrapper (its plain form on the CPU, which has no shared-memory
limit; on a card, only shapes within ``wide_path.scan_fits``);
everything else keeps the engine.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import admm_tpu_torch
from admm_tpu_torch import kernels
from admm_tpu_torch.data.standardize import standardize
from admm_tpu_torch.kernels import wide_path
from admm_tpu_torch.kernels._common import row_tile
from admm_tpu_torch.models import lasso as tlasso
from admm_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _wide(n, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:6] = rng.uniform(0.5, 1.0, 6)
    return X, X @ b + 0.2 * rng.normal(size=n)


def _internal(n, p, seed, alpha, nlambda, top=1.0, dtype=torch.float32):
    """Standardized data and the internal grid: the auto grid, whose top
    is lambda0 (the all-zero exit), scaled by ``top``."""
    X, y = _wide(n, p, seed)
    f32 = dict(dtype=dtype, device="cpu")
    Xs, ys, stats = standardize(torch.as_tensor(X, **f32),
                                torch.as_tensor(y, **f32),
                                standardize_x=True, intercept=True)
    lams = tlasso._auto_lambdas(Xs, ys, stats, nlambda, 0.01, alpha,
                                alpha < 1, None, None)
    return Xs, ys, (lams * n / stats.scale_y * top).contiguous()


_CASES = {
    # name: (alpha, rho0, maxit, eps, top of the grid over lambda0)
    "lasso": (1.0, -1.0, 10000, 1e-5, 1.0),
    "enet": (0.6, -1.0, 10000, 1e-5, 1.0),
    "given_rho": (1.0, 2.0, 10000, 1e-5, 1.0),
    "above_lambda0": (1.0, -1.0, 10000, 1e-5, 1.2),
    "maxit": (1.0, -1.0, 12, 1e-7, 1.0),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(_CASES))
def test_plain_form_matches_the_engine(case, dtype):
    alpha, rho0, maxit, eps, top = _CASES[case]
    Xs, ys, ilams = _internal(50, 110, 22, alpha, 15, top, dtype)
    enet = alpha < 1
    lambda0, sprad, rho = tlasso._wide_setup(Xs, ys, ilams[0], rho0, alpha,
                                             enet)
    x, niter = wide_path.wide_path_scan_reference(
        Xs, ys, ilams, rho, sprad, lambda0, eps, eps, alpha, maxit)
    st0, solve, report = tlasso._wide_engine(Xs, ys, ilams[0], rho0, alpha,
                                             enet)
    _, x_e, n_e, _ = tlasso._scan_path(st0, solve, report, ilams, maxit,
                                       eps, eps)
    assert niter.dtype == torch.int32 and niter.shape == (15,)
    assert x.dtype == dtype
    if dtype == torch.float64:
        assert int((niter - n_e).abs().max()) <= 1
    else:
        gap = (niter - n_e).abs()
        assert int(gap.max()) <= 32 and int((gap > 1).sum()) <= 4
        assert abs(int(niter.sum()) - int(n_e.sum())) <= 0.02 * int(n_e.sum())
    np.testing.assert_allclose(x.numpy(), x_e.numpy(), atol=2e-4)
    if top > 1.0:       # every lambda above lambda0 keeps beta at 0
        above = ilams > lambda0 * (1.0 - 1e-5)
        assert bool(above[0]) and not bool(torch.any(x[above] != 0))
    if case == "maxit":
        assert bool(torch.all(niter == maxit))


def test_wrapper_runs_the_plain_form_on_cpu():
    Xs, ys, ilams = _internal(30, 70, 5, 1.0, 6)
    lambda0, sprad, rho = tlasso._wide_setup(Xs, ys, ilams[0], -1.0, 1.0,
                                             False)
    args = (Xs, ys, ilams, rho, sprad, lambda0, 1e-5, 1e-5, 1.0, 500)
    kernels.reset_launch_counts()
    a = wide_path.wide_path_scan(*args)
    b = wide_path.wide_path_scan_reference(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert kernels.launch_counts()["wide_path_scan"] == 0


def test_scan_launch_plan_at_the_main_path_shape():
    """1000 x 2000 on 132 SMs: 8 rows and 16 columns of X a block, 164576
    bytes of shared memory; p = 2944 is the widest the rule takes at
    n = 1000; every row and column has one owner."""
    plan = wide_path.scan_launch_plan(1000, 2000, 132)
    assert plan["grid"] == 132
    assert (plan["rows_max"], plan["cols_max"]) == (8, 16)
    assert (plan["ldp"], plan["ldn"]) == (2000, 1000)
    assert plan["smem_bytes"] == 164576
    assert plan["exchange_floats"] == 2000 + 3 * 1000
    assert plan["partial_doubles"] == 5 * 132
    for total, most in ((1000, 8), (2000, 16)):
        tiles = [row_tile(total, b, 132) for b in range(132)]
        assert tiles[0][0] == 0 and tiles[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        assert max(hi - lo for lo, hi in tiles) == most
    assert wide_path.scan_fits(1000, 2000, 132)
    assert wide_path.scan_fits(1000, 2944, 132)
    assert not wide_path.scan_fits(1000, 2945, 132)
    assert not wide_path.scan_fits(0, 10, 132)
    assert not wide_path.scan_fits(10, 0, 132)
    assert not wide_path.scan_fits(1000, 2000, 513)


@pytest.fixture
def scan_spy(monkeypatch):
    """Records each call of the scan kernel's wrapper and of the engine's
    path loop."""
    calls = []
    for mod, name in ((wide_path, "wide_path_scan"),
                      (tlasso, "_scan_path")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.fixture(scope="module")
def wide():
    return _wide(24, 60, 7)


def test_the_plain_wide_scan_takes_the_kernel(wide, scan_spy):
    """One wrapper call per path, for the lasso and the elastic net."""
    X, y = wide
    admm_tpu_torch.lasso_path(X, y, nlambda=4, device="cpu")
    admm_tpu_torch.enet_path(X, y, alpha=0.5, nlambda=4, device="cpu")
    assert scan_spy == ["wide_path_scan", "wide_path_scan"]


_ENGINE_ROUTES = {
    "penalty_factor": lambda p: dict(penalty_factor=np.linspace(0.5, 2, p)),
    "bounds": lambda p: dict(lower_limits=-0.5),
    "trace": lambda p: dict(trace_len=5),
    "float64": lambda p: dict(dtype=torch.float64),
    "sharded": lambda p: dict(data_mesh=make_mesh(2, devices=["cpu"] * 2)),
}


@pytest.mark.parametrize("route", list(_ENGINE_ROUTES))
def test_what_the_kernel_does_not_take_keeps_the_engine(wide, scan_spy,
                                                        route):
    X, y = wide
    admm_tpu_torch.lasso_path(X, y, nlambda=3, maxit=200, device="cpu",
                              **_ENGINE_ROUTES[route](X.shape[1]))
    assert scan_spy == ["_scan_path"]


def test_a_shape_past_scan_fits_keeps_the_engine(scan_spy, monkeypatch):
    """n = 100, p = 15121: a block's slices of X no longer fit its shared
    memory on 132 SMs, so on such a card the route keeps the engine (the
    rule read for a float32 X on ``cuda:0``, the card's SM count patched
    in).  On the CPU the plain form takes the shape: it has no shared
    memory to fit."""
    n, p = 100, 15121
    assert wide_path.scan_fits(n, p - 1, 132)
    assert not wide_path.scan_fits(n, p, 132)
    monkeypatch.setattr(tlasso, "sm_count", lambda dev: 132)
    on_card = lambda p_: SimpleNamespace(dtype=torch.float32, shape=(n, p_),
                                         device=torch.device("cuda", 0))
    assert tlasso._use_kernel_wide_scan(on_card(p - 1))
    assert not tlasso._use_kernel_wide_scan(on_card(p))
    X, y = _wide(n, p, 9)
    admm_tpu_torch.lasso_path(X, y, nlambda=2, maxit=3, device="cpu")
    assert scan_spy == ["wide_path_scan"]


# ---------------------------------------------------------------------------
# The benchmark's wide path cell sees a broken scan
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _tiny_wide_registry(root):
    """The benchmark's ``lasso_wide`` configuration at its tiny size
    (``port_bench/tests/tiny/lasso_wide.json``) and its ``path`` mix with a
    pool of 2 x 2 problems, 3 checked, found before the benchmark's own."""
    from port_bench.registry import Registry

    bench = ROOT / "port_bench"
    cfg = json.loads((bench / "configs" / "lasso_wide.json").read_text())
    cfg.update(json.loads((bench / "tests" / "tiny" / "lasso_wide.json")
                          .read_text()))
    mix = json.loads((bench / "traffic" / "path.json").read_text())
    mix.update(designs=2, responses_per_design=2, check_calls=3)
    for kind, name, body in (("configs", "lasso_wide", cfg),
                             ("traffic", "path", mix)):
        (root / kind).mkdir(parents=True, exist_ok=True)
        (root / kind / f"{name}.json").write_text(json.dumps(body))
    return Registry.from_file(ROOT / "BENCHMARK.json", roots=[root])


def _unchanged(out):
    return torch.zeros_like(out[0]), torch.zeros_like(out[1])


def _half(out):
    coef, niter = out[0].clone(), out[1].clone()
    k = coef.shape[0] // 2
    coef[k:] = coef[:coef.shape[0] - k]
    niter[k:] = niter[:niter.shape[0] - k]
    return coef, niter


def _altered(out):
    coef = out[0].clone()
    coef[-1, 0] += 1e-2
    return coef, out[1]


@pytest.mark.parametrize("fault", [None, _unchanged, _half, _altered],
                         ids=["unbroken", "state_unchanged", "half_left_out",
                              "answer_altered"])
def test_the_wide_path_cell_sees_a_broken_scan(tmp_path, monkeypatch, fault):
    """The benchmark's ``lasso_wide.path`` cell, run on the CPU at its tiny
    size, is correct as it is and not correct when the scan's answer is
    broken underneath: the start state returned, half the lambdas left
    out, one coefficient altered."""
    from port_bench.run import run_cell

    if fault is not None:
        real = wide_path.wide_path_scan_reference
        monkeypatch.setattr(wide_path, "wide_path_scan_reference",
                            lambda *a, **k: fault(real(*a, **k)))
    res = run_cell(_tiny_wide_registry(tmp_path), "lasso_wide.path",
                   2 ** 31 + 11, 0.3, False, "cpu")
    assert res["correct"] == (fault is None), res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
