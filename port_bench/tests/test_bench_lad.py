"""The LAD cell, ``lad_reference.fit``, on the CPU at its tiny size
(``tiny/lad_reference.json``): the run through
:func:`port_bench.run.run_cell` is correct; faults planted in the LAD
route make it not correct; the TF32 control is not correct; the plain
reference loads neither the program nor JAX; the roofline's and the
entry's work reproduce hand counts at 5000 x 1000; and
``lad_hat_launches`` reads only a program that spans LAD's set-up."""
import json
import subprocess
import sys
from types import SimpleNamespace as S

import pytest
import torch

from conftest import ROOT
from port_bench import program_spans as ps
from port_bench.peaks import bound_s
from port_bench.registry import Registry
from port_bench.run import run_cell

torch.set_num_threads(2)

CELL = "lad_reference.fit"
SEED = 2 ** 31 + 13


def _reg():
    return Registry(json.loads((ROOT / "BENCHMARK.json").read_text()))


def test_unbroken_run_is_correct(tiny_registry):
    res = run_cell(tiny_registry, CELL, SEED, 0.3, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"objective_gap", "coef_gap"}
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert {"fits_per_s", "setup_s"} <= set(res["metrics"])


def _start(monkeypatch):
    """The solve returns its starting state (zero adj_y, adj_z)."""
    from admm_tpu_torch.kernels import lad as lad_kernel

    plain = lad_kernel.lad_solve_reference

    def start(*a, **k):
        adj_y, adj_z, niter = plain(*a, **k)
        return torch.zeros_like(adj_y), torch.zeros_like(adj_z), niter
    monkeypatch.setattr(lad_kernel, "lad_solve_reference", start)


def _altered(monkeypatch):
    """One coefficient of the fit moved by 1e-2."""
    from admm_tpu_torch.models import lad as lad_mod

    fit = lad_mod._lad_fit

    def altered(*a, **k):
        res = fit(*a, **k)
        coef = res.coef.clone()
        coef[0] += 1e-2
        return res._replace(coef=coef)
    monkeypatch.setattr(lad_mod, "_lad_fit", altered)


@pytest.mark.parametrize("fault", [_start, _altered],
                         ids=["state_unchanged", "answer_altered"])
def test_broken_run_is_not_correct(tiny_registry, monkeypatch, fault):
    fault(monkeypatch)
    res = run_cell(tiny_registry, CELL, SEED, 0.3, False, "cpu")
    assert not res["correct"], res["checks"]


def test_control_fails(tiny_registry):
    """The reference in TF32 in the program's place (its own tolerance,
    which TF32 cannot meet, so it runs to its last iteration)."""
    res = run_cell(tiny_registry, CELL, SEED, 0.0, False, "cpu",
                   control="tf32")
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert not res["correct"], res["checks"]
    assert [n for n, j in res["checks"].items() if j["value"] > j["limit"]]


def test_reference_loads_neither_the_program_nor_jax():
    code = ("import sys; import port_bench.reference.lad; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'admm_tpu', 'admm_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("n,p,per_iteration", [
    (5000, 1000, 2.0 * (2 * 5000 * 1000 + 1000 ** 2)),   # factored: 11e6
    (1000, 900, 2.0 * 1000 ** 2),                         # the hat: 1e6
])
def test_roofline_counts_the_cheaper_projection(n, p, per_iteration):
    mod = _reg().module("roofline", "lad_solve")
    X = torch.empty((n, p), device="meta")
    rec = mod.record((X, None), S(niter=torch.tensor(801, dtype=torch.int32)))
    assert (rec["n"], rec["p"]) == (n, p)
    flops, nbytes = mod.work(rec, 801)
    assert flops == 801 * per_iteration
    assert nbytes == 4.0 * (n * p + 3 * n + 1)


def test_roofline_bound_at_the_cell_shape():
    """801 iterations at 5000 x 1000 (the kernel table's count): 17.62
    GFLOP, 0.2630 ms at 67 TFLOP/s, bound by operations (20.06 MB of
    bytes take 6.0 us); the present design's HBM floor, H read once an
    iteration, is 23.91 ms."""
    mod = _reg().module("roofline", "lad_solve")
    flops, nbytes = mod.work({"n": 5000, "p": 1000}, 801)
    assert flops == pytest.approx(1.7622e10)
    assert nbytes == 20_060_004
    assert bound_s(flops, nbytes) * 1e3 == pytest.approx(0.26301, rel=1e-4)
    assert 4.0 * 5000 ** 2 * 801 / 3.35e12 * 1e3 == pytest.approx(23.91,
                                                                  rel=1e-3)


def test_entry_counts_the_problems_work():
    reg = _reg()
    entry = reg.module("entries", "admm_lad_fit")
    cfg = reg.json("configs", "lad_reference")
    kw = entry.arguments(cfg, reg.json("traffic", "lad_fit"))
    assert kw == {"rho": 5.0, "eps_abs": 2e-5,
                  "eps_rel": 2e-5, "maxit": 10000}
    n, p = 5000, 1000
    want = (2.0 * n * p * p + p ** 3 + 801 * 2.0 * (2 * n * p + p * p)
            + 2.0 * n * p + 2.0 * p * p)
    assert entry.flops({"niter": 801}, cfg, kw, 0.0) == want


def _segment(spans):
    """A program segment of one call whose spans are ``(name, attrs,
    parent)`` and whose device operations were each launched inside the
    span of the same index."""
    recs = [S(name=name, attrs=attrs, id=i, parent=parent, request=7,
              t0=10 * i, t1=10 * i + 5) for i, (name, attrs, parent)
            in enumerate(spans)]
    recs[0].t1 = 10 * len(recs)
    rec = S(spans=recs, counts={})
    ops = [(s.t0 + 1, s.t0 + 2, s.t0 + 1) for s in recs]
    return ps.Segment([{"id": 7}], rec, ops, "correlation", 0,
                      10 * len(recs))


@pytest.mark.parametrize("spans,want", [
    ([("fit", {}, None), ("setup", {"part": "gram"}, 0),
      ("setup", {}, 1), ("setup", {"part": "hat"}, 0),
      ("solve", {"kernel": "lad_solve"}, 0)], 1.0),
    ([("fit", {}, None), ("setup", {"part": "gram"}, 0),
      ("solve", {"kernel": "lad_solve"}, 0)], 0.0),     # no hat matrix
    ([("fit", {}, None), ("setup", {}, 0),
      ("solve", {"kernel": "lad_solve"}, 0)], None),    # no LAD set-up span
    (None, None),                                       # no segment ran
])
def test_hat_launches_read_the_hat_span(spans, want):
    ctx = S(program_segment=spans and _segment(spans))
    assert _reg().module("metrics", "lad_hat_launches").read(ctx) == want


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LAD kernel runs only on the "
                    "card")
    return _reg()


def test_traced_run_on_the_card_reports_the_lad_metrics(card):
    res = run_cell(card, CELL, 2 ** 31 + 17, 1.0, True, "cuda")
    assert res["correct"], res["checks"]
    layer = {m["name"] for m in card.metrics(CELL, trace=True)}
    assert layer <= set(res["metrics"])
    assert res["metrics"]["lad_hat_launches"]["value"] > 0
    assert 0 < res["metrics"]["lad_solve_roofline"]["value"] < 100
