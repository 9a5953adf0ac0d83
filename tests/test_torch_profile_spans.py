"""The program's spans and counters (``admm_tpu_torch.diag.profile``), on
the CPU.

Off by default: an untraced benchmark run makes no span.  Recording, the
spans nest with their parents, share a caller's request id, and their
self time is their time less their children's; counters kept on the
device are summed only at ``flush``; the engines' host loops count their
iterations and reads of device values; ``solve.iterations`` is what the
solves report; the spans' clock is the profiler's; and ``trace`` writes
the spans into the profiler's Chrome trace.  The kernels' launch counts
are views of the registry.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import admm_tpu_torch as t
from admm_tpu_torch import kernels
from admm_tpu_torch.diag import profile
from admm_tpu_torch.kernels import tall_path

torch.set_num_threads(1)


def _wide(seed=0, n=30, p=60):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    y = (X[:, :3] @ np.array([1.0, -0.8, 0.5]) + 0.1 * rng.normal(size=n))
    return X, y.astype(np.float32)


def _tall(seed=1, n=120, p=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    return X, (X[:, 0] - X[:, 2] + rng.normal(size=n)).astype(np.float32)


def test_off_by_default_an_untraced_benchmark_run_makes_no_span(
        tmp_path, monkeypatch):
    """``port_bench``'s untraced run of a tiny cell on the CPU: no
    recording opens and no span object is made."""
    from port_bench.registry import Registry
    from port_bench.run import ROOT, run_cell

    made = []
    init = profile.Span.__init__
    monkeypatch.setattr(profile.Span, "__init__",
                        lambda self, *a: (made.append(1), init(self, *a)))
    root = tmp_path / "tiny"
    for kind in ("configs", "traffic"):
        (root / kind).mkdir(parents=True)
    cfg = json.loads((ROOT / "port_bench/configs/lasso_wide.json")
                     .read_text())
    cfg.update(n=30, p=60, nonzeros=4, nlambda=5)
    (root / "configs/lasso_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "port_bench/traffic/fit.json").read_text())
    mix.update(designs=1, responses_per_design=2, check_calls=1)
    (root / "traffic/fit.json").write_text(json.dumps(mix))
    reg = Registry.from_file(ROOT / "BENCHMARK.json", roots=[root])
    assert profile._REC is None
    res = run_cell(reg, "lasso_wide.fit", 3, 0.1, False, "cpu")
    assert res["correct"] and res["attempted"] >= 1
    assert profile._REC is None and made == []
    assert profile.span("fit") is profile.span("setup", kernel="x")


def test_spans_nest_and_share_a_callers_request():
    X, y = _tall()
    with profile.record() as rec:
        with profile.request(41):
            fit = t.admm_lasso(X, y, device="cpu").fit()
        t.lasso_path(X, y, nlambda=4, device="cpu")
    spans = rec.spans
    first = [s for s in spans if s.request == 41]
    assert first[0].name == "validate" and first[0].parent is None
    top = [s for s in first if s.parent is None]
    assert [s.name for s in top] == ["validate", "fit"]
    byid = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = byid[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1 and p.request == s.request
    names = {s.name for s in first}
    assert {"fit", "validate", "h2d", "setup", "solve", "pack"} <= names
    solves = [s for s in first if s.name == "solve"]
    assert [s.attrs for s in solves] == [{"kernel": "tall_path_batch"}]
    assert rec.total("solve.iterations", {41}) == int(fit.niter.sum())
    # The second call's outermost span opened a request of its own.
    later = {s.request for s in spans if s.request != 41}
    assert len(later) == 1 and later != {41}


def test_self_time_is_the_spans_time_less_its_childrens():
    with profile.record() as rec:
        with profile.span("fit"):
            time.sleep(0.002)
            with profile.span("setup"):
                time.sleep(0.003)
                with profile.span("h2d"):
                    time.sleep(0.001)
            with profile.span("pack"):
                time.sleep(0.001)
    own = rec.self_ns()
    fit, setup, h2d, pack = rec.spans
    assert (setup.parent, h2d.parent, pack.parent) == (fit.id, setup.id,
                                                       fit.id)
    assert own[fit.id] == (fit.t1 - fit.t0) - (setup.t1 - setup.t0) \
        - (pack.t1 - pack.t0)
    assert own[setup.id] == (setup.t1 - setup.t0) - (h2d.t1 - h2d.t0)
    assert own[h2d.id] == h2d.t1 - h2d.t0
    assert own[fit.id] >= 2_000_000 and own[setup.id] >= 3_000_000


def test_device_valued_counts_are_held_until_flush():
    niter = torch.tensor([3, 4, 5], dtype=torch.int32)
    profile.count("test.device_count", niter)        # off: dropped
    with profile.record() as rec:
        with profile.request(7):
            profile.count("test.device_count", niter)
            profile.count("test.device_count", niter[:1])
            profile.count("test.host_count", 2)
        assert [p[2] for p in rec.pending] == [niter, niter[:1]]
        assert rec.pending[0][2] is niter
        assert rec.total("test.device_count") == 0
        assert rec.total("test.host_count", {7}) == 2
        profile.flush()
        assert rec.pending == [] and rec.total("test.device_count") == 15
        profile.count("test.device_count", niter)
    assert rec.total("test.device_count", {None}) == 12  # flushed at exit
    assert rec.total("test.device_count", {7}) == 15
    assert "test.device_count" not in profile.counts()
    assert profile.counts("test.")["test.host_count"] >= 2


def test_engine_reads_are_its_iterations_and_two_a_solve(monkeypatch):
    """The wide scan path's engine (one ``_run`` a lambda; sent to the
    engine, since the wide scan kernel would take it): ``it`` read once,
    ``done`` before every iteration and once more at convergence."""
    from admm_tpu_torch.models import lasso

    monkeypatch.setattr(lasso, "_use_kernel_wide_scan", lambda *a: False)
    X, y = _wide()
    before = profile.counts("engine.")
    res = t.lasso_path(X, y, nlambda=6, device="cpu")
    after = profile.counts("engine.")
    d = {k: after[k] - before.get(k, 0) for k in after}
    niter = res.niter.numpy()
    assert (niter < 10000).all()
    assert d["engine.iterations"] == int(niter.sum())
    assert d["engine.host_reads"] == d["engine.iterations"] + 2 * len(niter)


def test_batched_engine_reads_one_an_iteration_and_one_more():
    X, y = _wide(2)
    before = profile.counts("engine.")
    with profile.record() as rec:
        res = t.lasso_path(X, y, nlambda=5, path_mode="batch", device="cpu",
                           dtype=torch.float64)
    after = profile.counts("engine.")
    d = {k: after[k] - before.get(k, 0) for k in after}
    assert d["engine.iterations"] == int(res.niter.max())
    assert d["engine.host_reads"] == d["engine.iterations"] + 1
    assert rec.total("solve.iterations") == int(res.niter.sum())


@pytest.mark.parametrize("regime", ["wide", "tall"])
def test_solve_iterations_equal_the_paths_niter(regime):
    X, y = _wide() if regime == "wide" else _tall()
    with profile.record() as rec:
        res = t.lasso_path(X, y, nlambda=6, device="cpu")
    assert rec.total("solve.iterations") == int(res.niter.sum())


def test_solve_iterations_of_a_cv_are_the_full_fits_and_every_folds(
        monkeypatch):
    """Every solve of a 3-fold ``cv_lasso_path`` is a tall batch call:
    the counter equals the sum of what each call returned, the full fit's
    first."""
    X, y = _tall(3, n=150, p=12)
    seen = []
    orig = tall_path.tall_path_batch

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(int(out[1].sum()))
        return out
    monkeypatch.setattr(tall_path, "tall_path_batch", spy)
    with profile.record() as rec:
        cv = t.cv_lasso_path(X, y, nfolds=3, nlambda=8, device="cpu")
    assert len(seen) == 4 and seen[0] == int(cv.fit.niter.sum())
    assert rec.total("solve.iterations") == sum(seen)
    folds = [s for s in rec.spans if s.name == "cv_fold"]
    assert [s.attrs["fold"] for s in folds] == [0, 1, 2]


def test_span_clock_is_the_profilers(tmp_path):
    """Under a CPU-activity profiler, after one warm-up region, a program
    span and a ``record_function`` around the same block agree on
    ``baseTimeNanoseconds + ts * 1000`` to within 0.5 ms."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with profile.record() as rec:
        for name in ("warm-up", "block"):
            with torch.profiler.record_function(name):
                with profile.span(name):
                    torch.ones(64).sum()
                    time.sleep(0.003)
    prof.stop()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    (ev,) = [e for e in doc["traceEvents"]
             if e.get("name") == "block" and e.get("ph") == "X"]
    s = rec.spans[1]
    assert abs(base + ev["ts"] * 1e3 - s.t0) < 5e5
    assert abs(base + (ev["ts"] + ev["dur"]) * 1e3 - s.t1) < 5e5


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    X, y = _tall()
    with profile.trace(str(tmp_path), device="cpu"):
        t.lasso_path(X, y, nlambda=4, device="cpu")
    assert profile._REC is None
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        doc = json.load(f)
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert {e["name"] for e in ours} >= {"fit", "h2d", "setup", "solve"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ours)
    fit = next(e for e in ours if e["name"] == "fit")
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert any(fit["ts"] <= e["ts"] <= fit["ts"] + fit["dur"] for e in ops)
    with pytest.raises(RuntimeError, match="already open"):
        with profile.record():
            with profile.trace(str(tmp_path / "b"), device="cpu"):
                pass


def test_launch_counts_are_views_of_the_registry():
    for mod in (tall_path, kernels.wide_path, kernels.lad, kernels.bp,
                kernels.glm):
        assert not any(a.endswith("_launches") for a in vars(mod))
    assert not hasattr(kernels, "_COUNTERS")
    kernels.reset_launch_counts()
    profile.count("kernel.launches.lad_solve", 3)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.KERNELS, 0),
                                       "lad_solve": 3}
    kernels.reset_launch_counts()
    assert profile.counts("kernel.launches.")["kernel.launches.lad_solve"] \
        == 0
    assert not any(kernels.launch_counts().values())
