"""The attribution of a CUDA-activity trace to the program's spans
(``program_spans.py``), on synthetic traces: each idle instant goes to
the innermost span open then, the split sums to the idle time, each
device operation goes to the span that held its launch; and a traced
run on the CPU, where no segment can run, reports none of its metrics
and raises nothing."""
import json
from types import SimpleNamespace as S

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import program_spans as ps

NEW = ("entry_idle_ms", "pack_idle_ms", "setup_idle_ms", "launches_per_fit",
       "niter_per_fit", "engine_reads_per_iter", "engine_launches_per_iter")
#: Every reader of the program's segment.
SEGMENT_READERS = NEW + ("engine_graphed_share",)


def _span(name, t0, t1):
    return S(name=name, t0=t0, t1=t1)


def test_innermost_pieces_of_nested_spans():
    fit = _span("fit", 0, 100)
    setup = _span("setup", 10, 40)
    h2d = _span("h2d", 15, 20)
    pack = _span("pack", 60, 100)
    got = [(a, b, s.name) for a, b, s in ps.innermost([pack, h2d, fit,
                                                       setup])]
    assert got == [(0, 10, "fit"), (10, 15, "setup"), (15, 20, "h2d"),
                   (20, 40, "setup"), (40, 60, "fit"), (60, 100, "pack")]


def test_idle_split_sums_to_the_idle_time_and_names_each_gap():
    spans = [_span("fit", 100, 900), _span("setup", 150, 300),
             _span("pack", 700, 880), _span("validate", 20, 90)]
    ops = [(200, 260, 160), (400, 650, 320), (660, 690, 655)]
    att = ps.attribute(spans, ops, 0, 1000)
    by = att["idle_by_name"]
    # Idle: [0, 200), [260, 400), [650, 660), [690, 1000).
    assert att["idle_ns"] == 200 + 140 + 10 + 310
    assert by == {"validate": 70, "fit": 50 + 100 + 10 + 10 + 20,
                  "setup": 50 + 40, "pack": 180, ps.OUTSIDE: 30 + 100}
    assert sum(by.values()) == att["idle_ns"]
    assert [s.name for s in att["op_spans"]] == ["setup", "fit", "fit"]


def test_random_traces_split_within_one_percent():
    rng = np.random.default_rng(3)
    for _ in range(20):
        spans, t = [], 0
        for _ in range(30):
            a = t + int(rng.integers(0, 50))
            b = a + int(rng.integers(1, 400))
            spans.append(_span("fit", a, b))
            c = a + int(rng.integers(0, b - a))
            spans.append(_span("setup", c, c + int(rng.integers(0, b - c))))
            t = b
        starts = np.sort(rng.integers(0, t, 200))
        ops = [(int(s), int(s + rng.integers(1, 60)), int(s)) for s in starts]
        att = ps.attribute(spans, ops, 0, t)
        gaps = ps.idle_intervals(ops, 0, t)
        idle = sum(b - a for a, b in gaps)
        assert abs(sum(att["idle_by_name"].values()) - idle) <= 0.01 * idle
        assert min(att["idle_by_name"].values()) >= 0


def test_device_ops_take_the_launch_of_their_correlation():
    doc = {"baseTimeNanoseconds": 1_000_000, "traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1.0, "dur": 2.0, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 4.0,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 20.0,
         "dur": 1.0, "args": {"correlation": 9}},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3.0}]}
    ops, how = ps.device_ops(doc)
    assert how == "correlation"
    assert ops == [(1_010_000.0, 1_014_000.0, 1_001_000.0),
                   (1_020_000.0, 1_021_000.0, 1_020_000.0)]
    doc["traceEvents"] = doc["traceEvents"][1:]
    ops, how = ps.device_ops(doc)
    assert how == "start" and ops[0][2] == ops[0][0]


def test_align_takes_out_a_drift_of_the_device_clock():
    """Launches every 0.1 ms over 2 s, each starting 5 us later on the
    device, or queued behind a busy device now and then; the device's
    clock agrees for 0.8 s, then runs early by up to 2.4 ms.  Aligned,
    every operation starts its 5 us (or its queueing) after its launch,
    to 25 us (the drift over half a window)."""
    rng = np.random.default_rng(0)
    launch = np.arange(0, 2e9, 1e5)
    wait = 5e3 + np.where(rng.uniform(size=launch.size) < 0.3,
                          rng.uniform(0, 5e4, launch.size), 0.0)
    drift = np.clip(launch - 0.8e9, 0, None) * 2e-3
    ops = [(t + w - e, t + w - e + 2e3, t)
           for t, w, e in zip(launch, wait, drift)]
    got = ps.align(ops)
    late = np.array([a - t for a, _, t in got])
    assert np.abs(np.array([a - t for a, _, t in ops]) - wait).max() > 2e6
    assert np.abs(late - wait).max() < 25e3
    assert [b - a for a, b, _ in got] == [b - a for a, b, _ in ops]
    assert ps.align([]) == []


def test_align_takes_out_a_device_clock_that_starts_early():
    """The device's clock 0.2 ms early from the profiler's start: aligned,
    no operation starts before its launch, and each keeps its latency."""
    launch = np.arange(0, 3e7, 1e6)
    wait = 5e3 + (launch % 3e6 == 0) * 2e4
    ops = [(t + w - 2e5, t + w - 2e5 + 1e3, t) for t, w in zip(launch, wait)]
    got = ps.align(ops)
    assert min(a - t for a, _, t in ops) < 0
    assert np.allclose([a - t for a, _, t in got], wait - wait.min())
    assert [b - a for a, b, _ in got] == [b - a for a, b, _ in ops]


def test_a_traced_cpu_run_reports_none_of_the_new_metrics(tiny_registry):
    from port_bench.run import run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]}
    assert set(NEW) <= listed
    res = run_cell(tiny_registry, "lasso_wide.fit", 11, 0.1, True, "cpu")
    assert res["correct"], res["checks"]
    assert not set(NEW) & set(res["metrics"])


def test_span_ms_counts_a_name_once_where_it_nests_in_itself():
    from admm_tpu_torch.diag import profile

    with profile.record() as rec:
        with profile.request(1):
            with profile.span("fit"):
                with profile.span("fit"):
                    with profile.span("h2d"):
                        pass
                with profile.span("h2d"):
                    pass
    seg = ps.Segment([{"id": 1, "iterations": 0}], rec, [], "start",
                     rec.spans[0].t0, rec.spans[0].t1)
    fit, inner, h2d_a, h2d_b = rec.spans
    got = seg.span_ms()
    assert got["fit"] == (fit.t1 - fit.t0) * 1e-6
    assert got["h2d"] == ((h2d_a.t1 - h2d_a.t0) + (h2d_b.t1 - h2d_b.t0)) * 1e-6
    assert seg.att["idle_by_name"][ps.OUTSIDE] == 0


def _calls(n):
    return [{"id": k, "t0": float(k), "t1": k + 0.5, "ok": True,
             "iterations": 1} for k in range(n)]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_no_segment_without_a_caller_or_a_card(device):
    """A Context without the harness's fields, or with a caller on the
    CPU: every reader of the program's segment returns None, raises
    nothing, and calls nothing."""
    from port_bench.registry import Registry
    from port_bench.run import Context

    reg = Registry(json.loads((ROOT / "BENCHMARK.json").read_text()))
    made = []
    for name in SEGMENT_READERS:
        ctx = Context(1.0, _calls(3))
        if device is not None:
            ctx = Context(1.0, _calls(3), one=made.append,
                          sync=lambda: None, device=torch.device(device),
                          entry=None, next_call=3)
        assert reg.module("metrics", name).read(ctx) is None, name
        assert ctx.program_segment is None and ctx.reader_calls == []
    assert made == []


_OWN_CALL = """
def read(ctx):
    k = ctx.next_call
    out = ctx.one(k)
    ctx.reader_calls.append({"id": k, "t0": 0.0, "t1": 0.0, "ok": False,
                             "iterations": ctx.entry.iterations(out)})
    ctx.next_call = k + 1
    return float(k)
"""


def test_a_readers_own_calls_count_in_the_run(tmp_path):
    """A reader runs a call of its own through the Context's caller, from
    the next call id; the run counts it in ``attempted``, and as failed
    where the reader says so."""
    from conftest import write_tiny
    from port_bench.registry import Registry
    from port_bench.run import run_cell

    root = write_tiny(tmp_path / "tiny")
    (root / "metrics").mkdir()
    (root / "metrics" / "own_call.py").write_text(_OWN_CALL)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"] = [{"name": "own_call", "unit": "id",
                           "better": "lower", "source": "program_span",
                           "layer": "entry points", "moves": "fits_per_s",
                           "workloads": ["lasso_flagship.path"]}]
    res = run_cell(Registry(bench, roots=[root]), "lasso_flagship.path", 13,
                   0.1, True, "cpu")
    window = res["attempted"] - 1
    assert res["metrics"]["own_call"]["value"] == window
    assert res["failed"] == 1 and not res["correct"]
