"""On the card: the program's spans against a CUDA-activity trace.

A span around a 5 ms host sleep between two kernels takes the idle gap
between them, and a traced run of a cell reports every metric that
reads the program's spans there.  Skips without a CUDA device (decided
in the fixture)::

    python -m pytest port_bench/tests/test_bench_program_spans_gpu.py -q
"""
import json
import os
import tempfile
import time

import pytest
import torch

from conftest import ROOT
from port_bench import program_spans as ps


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace holds CUDA activity")
    return torch.device("cuda")


def _cuda_trace(block):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        out = block()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, json.load(f)
    finally:
        os.remove(path)


def test_a_span_round_a_host_sleep_takes_the_idle_gap(cuda):
    """No sync between the two kernels, and a profiler run whose first
    launches (slow under the profiler: 0.7 ms once) are made: the gap is
    the sleep's, and after the alignment the device's clock puts each
    kernel after its launch."""
    from admm_tpu_torch.diag import profile

    a = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()

    def block():
        with profile.record() as rec:
            for _ in range(3):
                a.mul_(1.0)
                torch.cuda.synchronize()
            t0 = time.time_ns()
            with profile.span("fit"):
                a.mul_(2.0)
                with profile.span("setup"):
                    time.sleep(0.005)
                a.add_(1.0)
            torch.cuda.synchronize()
            t1 = time.time_ns()
        return rec, t0, t1

    (rec, t0, t1), doc = _cuda_trace(block)
    ops, how = ps.device_ops(doc)
    assert how == "correlation"
    ops = sorted(op for op in ps.align(ops) if t0 <= op[2] <= t1)
    fit, setup = rec.spans
    where = dict(ops=[tuple(x - t0 for x in op) for op in ops],
                 fit=(fit.t0 - t0, fit.t1 - t0),
                 setup=(setup.t0 - t0, setup.t1 - t0))
    assert len(ops) == 2, where
    assert all(0 <= a - t < 1e6 for a, _, t in ops), where
    gap = ops[1][0] - ops[0][1]
    assert gap >= 5e6, where
    att = ps.attribute(rec.spans, ops, ops[0][1], ops[1][0])
    assert att["idle_by_name"].get("setup", 0) >= 0.9 * gap, (att, where)
    assert [s.name for s in att["op_spans"]] == ["fit", "fit"], where


def test_a_traced_run_reports_the_program_span_metrics(cuda):
    from port_bench.registry import Registry
    from port_bench.run import run_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    reg = Registry(bench)
    cell = "lasso_wide.fit"
    res = run_cell(reg, cell, 2 ** 31 + 5, 0.5, True, "cuda")
    assert res["correct"], res["checks"]
    want = {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert want <= set(res["metrics"]), want - set(res["metrics"])
    for name in ("entry_idle_ms", "pack_idle_ms", "setup_idle_ms",
                 "launches_per_fit", "niter_per_fit"):
        assert res["metrics"][name]["value"] > 0, name


def test_the_segment_takes_its_caller_from_the_context(cuda):
    """``program_spans.segment`` runs the Context's caller from its next
    call id under one request id a call, adds the records to
    ``reader_calls`` with the entry's iterations, and moves the id on."""
    from types import SimpleNamespace

    import numpy as np

    import admm_tpu_torch as port
    from port_bench.run import Context

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 20)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=200)).astype(np.float32)
    ids = []

    def one(k):
        ids.append(k)
        return port.lasso_path(X, y, nlambda=5, device="cuda")

    ctx = Context(1.0, [{"id": 0, "t0": 0.0, "t1": 1.0, "ok": True,
                         "iterations": 0}], one=one,
                  sync=lambda: torch.cuda.synchronize(cuda), device=cuda,
                  entry=SimpleNamespace(iterations=lambda out: 7),
                  next_call=1000)
    seg = ps.segment(ctx)
    assert seg is not None and ps.segment(ctx) is seg
    assert ids == list(range(1000, 1000 + len(ids))) and ids
    assert [c["id"] for c in ctx.reader_calls] == ids
    assert all(c["ok"] and c["iterations"] == 7 for c in ctx.reader_calls)
    assert ctx.next_call == 1000 + len(ids)
    assert seg.requests == set(ids) and seg.spans
    assert {s.request for s in seg.spans} <= set(ids)
