"""The end-to-end arithmetic on synthetic call times."""
import numpy as np

from port_bench.run import Context, Reservoir
from port_bench.registry import Registry

import json
from conftest import ROOT


def _calls(times, fail=()):
    t, out = 100.0, []
    for i, d in enumerate(times):
        out.append({"id": i, "t0": t, "t1": t + d, "ok": i not in fail,
                    "iterations": 10, "flops": 1e9})
        t += d
    return out


def _read(name, ctx):
    reg = Registry(json.loads((ROOT / "BENCHMARK.json").read_text()))
    return reg.module("metrics", name).read(ctx)


def test_rate_is_over_the_whole_window():
    times = [0.02] * 49 + [0.5]          # the last call ends past the close
    ctx = Context(3.0, _calls(times))
    assert np.isclose(_read("fits_per_s", ctx), 50 / sum(times))
    assert np.isclose(_read("engine_fits_per_s", ctx), 50 / sum(times))
    assert _read("setup_s", ctx) == 3.0


def test_failed_calls_are_not_completed():
    ctx = Context(1.0, _calls([0.1] * 10, fail={3, 4}))
    assert np.isclose(_read("fits_per_s", ctx), 8 / 1.0)


def test_p95_is_over_all_calls():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.01, 0.03, 400)) + [0.2] * 30
    ctx = Context(1.0, _calls(times))
    assert np.isclose(_read("fit_ms_p95", ctx),
                      np.percentile(times, 95) * 1e3)
    assert np.isclose(_read("fit_ms_p95", ctx), 200.0)


def test_traced_p95_is_the_same_arithmetic_over_the_traced_window():
    rng = np.random.default_rng(1)
    times = list(rng.uniform(0.01, 0.03, 300)) + [0.1] * 10
    ctx = Context(1.0, _calls(times))
    assert np.isclose(_read("fit_ms_p95.traced", ctx),
                      np.percentile(times, 95) * 1e3)
    assert np.isclose(_read("fit_ms_p95.traced", ctx),
                      _read("fit_ms_p95", ctx))


def test_mfu_counts_every_completed_call():
    """Over the profiled segment's length in the trace, not the window's;
    a failed call adds nothing, and a call with no count leaves it out."""
    ctx = Context(1.0, _calls([0.5, 0.5]))
    assert _read("fit_mfu", ctx) is None           # no segment was traced
    ctx.segment = {"window_s": 4.0, "busy_s": 1.0}
    ctx.segment_calls = _calls([1.0, 1.0, 1.0], fail={2})
    assert np.isclose(_read("fit_mfu", ctx), 100 * 2e9 / (4.0 * 67e12))
    assert np.isclose(_read("fit_mfu.engine", ctx), 100 * 2e9 / (4.0 * 67e12))
    ctx.segment_calls[0]["flops"] = None
    assert _read("fit_mfu", ctx) is None


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = Reservoir(4, np.random.default_rng(seed))
        for i in range(1000):
            r.offer(i)
        return sorted(r.items)
    assert draw(3) == draw(3) and draw(3) != draw(4)
    r = Reservoir(4, np.random.default_rng(0))
    for i in range(3):
        r.offer(i)
    assert r.items == [0, 1, 2]
