"""Spans of a traced run: timed ones sync at each edge and keep their
times; marking ones (the profiled segment's) sync nothing and keep
nothing; kernel launches are counted per call."""
import sys
import types

import numpy as np
import torch

from port_bench.spans import Launches, Spans


def test_timed_spans_sync_and_record():
    syncs = []
    sp = Spans(lambda: syncs.append(1))
    sp.call = 4
    with sp.span("call"):
        with sp.span("setup"):
            with sp.span("setup"):       # the same layer counts once
                pass
    assert len(syncs) == 4
    assert [(n, c) for n, c, *_ in sp.records] == [("setup", 4), ("call", 4)]
    assert sp.total_s("setup", {4}) >= 0.0 and sp.total_s("setup", {5}) == 0


def test_marking_spans_sync_nothing_and_keep_nothing():
    sp = Spans()
    with sp.span("call"):
        with sp.span("h2d"):
            pass
    assert sp.records == [] and sp.stack == []


class _Kernel:
    TARGET = ("_bench_fake_kernels", "launch")

    @staticmethod
    def record(args, out):
        return {"p": int(args[0]), "niter": out}

    @staticmethod
    def work(rec, lane_iterations):
        return lane_iterations * 2.0 * rec["p"] ** 2, 8.0


def _fake_launch(p, niter):
    return torch.tensor(niter)


def test_launches_are_counted_per_call(monkeypatch):
    me = types.ModuleType("_bench_fake_kernels")
    me.launch = _fake_launch
    monkeypatch.setitem(sys.modules, me.__name__, me)
    la = Launches()
    with la.patch({"fake": _Kernel}):
        la.call = 0
        me.launch(10, [3, 4])
        la.call = 1
        me.launch(10, [1])
        me.launch(20, [2])
    assert me.launch is _fake_launch              # restored
    ops = la.ops_by_call({"fake": _Kernel})
    assert np.isclose(ops[0], 7 * 200.0)
    assert np.isclose(ops[1], 200.0 + 2 * 800.0)
    n, flops, nbytes, _ = la.work({"fake": _Kernel})["fake"]
    assert (n, flops, nbytes) == (3, 7 * 200.0 + 200.0 + 1600.0, 24.0)
