"""Spans and kernel records of a traced run, taken from outside the
program.

:class:`Spans` puts a wrapper in place of a module's function for as long
as a ``with`` lasts (``chip_smoke.py::StageClock``'s idea); each call is
a named region (``pb:<name>``) in the profiler's timeline.  Timed spans
(the traced run's window) also run each call to a device sync on both
sides, time it on the host clock and keep ``(name, call id, start,
end)``; marking spans (the profiled segment) only name the regions, so
the device's idle time there is the program's own.  A span of a name
already open is not opened again, so a function that calls another of
the same layer counts once.  Only the traced run patches anything.

:class:`Launches` wraps a kernel's Python wrapper the same way, without a
sync, and keeps what the roofline count needs for each launch: the call
it belongs to, the shapes, and the iteration counts the launch returned
(read once the segment is over).
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch


def _swap(targets, make):
    """Patch ``module.attr`` for each ``(module name, attr, wrapper
    maker)``; returns the originals to restore."""
    saved = []
    for mod_name, attr, arg in targets:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, make(arg, fn))
    return saved


def _restore(saved):
    for mod, attr, fn in reversed(saved):
        setattr(mod, attr, fn)


class Spans:
    def __init__(self, sync=None):
        """``sync``: the device sync that a timed span runs at each edge;
        None marks the regions only."""
        self.sync = sync
        self.stack = []
        self.records = []
        self.call = None

    @contextlib.contextmanager
    def span(self, name: str):
        if name in self.stack:
            yield
            return
        sync = self.sync or (lambda: None)
        sync()
        self.stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"pb:{name}"):
                yield
                sync()
        finally:
            if self.sync is not None:
                self.records.append((name, self.call, t0,
                                     time.perf_counter()))
            self.stack.pop()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return timed

    @contextlib.contextmanager
    def patch(self, spans: dict):
        """``spans``: span name -> ``[(module, function), ...]``."""
        targets = [(mod, attr, name) for name, fns in spans.items()
                   for mod, attr in fns]
        saved = _swap(targets, self.wrap)
        try:
            yield self
        finally:
            _restore(saved)

    def total_s(self, name: str, calls=None) -> float:
        return sum(t1 - t0 for n, c, t0, t1 in self.records
                   if n == name and (calls is None or c in calls))


class Launches:
    def __init__(self):
        self.records = {}
        self.call = None

    def wrap(self, kernel, fn):
        name, mod = kernel

        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec = mod.record(args, out)
            rec["call"] = self.call
            self.records.setdefault(name, []).append(rec)
            return out
        return counted

    @contextlib.contextmanager
    def patch(self, kernels: dict):
        """``kernels``: kernel name -> its ``roofline/<kernel>.py``."""
        targets = [(mod.TARGET[0], mod.TARGET[1], (name, mod))
                   for name, mod in kernels.items()]
        saved = _swap(targets, self.wrap)
        try:
            yield self
        finally:
            _restore(saved)

    def work(self, kernels: dict) -> dict:
        """Kernel name -> (launches, operations, bytes, bound seconds
        summed over the launches)."""
        from port_bench.peaks import bound_s

        out = {}
        for name, recs in self.records.items():
            flops = nbytes = bound = 0.0
            for rec in recs:
                f, b = self._work(kernels[name], rec)
                flops, nbytes, bound = flops + f, nbytes + b, bound + bound_s(f, b)
            out[name] = (len(recs), flops, nbytes, bound)
        return out

    def ops_by_call(self, kernels: dict) -> dict:
        """Call id -> the operations of the kernel launches it made."""
        out = {}
        for name, recs in self.records.items():
            for rec in recs:
                out[rec["call"]] = (out.get(rec["call"], 0.0)
                                    + self._work(kernels[name], rec)[0])
        return out

    @staticmethod
    def _work(mod, rec):
        if "lane_iterations" not in rec:
            rec["lane_iterations"] = int(rec["niter"].sum())
        return mod.work(rec, rec["lane_iterations"])
