"""The program's own spans and counters in a traced run.

After the profiled segment of ``run.py``, the readers of the program's
spans run a second segment of whole calls, of at least
:data:`SEGMENT_S` seconds, under ``torch.profiler`` with CUDA activity
only (no CPU-activity profiling, so the host runs at its own pace), with
the program's recorder on (``admm_tpu_torch.diag.profile.record``) and
one request id a call.  Its calls count in the run's ``attempted`` and
``failed``; they are not offered to the check.

From the Chrome trace, on the clock of the program's spans
(``baseTimeNanoseconds + ts * 1000``, ns of ``time.time_ns()``):

* the card's idle time, each instant of it given to the innermost
  program span open on the host then, or to "outside" the program
  (:func:`attribute`);
* each device operation (kernel, copy, memset) given to the span that
  held its launch, the ``cuda_runtime`` event of the same correlation
  id, or, where the trace has none, the operation's own start;
* the device's times first put back on the host's clock, from which
  they drift within a run of the profiler (:func:`align`).

The segment takes the cell's caller, the device and its sync, the entry
point and the next call id from the readers' ``run.Context``, and adds
its call records to the context's ``reader_calls``.  A program without
the recorder (an older checkout), a context without a caller, or a
device other than CUDA runs no segment, and every reader of it returns
None.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time
import traceback

#: The segment lasts at least this long, in whole calls.
SEGMENT_S = 2.0
#: The name of idle time under no program span.
OUTSIDE = "outside the program"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def innermost(spans) -> list:
    """``(start, end, span)`` pieces of time, in order, in which ``span``
    is the innermost open one.  Spans (``t0``, ``t1``) nest, as those of
    one thread do; time under no span has no piece."""
    out = []
    stack = []          # [span, the start of its current piece]
    for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
        while stack and stack[-1][0].t1 <= s.t0:
            done, cur = stack.pop()
            if done.t1 > cur:
                out.append((cur, done.t1, done))
            if stack:
                stack[-1][1] = done.t1
        if stack and s.t0 > stack[-1][1]:
            out.append((stack[-1][1], s.t0, stack[-1][0]))
        stack.append([s, s.t0])
    while stack:
        done, cur = stack.pop()
        if done.t1 > cur:
            out.append((cur, done.t1, done))
        if stack:
            stack[-1][1] = done.t1
    out.sort(key=lambda p: p[0])
    return out


def idle_intervals(ops, t0, t1) -> list:
    """The ``(start, end)`` intervals of ``[t0, t1]`` in which no device
    operation (``(start, end, ...)``) ran."""
    gaps, last = [], t0
    for a, b, *_ in sorted(ops):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    return gaps


def attribute(spans, ops, t0, t1) -> dict:
    """The card's time in ``[t0, t1]`` by program span.

    ``spans``: objects with ``name``, ``t0``, ``t1`` (ns); ``ops``:
    ``(start, end, launch)`` of each device operation (ns).  Returns
    ``window_ns``, ``idle_ns`` (all idle time), ``idle_by_name`` (span
    name, or :data:`OUTSIDE` -> idle ns) and ``op_spans`` (each
    operation's span, the innermost open at its launch, or None)."""
    pieces = innermost(spans)
    gaps = idle_intervals(ops, t0, t1)
    by_name, i = {}, 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                name = pieces[j][2].name
                by_name[name] = by_name.get(name, 0) + (hi - lo)
            j += 1
    idle = sum(b - a for a, b in gaps)
    by_name[OUTSIDE] = idle - sum(by_name.values())
    starts = [p[0] for p in pieces]
    op_spans = []
    for op in ops:
        k = bisect.bisect_right(starts, op[2]) - 1
        op_spans.append(pieces[k][2] if k >= 0 and op[2] < pieces[k][1]
                        else None)
    return {"window_ns": t1 - t0, "idle_ns": idle, "idle_by_name": by_name,
            "op_spans": op_spans}


def device_ops(events) -> tuple:
    """``(ops, method)`` from a CUDA-activity Chrome trace: ``(start, end,
    launch)`` in ns of the host clock for each kernel, copy and memset,
    the launch from the ``cuda_runtime`` event of the same correlation id
    (``method`` "correlation"), or the operation's start where the trace
    has no such events ("start")."""
    base = events.get("baseTimeNanoseconds", 0)
    evs = [e for e in events["traceEvents"] if e.get("ph") == "X"]
    launch = {}
    for e in evs:
        if e.get("cat") in _RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = base + float(e["ts"]) * 1e3
    ops = []
    for e in evs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = base + float(e["ts"]) * 1e3
        b = a + float(e.get("dur", 0.0)) * 1e3
        corr = (e.get("args") or {}).get("correlation")
        ops.append((a, b, launch.get(corr, a)))
    return ops, ("correlation" if launch else "start")


def align(ops, window_ns=10e6) -> list:
    """``ops`` (``(start, end, launch)``, launches from the trace's
    correlation) with the device's times put on the host's clock.

    Within one run of the profiler the device's timestamps drift from the
    host's (on the H100: none for the first ~0.8 s, then up to 2.3 ms
    early by the end of 2 s, so operations seemed to start before their
    launch).  An operation starts after its launch; the least ``start -
    launch`` over a window of launches is the least launch latency plus
    the clock's error at that launch.  Taking the first window's as the
    latency (the profiler starts with the clocks agreeing), each later
    window's excess is its error, and every operation is shifted by the
    error interpolated at its launch.  Where the first window's least
    latency is negative (the clocks disagreed from the start), that is
    its error: no operation starts before its launch.  A window spans
    ``window_ns`` of launches, longer than a kernel that queues every
    launch behind it."""
    if not ops:
        return ops
    by_launch = sorted(ops, key=lambda op: op[2])
    when, least, group = [], [], []
    for op in by_launch:
        group.append(op)
        if op[2] - group[0][2] >= window_ns or op is by_launch[-1]:
            a, _, t = min(group, key=lambda g: g[0] - g[2])
            if not when or t > when[-1]:
                when.append(t)
                least.append(a - t)
            group = []
    error = [e - max(least[0], 0.0) for e in least]

    def at(t):
        k = bisect.bisect_left(when, t)
        if k == 0:
            return error[0]
        if k == len(when):
            return error[-1]
        t0, t1 = when[k - 1], when[k]
        return error[k - 1] + (error[k] - error[k - 1]) * (t - t0) / (t1 - t0)
    return [(a - at(t), b - at(t), t) for a, b, t in ops]


class Segment:
    """What the segment saw: its calls, the recording, the device
    operations and their attribution."""

    def __init__(self, calls, rec, ops, method, t0, t1):
        self.calls = calls
        self.rec = rec
        self.requests = {c["id"] for c in calls}
        self.spans = [s for s in rec.spans
                      if s.t1 is not None and s.request in self.requests]
        self.method = method
        self.att = attribute(self.spans, ops, t0, t1)

    @property
    def ncalls(self) -> int:
        return len(self.calls)

    def ms_per_call(self) -> float:
        return self.att["window_ns"] / self.ncalls * 1e-6

    def idle_ms(self, names) -> float:
        """Idle ms a call under the spans of these names."""
        by = self.att["idle_by_name"]
        return sum(by.get(n, 0) for n in names) / self.ncalls * 1e-6

    def count(self, name) -> int:
        return self.rec.total(name, self.requests)

    def launches(self, under=None) -> int:
        """Device operations launched in the program's spans; with
        ``under`` (a predicate), only those launched inside a span for
        which it holds, or inside one of its descendants."""
        byid = {s.id: s for s in self.rec.spans}
        memo = {}

        def inside(s):
            if s.id not in memo:
                memo[s.id] = under(s) or (s.parent is not None
                                          and inside(byid[s.parent]))
            return memo[s.id]
        return sum(1 for s in self.att["op_spans"]
                   if s is not None and (under is None or inside(s)))

    def span_ms(self) -> dict:
        """Span name -> ms a call in spans of that name, each counted
        where no span of the same name holds it."""
        byid = {s.id: s for s in self.rec.spans}
        out = {}
        for s in self.spans:
            p = s.parent
            while p is not None and byid[p].name != s.name:
                p = byid[p].parent
            if p is None:
                out[s.name] = out.get(s.name, 0) + (s.t1 - s.t0)
        return {n: v / self.ncalls * 1e-6 for n, v in out.items()}

    def report(self, window_ms) -> None:
        """The segment's lines on standard error."""
        att = self.att
        idle = att["idle_ns"] / att["window_ns"] * 100.0
        print(f"program segment (CUDA activity only, the program's spans "
              f"on): {self.ncalls} calls, {self.ms_per_call():.2f} ms a "
              f"call (window: {window_ms:.2f} ms a call), device idle "
              f"{idle:.1f}%, {att['idle_ns'] / self.ncalls * 1e-6:.3f} ms "
              f"a call, launches attributed by {self.method}; "
              f"solve.iterations {self.count('solve.iterations')}, the "
              f"results' iterations "
              f"{sum(c['iterations'] for c in self.calls)}",
              file=sys.stderr)
        split = sorted(att["idle_by_name"].items(), key=lambda kv: -kv[1])
        print("program segment idle ms a call: " + ", ".join(
            f"{n} {v / self.ncalls * 1e-6:.3f}" for n, v in split),
            file=sys.stderr)
        spans = sorted(self.span_ms().items(), key=lambda kv: -kv[1])
        print("program segment span ms a call: " + ", ".join(
            f"{n} {v:.3f}" for n, v in spans), file=sys.stderr)


def _warm_up(torch, activities, sync):
    with torch.profiler.profile(activities=activities):
        torch.ones(1, device="cuda").add_(1)
        sync()


def segment(ctx):
    """The segment of this run (run once, on the first reader's call),
    or None where it cannot run: no CUDA device, a program without the
    recorder, or no caller on ``ctx``."""
    if "program_segment" in ctx.__dict__:
        return ctx.program_segment
    ctx.program_segment = None
    try:
        from admm_tpu_torch.diag import profile
    except ImportError:
        return None
    if (ctx.one is None or getattr(profile, "record", None) is None
            or getattr(ctx.device, "type", None) != "cuda"):
        return None
    import torch

    one, sync, k = ctx.one, ctx.sync, ctx.next_call
    activities = [torch.profiler.ProfilerActivity.CUDA]
    _warm_up(torch, activities, sync)
    calls, errors = [], []
    sync()
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with profile.record() as rec:
            start = time.perf_counter()
            while True:
                c0, out = time.time_ns(), None
                try:
                    with profile.request(k):
                        out = one(k)
                except Exception:  # counted as failed, as the window's
                    if len(errors) < 3:
                        errors.append(traceback.format_exc())
                c1 = time.time_ns()
                calls.append({"id": k, "t0": c0, "t1": c1,
                              "ok": out is not None,
                              "iterations": (0 if out is None
                                             else ctx.entry.iterations(out))})
                k += 1
                if time.perf_counter() - start >= SEGMENT_S:
                    break
            sync()
    finally:
        prof.stop()
    for err in errors:
        print(err, file=sys.stderr)
    ctx.reader_calls.extend(calls)
    ctx.next_call = k
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    ops, method = device_ops(events)
    if method == "correlation":
        ops = align(ops)
    seg = Segment(calls, rec, ops, method, calls[0]["t0"], calls[-1]["t1"])
    seg.report(ctx.window_s / len(ctx.calls) * 1e3)
    ctx.program_segment = seg
    return seg
