"""What the device did in a traced segment, from ``torch.profiler``.

The segment runs under the profiler (CPU and CUDA activity) inside a
region named ``pb:window``; its Chrome trace is written under the
process's temporary directory (``TMPDIR``), read back and deleted.  From
it: the window's length, the time in which a kernel, a copy or a memset
ran on the card (the union of their intervals), each kernel's device time
by name, the operations that took most time, and the longest idle gaps,
each named by the innermost ``pb:<span>`` region open on the host when
the gap began.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def warm_up(sync) -> None:
    """Start and stop the profiler once on a trivial op, so the traced
    segment does not pay for its first start."""
    with torch.profiler.profile(activities=_activities()):
        torch.ones(1, device="cuda").add_(1)
        sync()


def _activities():
    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


class Segment:
    def __init__(self):
        self.events = None

    @contextlib.contextmanager
    def record(self, sync):
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        try:
            with torch.profiler.record_function("pb:window"):
                yield self
                sync()
        finally:
            prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)

    def summary(self) -> dict:
        """``window_s``, ``busy_s``, ``kernel_s`` (name -> seconds),
        ``device_ops`` and ``idle_gaps`` (each at most 10 ``[name,
        seconds]``)."""
        evs = [e for e in self.events if e.get("ph") == "X"]
        win = [e for e in evs if e.get("name") == "pb:window"]
        if not win:
            return {}
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in evs
                     if e.get("cat") in _DEVICE_CATS)
        busy, gaps, last = 0.0, [], w0
        for a, b, _ in dev:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            if a > last:
                gaps.append((last, a))
            if b > last:
                busy += b - max(a, last)
                last = b
        if w1 > last:
            gaps.append((last, w1))
        per_op = {}
        for a, b, name in dev:
            d = min(b, w1) - max(a, w0)
            if d > 0:
                per_op[name] = per_op.get(name, 0.0) + d * 1e-6
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"][3:]) for e in evs
                 if e.get("name", "").startswith("pb:")
                 and e["name"] != "pb:window"]

        def host_at(t):
            open_ = [s for s in spans if s[0] <= t < s[1]]
            return (min(open_, key=lambda s: s[1] - s[0])[2] if open_
                    else "harness")

        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[host_at(a), (b - a) * 1e-6] for a, b in gaps[:10]]
        return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
                "kernel_s": per_op,
                "device_ops": sorted(([n, s] for n, s in per_op.items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": idle}
