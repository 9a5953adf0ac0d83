#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one GPU and print one JSON
line::

    python3 port_bench/run.py --workload lasso_flagship.path --seed 7 \\
        --seconds 10 --trace 0

Set-up (timed as ``setup_s``): import the port, draw the cell's pool of
problems from ``--seed`` on the card and copy it to host numpy once, and
warm up the entry point on the cell's own shapes (the first run in a
checkout builds the kernels with nvcc into ``admm_tpu_torch/_build/``).

The window is a closed loop: one caller, no think time, the pool's
problems round robin, each call handed host numpy float32 and done when
its result is on the host as numpy.  It runs for ``--seconds``; the last
call that starts in it is waited for, and the window ends with it.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1``
reports its per-layer metrics instead: the window runs with timed spans
(a device sync at each edge) around the program's layers; then, with the
spans only marked and no sync of the harness's own, a segment of whole
calls of at least two seconds runs under ``torch.profiler`` for the
device's busy time, each kernel's device time and work, the whole fit's
operations and the breakdown.

Then the check: a sample of the answers, drawn from the seed, is held to
the plain reference (``reference/``) computed from the same inputs, each
number against its limit (``limits/<cell>.json``).  The last lines on
standard error and the last key of the result name each number with its
limit.

Exits 2 with no result when there is no CUDA device (or fewer than the
cell asks for), and 3 when a JAX module is loaded once the window has
closed.

``--control tf32`` puts the plain reference, computed in TF32, in the
program's place, to see the check reject the precision below the
configuration's (the benchmark's own runs never pass it)::

    python3 port_bench/run.py --workload lasso_wide.path --seed 7 \\
        --seconds 0 --control tf32
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from port_bench import checks, devtrace, peaks  # noqa: E402
from port_bench.registry import Registry  # noqa: E402
from port_bench.spans import Launches, Spans  # noqa: E402

#: The profiled segment of a traced run lasts at least this long, in
#: whole calls.
PROFILE_S = 2.0


class Reservoir:
    """A uniform sample of k of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = int(k), rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class Context:
    """What a metric's reader reads: the calls of the window, the set-up
    time and, in a traced run, the window's spans and the profiled
    segment (its summary, its calls and its kernels' work).

    A reader that runs calls of its own (``program_spans.segment``) takes
    from here the cell's caller ``one(k)``, the device and its ``sync``,
    the entry point, the id of its first call (``next_call``, which it
    moves on) and the list its call records join (``reader_calls``: they
    count in the run's ``attempted`` and ``failed``).  Without a caller
    (``one`` None) no reader runs a call."""

    def __init__(self, setup_s, calls, one=None, sync=None, device=None,
                 entry=None, next_call=0):
        self.setup_s = setup_s
        self.calls = calls          # dicts: id, t0, t1, ok, iterations
        self.spans = None
        self.segment = {}
        self.segment_calls = []     # the same, with each answer's flops
        self.kernel_work = {}
        self.kernels = {}
        self.one = one
        self.sync = sync
        self.device = device
        self.entry = entry
        self.next_call = next_call
        self.reader_calls = []

    @property
    def window_s(self) -> float:
        return self.calls[-1]["t1"] - self.calls[0]["t0"]

    def completed(self) -> list:
        return [c for c in self.calls if c["ok"]]

    def rate(self) -> float:
        return len(self.completed()) / self.window_s

    def span_ms_per_call(self, name):
        if self.spans is None:
            return None
        ids = {c["id"] for c in self.calls}
        total = self.spans.total_s(name, ids)
        if not any(n == name for n, *_ in self.spans.records):
            return None
        return total / len(self.calls) * 1e3

    def roofline_pct(self, kernel):
        """The kernel's bound time over its device time in the profiled
        segment, in percent (None where it did not run there)."""
        mod = self.kernels.get(kernel)
        work = self.kernel_work.get(kernel)
        if mod is None or work is None or not self.segment:
            return None
        dev_s = sum(s for name, s in self.segment["kernel_s"].items()
                    if mod.DEVICE_NAME in name)
        return 100.0 * work[3] / dev_s if dev_s > 0 else None

    def idle_pct(self):
        if not self.segment:
            return None
        return 100.0 * (1.0 - self.segment["busy_s"]
                        / self.segment["window_s"])

    def mfu_pct(self):
        """The operations of the profiled segment's calls over its length
        in the trace at the float32 peak, in percent (None where a call's
        count is missing)."""
        flops = [c.get("flops") for c in self.segment_calls if c["ok"]]
        if not self.segment or not flops or None in flops:
            return None
        return 100.0 * sum(flops) / (self.segment["window_s"]
                                     * peaks.F32_FLOP_PER_S)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(reg: Registry, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float = None,
             control: str = None) -> dict:
    """One run of the cell; returns the result line as a dict.

    ``control``: a precision of the plain reference (``"tf32"``) that is
    put in the program's place at the entry point, so that the same check
    can be seen to reject it; the benchmark's own runs leave it None."""
    import torch
    import admm_tpu_torch as port
    from admm_tpu_torch import kernels as port_kernels

    t0 = time.perf_counter() if t0 is None else t0
    cell = reg.cell(name)
    cfg = reg.json("configs", cell["config"])
    mix = reg.json("traffic", cell["traffic"])
    entry = reg.module("entries", mix["entry"])
    limits = reg.limits(name)
    metrics = reg.metrics(name, trace)
    readers = {m["name"]: reg.module("metrics", m["name"]) for m in metrics}
    span_targets = {}
    for r in readers.values():
        for sname, fns in getattr(r, "SPANS", {}).items():
            span_targets.setdefault(sname, []).extend(
                tuple(f) for f in fns)
    kernel_mods = ({k: reg.module("roofline", k)
                    for k in reg.names("roofline")} if trace else {})
    kw = entry.arguments(cfg, mix)

    dev = torch.device(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    pool = reg.module("data", cfg["generator"]).make_pool(cfg, mix, seed, dev)

    if control is None:
        def one(i):
            return entry.call(port, pool.problem(i), device, **kw)
        warmup = int(mix.get("warmup_calls", 1))
    else:
        def one(i):
            return entry.reference(pool.problem(i), control, device, **kw)
        warmup = 0      # the reference builds nothing a later call reuses

    for i in range(warmup):
        one(i)
    if trace and dev.type == "cuda":
        devtrace.warm_up(sync)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    port_kernels.reset_launch_counts()
    setup_s = time.perf_counter() - t0

    sample = Reservoir(mix["check_calls"], np.random.default_rng(seed))
    errors = []

    def do_call(k, spans):
        """Call k, inside a ``call`` span where ``spans`` is given; the
        call's record and its answer (None where it raised)."""
        c0 = time.perf_counter()
        out = None
        try:
            if spans is None:
                out = one(k)
            else:
                spans.call = k
                with spans.span("call"):
                    out = one(k)
        except Exception:  # a failed call is counted, and the loop goes on
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        c1 = time.perf_counter()
        rec = {"id": k, "t0": c0, "t1": c1, "ok": out is not None,
               "iterations": 0}
        if out is not None:
            rec["iterations"] = entry.iterations(out)
            sample.offer((k, out))
        return rec, out

    # The window; in a traced run with timed spans (a sync at each edge).
    calls = []
    spans = Spans(sync) if trace else None
    k = 0
    start = time.perf_counter()
    with (spans.patch(span_targets) if spans is not None
          else contextlib.nullcontext()):
        while True:
            calls.append(do_call(k, spans)[0])
            k += 1
            if time.perf_counter() - start >= seconds:
                break

    # The profiled segment, after the timed spans are gone: the regions
    # are only marked, so what the device waits for is the program's own.
    seg = []
    segment = devtrace.Segment()
    launches = Launches()
    if trace and dev.type == "cuda":
        marks = Spans()
        with marks.patch(span_targets), launches.patch(kernel_mods), \
                segment.record(sync):
            seg0 = time.perf_counter()
            while True:
                launches.call = k
                seg.append(do_call(k, marks))
                k += 1
                if time.perf_counter() - seg0 >= PROFILE_S:
                    break
    sync()
    launch_counts = port_kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    for err in errors:
        print(err, file=sys.stderr)
    print("launches " + json.dumps(launch_counts), file=sys.stderr)

    ctx = Context(setup_s, calls, one=one, sync=sync, device=dev,
                  entry=entry, next_call=k)
    ctx.spans = spans
    if segment.events is not None:
        ops = launches.ops_by_call(kernel_mods)
        for rec, out in seg:
            if out is not None:
                rec["flops"] = entry.flops(out, cfg, kw,
                                           ops.get(rec["id"], 0.0))
        ctx.kernels = kernel_mods
        ctx.segment = segment.summary()
        ctx.segment_calls = [rec for rec, _ in seg]
        ctx.kernel_work = launches.work(kernel_mods)
    seg_calls = [rec for rec, _ in seg]
    del seg
    if seg_calls:
        # What the profiler costs a call: the segment's calls against the
        # window's (the window's carry the timed spans' syncs).
        seg_ms = (seg_calls[-1]["t1"] - seg_calls[0]["t0"]) / len(seg_calls)
        print(f"segment: {len(seg_calls)} calls, {seg_ms * 1e3:.2f} ms a "
              f"call under the profiler; window: "
              f"{ctx.window_s / len(calls) * 1e3:.2f} ms a call",
              file=sys.stderr)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # The check, once the program's state is freed.
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers = []
    for kk, out in sample.items:
        ref = entry.reference(pool.problem(kk), "float64", device, **kw)
        numbers.append(entry.compare(out, ref))
    worst = checks.worst(numbers)
    print(f"check: {len(numbers)} answers in "
          f"{time.perf_counter() - c0:.1f} s", file=sys.stderr)
    run = calls + seg_calls + ctx.reader_calls
    failed = sum(not c["ok"] for c in run)
    judged = {n: {"value": float(worst.get(n, float("inf"))),
                  "limit": float(lim)} for n, lim in limits.items()}
    correct = (failed == 0 and bool(numbers)
               and all(j["value"] <= j["limit"] for j in judged.values()))

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct),
              "attempted": len(run),
              "failed": failed, "metrics": values, "device": device_info}
    if trace and ctx.segment:
        device_info["busy_s"] = ctx.segment["busy_s"]
        device_info["window_s"] = ctx.segment["window_s"]
        result["breakdown"] = {"device_ops": ctx.segment["device_ops"],
                               "idle_gaps": ctx.segment["idle_gaps"]}
    result["checks"] = judged
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None, metavar="PRECISION",
                    help="put the plain reference in this precision in the "
                         "program's place (tf32)")
    args = ap.parse_args(argv)

    reg = Registry.from_file(ROOT / "BENCHMARK.json")
    chips = int(reg.cell(args.workload).get("chips", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0=T0,
                      control=args.control)
    found = checks.forbidden_modules()
    if found:
        print(f"JAX modules loaded: {found}: no result", file=sys.stderr)
        return 3
    for n, j in result["checks"].items():
        print(f"check {n} {j['value']:.6g} limit {j['limit']:.6g}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
