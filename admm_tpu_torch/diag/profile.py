"""Profiler integration, and the program's own spans and counters
(counterpart of ``admm_tpu/diag/profile.py``).

The reference's only profiling hook is a wall-clock ``#if ADMM_PROFILE``
block in an uncompiled file (reference: src/TODO/ParBP.cppp:29-32).
Here :func:`trace` records a ``torch.profiler`` trace of a block, the
host's operators and, on a CUDA device, every kernel the card ran (the
hand-written ones of :mod:`admm_tpu_torch.kernels` included), with the
program's spans (below) as a host track of their own, as a
Chrome/Perfetto JSON file that ui.perfetto.dev and TensorBoard open as
it is.

Usage::

    from admm_tpu_torch.diag.profile import annotate, trace

    with trace("admm-profile"):
        with annotate("lambda-path"):     # a named region in the trace
            admm_tpu_torch.lasso_path(X, y)

**Spans.** The program marks its layers with :func:`span`: ``fit`` (an
entry point), ``validate``, ``h2d`` (inputs to the device), ``setup``
(standardization, the lambda grid, the ridge inverse or the spectral
radius; LAD's inverse Gram matrix, ``part="gram"``, and hat matrix,
``part="hat"``), ``cv_fold``, ``solve`` (a kernel launch,
``kernel=<name>``, or an engine solve, ``kernel="engine"``) and ``pack``
(the answer to the host), with :func:`span` around a block or
:func:`spanned` on a function.  Off, which is the default, a span is
one check of a module global and records nothing.  Inside
:func:`record` (or :func:`trace`) each span keeps its name, its start and
end on ``time.time_ns()`` (the clock of the profiler's Chrome trace:
``baseTimeNanoseconds + ts * 1000``), its parent, a request id and its
attributes; nothing is synced and nothing is read from the device.  The
outermost span of a call opens a new request id, unless the caller set
one with :func:`request`.

**Counters.** :func:`count` adds to host integers that are always kept
(:func:`counts`): the kernels' launches (``kernel.launches.<name>``),
the engines' host loops (``engine.iterations``, ``engine.host_reads``,
added once at a loop's end) and the iterations the solves report
(``solve.iterations``).  A count that lives on the device (a tensor of
iteration counts) is kept only while recording, as the tensor, and
summed at :func:`flush`, never where it is counted.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import pickle
import socket
import time

import torch

#: The open :class:`Recording`, or None: the one check an off span makes.
_REC = None
#: Host counters, always kept.
_COUNTS: dict = {}
#: The request id that :func:`request` set, or None.
_REQUEST = None
_NEXT_REQUEST = itertools.count(1)


class _Off:
    """The span of a program that is not recording: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class Span:
    """One recorded span: ``name``, ``attrs``, ``id`` (its index in the
    recording), ``parent`` (the id of the span it opened in, or None),
    ``request``, and ``t0``/``t1`` in ns of ``time.time_ns()``."""
    __slots__ = ("name", "attrs", "id", "parent", "request", "t0", "t1")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        rec = _REC
        stack = rec.stack
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent = None
            self.request = (_REQUEST if _REQUEST is not None
                            else next(_NEXT_REQUEST))
        self.id = len(rec.spans)
        self.t1 = None
        rec.spans.append(self)
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        stack = _REC.stack if _REC is not None else ()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, attrs={self.attrs})")


def span(name: str, **attrs):
    """A span of the program's layer ``name`` (a context manager); off
    unless a :func:`record` block is open."""
    if _REC is None:
        return _OFF
    return Span(name, attrs)


def spanned(name: str, **attrs):
    """Decorate a function: each call is a span ``name`` (off, one check
    of the module global more than the call)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_call(*args, **kwargs):
            if _REC is None:
                return fn(*args, **kwargs)
            with Span(name, dict(attrs)):
                return fn(*args, **kwargs)
        return spanned_call
    return wrap


class request:
    """Give the spans opened inside this block the request id ``k`` (a
    caller's several calls, such as ``admm_lasso(X, y)`` and its
    ``.fit()``, then share one)."""
    __slots__ = ("k", "saved")

    def __init__(self, k):
        self.k = k

    def __enter__(self):
        global _REQUEST
        self.saved, _REQUEST = _REQUEST, self.k
        return self

    def __exit__(self, *exc):
        global _REQUEST
        _REQUEST = self.saved
        return False


def _current_request():
    if _REC is not None and _REC.stack:
        return _REC.stack[-1].request
    return _REQUEST


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``: a host integer is kept always;
    a tensor (counts on the device, summed over its entries) only while
    recording, and it is summed at :func:`flush`."""
    if not isinstance(n, int):
        if _REC is not None:
            _REC.pending.append((name, _current_request(), n))
        return
    _COUNTS[name] = _COUNTS.get(name, 0) + n
    if _REC is not None:
        key = (name, _current_request())
        _REC.counts[key] = _REC.counts.get(key, 0) + n


def counts(prefix: str = "") -> dict:
    """The host counters whose names start with ``prefix``."""
    return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Set the host counters whose names start with ``prefix`` to 0."""
    for k in _COUNTS:
        if k.startswith(prefix):
            _COUNTS[k] = 0


class Recording:
    """What one :func:`record` block kept: ``spans`` (:class:`Span`, in
    the order they opened) and ``counts``, ``(counter, request) -> int``
    (device-valued counts once :func:`flush` has summed them)."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self.pending = []
        self.stack = []

    def flush(self) -> None:
        """Sum the device-valued counts into ``counts`` (one host read
        each)."""
        for name, req, t in self.pending:
            key = (name, req)
            self.counts[key] = self.counts.get(key, 0) + int(t.sum())
        self.pending = []

    def total(self, name: str, requests=None) -> int:
        """The counter ``name`` summed over ``requests`` (all if None)."""
        return sum(v for (n, r), v in self.counts.items()
                   if n == name and (requests is None or r in requests))

    def self_ns(self) -> dict:
        """Span id -> its time less its children's, in ns."""
        out = {s.id: s.t1 - s.t0 for s in self.spans}
        for s in self.spans:
            if s.parent is not None:
                out[s.parent] -= s.t1 - s.t0
        return out


@contextlib.contextmanager
def record():
    """Record the program's spans and counts inside the block; yields the
    :class:`Recording`, flushed on exit.  One recording at a time."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        rec.flush()


def flush() -> None:
    """Sum the open recording's device-valued counts now."""
    if _REC is not None:
        _REC.flush()


def _span_events(rec: Recording, base_ns: int) -> list:
    """The spans as Chrome trace ``X`` events on the trace's clock, on a
    host track of their own."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "admm_tpu_torch spans"}}]
    for s in rec.spans:
        if s.t1 is None:
            continue
        events.append({
            "ph": "X", "cat": "program", "name": s.name, "pid": pid,
            "tid": 0, "ts": (s.t0 - base_ns) / 1e3,
            "dur": (s.t1 - s.t0) / 1e3,
            "args": {"id": s.id, "parent": s.parent,
                     "request": s.request, **s.attrs}})
    return events


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False,
          device="cuda"):
    """Record a profiler trace of the enclosed block into ``logdir``, as
    ``<host>_<pid>.<ns>.pt.trace.json``: CPU activity, CUDA activity
    when ``device`` is a CUDA device, and the program's spans (recording
    is on for the block).  On exit the device is synchronized before the
    profiler stops, so the trace holds all work the block queued.
    ``create_perfetto_link`` is the JAX package's upload link: not
    available here (the JSON opens in Perfetto as it is), and it raises
    ``NotImplementedError``."""
    if create_perfetto_link:
        raise NotImplementedError(
            "create_perfetto_link is not available; open the trace JSON "
            "in ui.perfetto.dev")
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with record() as rec:
            yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}"
                            f".{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"].extend(
            _span_events(rec, int(doc.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as f:
            json.dump(doc, f)


def annotate(name: str):
    """A named region in the profiler timeline."""
    return torch.profiler.record_function(name)


def device_memory_profile(path: str, device="cuda") -> None:
    """Write the CUDA caching allocator's snapshot of ``device``
    (``torch.cuda.memory._snapshot``: its segments and blocks) to
    ``path``, pickled; ``torch.cuda.memory._dump_snapshot``'s format,
    which pytorch.org/memory_viz reads.  A CPU device has no device
    allocator to snapshot and raises ``ValueError``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_memory_profile needs a CUDA device, not "
                         f"{dev}: there is no device allocator to snapshot")
    snapshot = torch.cuda.memory._snapshot(dev)
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
