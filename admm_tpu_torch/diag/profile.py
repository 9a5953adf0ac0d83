"""Profiler integration (counterpart of ``admm_tpu/diag/profile.py``).

The reference's only profiling hook is a wall-clock ``#if ADMM_PROFILE``
block in an uncompiled file (reference: src/TODO/ParBP.cppp:29-32).
Here :func:`trace` records a ``torch.profiler`` trace of a block, the
host's operators and, on a CUDA device, every kernel the card ran (the
hand-written ones of :mod:`admm_tpu_torch.kernels` included), as a
Chrome/Perfetto JSON file that ui.perfetto.dev and TensorBoard open as
it is.

Usage::

    from admm_tpu_torch.diag.profile import annotate, trace

    with trace("admm-profile"):
        with annotate("lambda-path"):     # a named region in the trace
            admm_tpu_torch.lasso_path(X, y)
"""
from __future__ import annotations

import contextlib
import pickle

import torch


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False,
          device="cuda"):
    """Record a profiler trace of the enclosed block into ``logdir``, as
    ``<host>_<pid>.<ns>.pt.trace.json``: CPU activity, and CUDA activity
    when ``device`` is a CUDA device.  On exit the device is synchronized
    before the profiler stops, so the trace holds all work the block
    queued.  ``create_perfetto_link`` is the JAX package's upload link:
    not available here (the JSON opens in Perfetto as it is), and it
    raises ``NotImplementedError``."""
    if create_perfetto_link:
        raise NotImplementedError(
            "create_perfetto_link is not available; open the trace JSON "
            "in ui.perfetto.dev")
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()


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
