"""Engines: the host time of ``models/lasso.py::_scan_path`` (the engine's
loop, one host read of ``done`` an iteration) over the iterations the
results report, in us (traced run, synced at each edge)."""

SPANS = {"engine": [("admm_tpu_torch.models.lasso", "_scan_path")]}


def read(ctx):
    ms = ctx.span_ms_per_call("engine")
    iters = sum(c["iterations"] for c in ctx.completed())
    if ms is None or iters == 0:
        return None
    return ms * len(ctx.calls) * 1e3 / iters
