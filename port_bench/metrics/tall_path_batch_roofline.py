"""Kernels: ``tall_path_batch``'s share of its roofline in the profiled segment,
in %: the least time its launches could take (``roofline/tall_path_batch.py``:
operations at 67 TFLOP/s float32 or bytes at 3.35 TB/s, whichever is
larger, from the iterations each launch returned) over their device time
in the trace."""


def read(ctx):
    return ctx.roofline_pct("tall_path_batch")
