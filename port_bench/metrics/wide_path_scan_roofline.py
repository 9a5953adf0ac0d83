"""Kernels: ``wide_path_scan``'s share of its roofline in the profiled
segment, in %: the least time its launches could take
(``roofline/wide_path_scan.py``: 4np operations an iteration at 67 TFLOP/s
float32, or its bytes at 3.35 TB/s, whichever is larger, from the
iterations each path returned) over the kernel's device time in the
trace.  None where the kernel did not run there (a checkout before it)."""


def read(ctx):
    return ctx.roofline_pct("wide_path_scan")
