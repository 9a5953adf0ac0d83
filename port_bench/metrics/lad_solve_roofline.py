"""Kernels: ``lad_solve``'s share of its roofline in the profiled segment,
in %: the least time its launches could take (``roofline/lad_solve.py``:
the problem's operations, 2 min(n^2, 2np + p^2) an iteration, at 67
TFLOP/s float32, or its bytes at 3.35 TB/s, whichever is larger, from the
iterations each fit returned) over the kernel's device time in the
trace."""


def read(ctx):
    return ctx.roofline_pct("lad_solve")
