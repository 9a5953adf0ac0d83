"""The whole fit's share of the card's float32 peak (67 TFLOP/s), in %:
the operations of every call in the profiled segment over the segment's
length in the trace.  A call's operations are its entry's count
(``entries/<entry>.py::flops``): the set-up and every iteration that the
result reports, or, where the result reports not all of them (a CV's
folds), those that the call's kernel launches returned."""


def read(ctx):
    return ctx.mfu_pct()
