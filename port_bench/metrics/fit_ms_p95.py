"""The 95th percentile of every call's wall time in the window, numpy in
to numpy out (host clock), in ms."""
import numpy as np


def read(ctx):
    return float(np.percentile([c["t1"] - c["t0"] for c in ctx.calls],
                               95)) * 1e3
