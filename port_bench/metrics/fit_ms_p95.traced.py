"""The 95th percentile of every call's wall time in a traced run's window,
numpy in to numpy out (host clock, with the timed spans' syncs), in ms:
``fit_ms_p95``'s arithmetic, read per layer where the untraced tail
spreads too widely from run to run to hold a bound."""
import numpy as np


def read(ctx):
    return float(np.percentile([c["t1"] - c["t0"] for c in ctx.calls],
                               95)) * 1e3
