"""``fit_mfu`` in an engine-bound cell, kept apart because it moves
``engine_fits_per_s``."""


def read(ctx):
    return ctx.mfu_pct()
