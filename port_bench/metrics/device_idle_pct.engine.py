"""Device, in an engine-bound cell: ``device_idle_pct``'s reading, kept
apart because it moves ``engine_fits_per_s``."""


def read(ctx):
    return ctx.idle_pct()
