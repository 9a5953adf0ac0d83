"""Device: the share of the profiled segment in which no kernel, copy or
memset ran on the card, in %."""


def read(ctx):
    return ctx.idle_pct()
