"""Fits completed per second: every completed call of the window over the
whole window, from its start to the end of its last call (host clock)."""


def read(ctx):
    return ctx.rate()
