"""Fits completed per second of an engine-bound cell (the host loop of
``core/engine.py`` does the work): the arithmetic of ``fits_per_s``, kept
apart so that the engine's wider spread does not widen the kernel cells'
bound."""


def read(ctx):
    return ctx.rate()
