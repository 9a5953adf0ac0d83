"""Engines: the iterations a call's solves report (the program's counter
``solve.iterations``: every kernel lane's, engine solve's and CV fold's
``niter``, summed once the segment is over), per call, in the segment of
whole calls profiled with CUDA activity only (``program_spans.py``)."""
from port_bench import program_spans


def read(ctx):
    seg = program_spans.segment(ctx)
    return None if seg is None else seg.count("solve.iterations") / seg.ncalls
