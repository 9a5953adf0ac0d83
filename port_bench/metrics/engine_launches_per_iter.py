"""Engines: the device operations launched inside the program's engine
``solve`` spans (``kernel="engine"``: a lambda's warm start, solve and
report) per iteration the engines' host loops run
(``engine.iterations``), in the segment of whole calls profiled with
CUDA activity only (``program_spans.py``)."""
from port_bench import program_spans


def _engine_solve(span):
    return span.name == "solve" and span.attrs.get("kernel") == "engine"


def read(ctx):
    seg = program_spans.segment(ctx)
    if seg is None or seg.count("engine.iterations") == 0:
        return None
    return seg.launches(_engine_solve) / seg.count("engine.iterations")
