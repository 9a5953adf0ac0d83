"""Engines: the reads of a device value by the engines' host loops per
iteration they run (the program's counters ``engine.host_reads`` over
``engine.iterations``), in the segment of whole calls profiled with CUDA
activity only (``program_spans.py``)."""
from port_bench import program_spans


def read(ctx):
    seg = program_spans.segment(ctx)
    if seg is None or seg.count("engine.iterations") == 0:
        return None
    return seg.count("engine.host_reads") / seg.count("engine.iterations")
