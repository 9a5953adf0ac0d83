"""Engines: the share of the engines' device iterations that a replayed
CUDA graph ran (the program's counters ``engine.graphed_iterations`` over
``engine.iterations``, frozen iterations of a chunk included), in the
segment of whole calls profiled with CUDA activity only
(``program_spans.py``).  None where the segment ran no engine iteration,
or where the program keeps no such counter (a checkout before it)."""
from port_bench import program_spans

COUNTER = "engine.graphed_iterations"


def read(ctx):
    seg = program_spans.segment(ctx)
    if seg is None or seg.count("engine.iterations") == 0:
        return None
    if not any(name == COUNTER for name, _ in seg.rec.counts):
        return None
    return seg.count(COUNTER) / seg.count("engine.iterations")
