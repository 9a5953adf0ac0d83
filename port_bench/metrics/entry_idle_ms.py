"""Entry points: the card's idle ms per call under the program's ``fit``
(its own time, outside its children), ``validate`` and ``h2d`` spans, in
the segment of whole calls profiled with CUDA activity only
(``program_spans.py``)."""
from port_bench import program_spans


def read(ctx):
    seg = program_spans.segment(ctx)
    return None if seg is None else seg.idle_ms(("fit", "validate", "h2d"))
