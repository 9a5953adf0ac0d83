"""Entry points: the card's idle ms per call under the program's ``pack``
spans (its answer moved to the host and packed), in the segment of whole
calls profiled with CUDA activity only (``program_spans.py``)."""
from port_bench import program_spans


def read(ctx):
    seg = program_spans.segment(ctx)
    return None if seg is None else seg.idle_ms(("pack",))
