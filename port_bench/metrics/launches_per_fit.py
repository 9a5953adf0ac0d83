"""Device: the operations (kernels, copies, memsets) a call puts on the
card, each counted by the program span that held its launch, in the
segment of whole calls profiled with CUDA activity only
(``program_spans.py``)."""
from port_bench import program_spans


def read(ctx):
    seg = program_spans.segment(ctx)
    return None if seg is None else seg.launches() / seg.ncalls
