"""Set-up: the card's idle ms per call under the program's ``setup``
spans (standardization, the lambda grid, the Gram matrix or spectral
radius, rho and the ridge inverse; in a CV, the full fit's and every
fold's), in the segment of whole calls profiled with CUDA activity only
(``program_spans.py``)."""
from port_bench import program_spans


def read(ctx):
    seg = program_spans.segment(ctx)
    return None if seg is None else seg.idle_ms(("setup",))
