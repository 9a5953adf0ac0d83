"""Set-up: the device operations a call launches under the program's
hat-matrix ``setup`` span (``part="hat"``: ``models/lad.py::_hat_matrix``,
the dense Xa (Xa'Xa)^-1 Xa' that the LAD kernel iterates against), per
call, in the segment of whole calls profiled with CUDA activity only
(``program_spans.py``).  0 where the program spans LAD's set-up
(``part="gram"``) and forms no hat matrix; None where it spans neither
(a program before these spans)."""
from port_bench import program_spans


def _part(name):
    return lambda s: s.name == "setup" and s.attrs.get("part") == name


def read(ctx):
    seg = program_spans.segment(ctx)
    if seg is None or not any(map(_part("gram"), seg.spans)):
        return None
    return seg.launches(_part("hat")) / seg.ncalls
