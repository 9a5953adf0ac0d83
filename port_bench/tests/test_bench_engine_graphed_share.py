"""``engine_graphed_share`` on recordings made on the CPU: None where the
segment ran no engine iteration or the program keeps no
``engine.graphed_iterations`` counter, the counters' ratio otherwise."""
import importlib
from types import SimpleNamespace as S

import pytest

from conftest import ROOT  # noqa: F401  (the repository on sys.path)
from port_bench import program_spans as ps

share = importlib.import_module("port_bench.metrics.engine_graphed_share")


def _reading(counts, request=1):
    from admm_tpu_torch.diag import profile

    with profile.record() as rec:
        with profile.request(request):
            with profile.span("solve", kernel="engine"):
                for name, n in counts:
                    profile.count(name, n)
    seg = ps.Segment([{"id": 1, "iterations": 0}], rec, [], "start",
                     rec.spans[0].t0, rec.spans[0].t1)
    return share.read(S(program_segment=seg))


@pytest.mark.parametrize("counts, want", [
    ([], None),
    ([("engine.iterations", 0), ("engine.graphed_iterations", 0)], None),
    # A program before the counter: iterations, but no graphed count.
    ([("engine.iterations", 48), ("engine.host_reads", 12)], None),
    ([("engine.iterations", 48), ("engine.graphed_iterations", 48)], 1.0),
    # One graphed solve and one op-by-op loop (which counts 0 graphed).
    ([("engine.iterations", 48), ("engine.graphed_iterations", 48),
      ("engine.iterations", 16), ("engine.graphed_iterations", 0)], 0.75),
])
def test_engine_graphed_share_reads_the_counters(counts, want):
    assert _reading(counts) == want


def test_engine_graphed_share_counts_only_the_segments_requests():
    assert _reading([("engine.iterations", 8),
                     ("engine.graphed_iterations", 8)], request=2) is None
