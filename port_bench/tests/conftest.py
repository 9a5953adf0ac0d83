"""Fixtures of the benchmark's own CPU tests (``python -m pytest
port_bench/tests -q``): the repository root on ``sys.path`` and tiny
copies of the cells' configurations and traffic mixes."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "port_bench"
#: Tiny shapes of the two configurations: the same regimes (tall, wide).
TINY = {"lasso_flagship": dict(n=300, p=40, nonzeros=8),
        "lasso_wide": dict(n=80, p=160, nonzeros=8, nlambda=10)}


def write_tiny(root: Path) -> Path:
    """Tiny copies of every configuration and mix under ``root``, found
    before the benchmark's own (a pool of 2 x 2 problems, 3 checked; the
    wide cells on 10 lambdas)."""
    for kind in ("configs", "traffic"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    for name, sizes in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg.update(sizes)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for path in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(designs=2, responses_per_design=2, check_calls=3)
        (root / "traffic" / path.name).write_text(json.dumps(mix))
    return root


@pytest.fixture
def tiny_registry(tmp_path):
    from port_bench.registry import Registry

    return Registry.from_file(ROOT / "BENCHMARK.json",
                              roots=[write_tiny(tmp_path / "tiny")])
