"""Fixtures of the benchmark's own CPU tests (``python -m pytest
port_bench/tests -q``): the repository root on ``sys.path`` and tiny
copies of the cells' configurations (``tiny/<config>.json``) and traffic
mixes."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "port_bench"


def write_tiny(root: Path, extra: Path = None) -> Path:
    """Tiny copies of every configuration that has a
    ``tests/tiny/<config>.json`` (its sizes: the same regime) and of every
    mix under ``root``, found before the benchmark's own (a pool of 2 x 2
    problems, 3 checked); ``extra``, a folder of further cells laid out as
    the benchmark's, adds its own and takes the place of a namesake."""
    for kind in ("configs", "traffic"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    for src in [BENCH] + ([Path(extra)] if extra else []):
        for tiny in sorted((src / "tests" / "tiny").glob("*.json")):
            cfg = json.loads((src / "configs" / tiny.name).read_text())
            cfg.update(json.loads(tiny.read_text()))
            (root / "configs" / tiny.name).write_text(json.dumps(cfg))
        for path in sorted((src / "traffic").glob("*.json")):
            mix = json.loads(path.read_text())
            mix.update(designs=2, responses_per_design=2, check_calls=3)
            (root / "traffic" / path.name).write_text(json.dumps(mix))
    return root


@pytest.fixture
def tiny_registry(tmp_path):
    from port_bench.registry import Registry

    return Registry.from_file(ROOT / "BENCHMARK.json",
                              roots=[write_tiny(tmp_path / "tiny")])
