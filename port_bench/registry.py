"""Find a cell's parts by name.

Each part is a file of its own under one of the registry's roots (the
benchmark's folder, and any folder a caller puts before it):

* ``configs/<config>.json``: the deployment's sizes, source and the name of
  its data generator (``data/<generator>.py``, whose ``make_pool`` draws
  the run's problems and indexes them);
* ``traffic/<mix>.json``: the entry point (``entries/<entry>.py``, which
  builds its own arguments from the configuration and the mix, calls the
  program and the reference, compares them and counts the operations), its
  keyword arguments, the pool of problems and how many answers a run
  checks;
* ``metrics/<metric>.py``: a reader ``read(ctx)`` that returns a number or
  None, and optionally ``SPANS`` (span name -> the ``(module, function)``
  pairs whose calls it times in a traced run);
* ``roofline/<kernel>.py``: a kernel's Python wrapper, its name in the
  trace, and its operations and bytes per launch; a traced run counts the
  launches of every kernel found here;
* ``reference/<name>.py``: the plain reference an entry point imports and
  calls in the program's place, in float64 for the check (and in the
  control's precision with ``run.py --control``), importing nothing of
  the program;
* ``limits/<cell>.json``: each number the cell's check compares, with its
  limit;
* ``tests/tiny/<config>.json``: the sizes that shrink the configuration
  for the benchmark's own CPU tests (the same regime, the same keys).

A later cell, configuration, mix or metric is one more file: nothing
here names any of them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Iterable, Optional

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, bench: dict, roots: Optional[Iterable[Path]] = None):
        self.bench = bench
        self.roots = [Path(r) for r in (roots or [])] + [HERE]
        self._modules = {}

    @classmethod
    def from_file(cls, path: Path, roots=None) -> "Registry":
        return cls(json.loads(Path(path).read_text()), roots)

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self._find(kind, name, ".json").read_text())

    def names(self, kind: str, suffix: str = ".py") -> list:
        """Every name of that kind under the roots."""
        return sorted({p.name[:-len(suffix)] for root in self.roots
                       for p in (root / kind).glob(f"*{suffix}")})

    def module(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._modules:
            path = self._find(kind, name, ".py")
            spec = importlib.util.spec_from_file_location(
                f"port_bench_{kind}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    # -- the cell ----------------------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in the benchmark")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metrics of the run's kind: the end-to-end ones with
        ``--trace 0``, the per-layer ones with ``--trace 1``."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def limits(self, cell: str) -> dict:
        return self.json("limits", cell)
