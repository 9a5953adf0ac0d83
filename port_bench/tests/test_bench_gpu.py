"""On the card: one short run of each cell through the harness, correct.

Skips without a CUDA device (decided in the fixture)::

    python -m pytest port_bench/tests/test_bench_gpu.py -q
"""
import json

import pytest
import torch

from conftest import ROOT
from port_bench.registry import Registry
from port_bench.run import run_cell


@pytest.fixture(scope="module")
def reg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")
    return Registry(json.loads((ROOT / "BENCHMARK.json").read_text()))


@pytest.mark.parametrize("cell", ["lasso_flagship.path", "lasso_wide.fit",
                                  "lasso_flagship.cv"])
def test_short_run_is_correct(reg, cell):
    res = run_cell(reg, cell, 2 ** 31 + 3, 1.0, False, "cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
