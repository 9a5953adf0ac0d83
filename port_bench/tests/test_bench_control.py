"""The control: the reference computed in TF32 (the precision below the
configurations' float32 with TF32 off) put in the program's place by
:func:`port_bench.run.run_cell` comes out not correct through the run's
own check, on the CPU at a tiny size (``test_bench_faults.py`` sees the
program itself pass the same run; ``run.py --control tf32`` does the same
on the card at each cell's own size)."""
import pytest

from port_bench.run import run_cell

CELLS = ["lasso_flagship.path", "lasso_wide.fit", "lasso_wide.path",
         "lasso_flagship.cv"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(tiny_registry, cell):
    res = run_cell(tiny_registry, cell, 2 ** 31 + 5, 0.0, False, "cpu",
                   control="tf32")
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert not res["correct"], res["checks"]
    assert [n for n, j in res["checks"].items() if j["value"] > j["limit"]]
