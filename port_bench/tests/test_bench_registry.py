"""BENCHMARK.json against its contract (``bench_contract.py``), every
part found by name, and a new configuration, mix and metric, or a cell of
another family, added as new files alone."""
import copy
import json

import pytest

from bench_contract import check_cells, check_contract, check_shape
from conftest import BENCH, ROOT

from port_bench.registry import Registry


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_contract_shape():
    check_shape(bench())


def test_every_cell_resolves_and_reports():
    b = bench()
    check_cells(b, Registry(b))


def test_config_files_hold_the_stated_shapes():
    for name, (n, p, ratio) in {"lasso_flagship": (10000, 1000, 1e-4),
                                "lasso_wide": (1000, 2000, 0.01)}.items():
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert (cfg["n"], cfg["p"], cfg["nonzeros"], cfg["nlambda"]) == (
            n, p, 100, 100)
        assert cfg["lambda_min_ratio"] == ratio and cfg["reduced"] == []


def test_new_cell_takes_only_new_files(tmp_path):
    """A throwaway configuration, mix and per-layer metric in a folder of
    their own: found, run, and reported, with no file of the benchmark
    edited."""
    from conftest import write_tiny
    from port_bench.run import run_cell

    root = write_tiny(tmp_path / "extra")
    cfg = json.loads((root / "configs" / "lasso_flagship.json").read_text())
    cfg.update(name="throwaway", n=120, p=30)
    (root / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (root / "traffic" / "thin.json").write_text(json.dumps(
        {"entry": "lasso_path", "kwargs": {}, "designs": 1,
         "responses_per_design": 2, "warmup_calls": 1, "check_calls": 1}))
    (root / "metrics").mkdir()
    (root / "metrics" / "calls_seen.py").write_text(
        "SPANS = {'h2d': [('admm_tpu_torch.models.lasso', '_as_data')]}\n"
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    (root / "metrics" / "h2d_seen.py").write_text(
        "def read(ctx):\n    return ctx.span_ms_per_call('h2d')\n")
    (root / "limits").mkdir()
    (root / "limits" / "throwaway.thin.json").write_text(
        (BENCH / "limits" / "lasso_flagship.path.json").read_text())
    b = bench()
    b["configs"].append({"name": "throwaway", "source": "test",
                         "file": "x", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "throwaway.thin", "config": "throwaway",
                           "traffic": "thin", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry points", "moves": "fits_per_s",
                           "workloads": ["throwaway.thin"]})
    b["per_layer"].append({"name": "h2d_seen", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "entry points", "moves": "fits_per_s",
                           "workloads": ["throwaway.thin"]})
    reg = Registry(b, roots=[root])
    res = run_cell(reg, "throwaway.thin", 5, 0.2, True, "cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls_seen"]["value"] == res["attempted"]
    assert set(res["metrics"]) == {"calls_seen", "h2d_seen"}
    assert res["metrics"]["h2d_seen"]["value"] > 0


_MULTI_DATA = """
import numpy as np


class Pool:
    def __init__(self, X, Y):
        self.X, self.Y = X, Y

    def __len__(self):
        return len(self.Y)

    def problem(self, i):
        return {"X": self.X, "Y": self.Y[i % len(self.Y)]}


def make_pool(cfg, mix, seed, device):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(cfg["rows"], cfg["cols"])).astype(np.float32)
    Y = rng.normal(size=(2, cfg["rows"], cfg["responses"])).astype(np.float32)
    return Pool(X, Y)
"""

_MULTI_ENTRY = """
import numpy as np

from port_bench import checks
from port_bench.reference import lasso as ref


def arguments(cfg, mix):
    return {"lambdas": cfg["lambdas"]}


def call(port, prob, device, lambdas):
    return np.stack([port.lasso_path(prob["X"], y, lambdas=lambdas,
                                     device=device).coef.cpu().numpy()
                     for y in prob["Y"].T])


def reference(prob, precision, device, lambdas):
    return np.stack([ref.lasso_path(prob["X"], y, lambdas=lambdas,
                                    precision=precision, device=device)["coef"]
                     for y in prob["Y"].T])


def compare(out, r):
    return {"coef_gap": checks.abs_gap(out, r)}


def iterations(out):
    return 0


def flops(out, cfg, kw, kernel_ops):
    return None
"""


def test_new_entry_and_generator_take_only_new_files(tmp_path):
    """A deployment with a matrix response and a fixed lambda list, none
    of the Lasso cells' keys: its own generator, entry point, mix and
    limits, new files alone, run and judged by the same harness."""
    from port_bench.run import run_cell

    root = tmp_path / "extra"
    for kind in ("configs", "traffic", "data", "entries", "limits"):
        (root / kind).mkdir(parents=True)
    (root / "configs" / "multi.json").write_text(json.dumps(
        {"generator": "multi_response", "rows": 60, "cols": 12,
         "responses": 3, "lambdas": [0.5, 0.1, 0.02]}))
    (root / "data" / "multi_response.py").write_text(_MULTI_DATA)
    (root / "entries" / "per_column.py").write_text(_MULTI_ENTRY)
    (root / "traffic" / "each.json").write_text(json.dumps(
        {"entry": "per_column", "warmup_calls": 1, "check_calls": 2}))
    (root / "limits" / "multi.each.json").write_text('{"coef_gap": 1e-4}')
    b = bench()
    b["configs"].append({"name": "multi", "source": "test", "file": "x",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "multi.each", "config": "multi",
                           "traffic": "each", "chips": 1, "why": "test"})
    res = run_cell(Registry(b, roots=[root]), "multi.each", 3, 0.1, False,
                   "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s"} and res["attempted"] >= 1
    assert 0 < res["checks"]["coef_gap"]["value"] <= 1e-4


_LAD_DATA = """
import numpy as np


class Pool:
    def __init__(self, X, y):
        self.X, self.y = X, y

    def __len__(self):
        return len(self.y)

    def problem(self, i):
        return {"X": self.X, "y": self.y[i % len(self.y)]}


def make_pool(cfg, mix, seed, device):
    # The README's LAD generator: b ~ U(0, 1), X ~ N(0, 2^2), y = Xb + N(0, 1).
    rng = np.random.default_rng(seed)
    n, p = cfg["n"], cfg["p"]
    X = rng.normal(0.0, 2.0, size=(n, p))
    y = [X @ rng.uniform(size=p) + rng.normal(size=n) for _ in range(2)]
    return Pool(X.astype(np.float32), [v.astype(np.float32) for v in y])
"""

_LAD_ENTRY = """
import numpy as np
from scipy.optimize import linprog


def arguments(cfg, mix):
    return {}


def call(port, prob, device):
    fit = port.admm_lad(prob["X"], prob["y"], intercept=False,
                        device=device).fit()
    return {"beta": np.asarray(fit.beta)[1:], "niter": fit.niter}


def reference(prob, precision, device):
    # min sum |y - Xb| as a linear programme: y = Xb + u - v, u, v >= 0.
    X, y = prob["X"].astype(np.float64), prob["y"].astype(np.float64)
    n, p = X.shape
    res = linprog(np.r_[np.zeros(p), np.ones(2 * n)],
                  A_eq=np.c_[X, np.eye(n), -np.eye(n)], b_eq=y,
                  bounds=[(None, None)] * p + [(0, None)] * (2 * n),
                  method="highs")
    return {"beta": res.x[:p], "X": X, "y": y}


def compare(out, ref):
    loss = lambda b: np.abs(ref["y"] - ref["X"] @ b).sum()
    best = loss(ref["beta"])
    return {"objective_gap": (loss(out["beta"]) - best) / best}


def iterations(out):
    return out["niter"]


def flops(out, cfg, kw, kernel_ops):
    return None
"""

_LAD_ROOFLINE = """
TARGET = ("admm_tpu_torch.kernels.lad", "lad_solve")
DEVICE_NAME = "lad_solve_kernel"


def record(args, result):
    return {"n": int(args[0].shape[0]), "niter": result[2]}


def work(rec, lane_iterations):
    n = rec["n"]
    return lane_iterations * 2.0 * n * n, 4.0 * (n * n + 3 * n)
"""


def _other_family(tmp_path):
    """A stub LAD cell in a folder of its own, laid out as the benchmark:
    a configuration cut in ``n`` with its deployment and tiny sizes, a
    generator, a mix whose entry point states no grid, limits, a kernel's
    roofline whose target is a real function of the port and the metric
    that reads it; and the benchmark with the cell's entries appended."""
    root = tmp_path / "extra"
    for kind in ("configs", "data", "traffic", "entries", "limits",
                 "roofline", "metrics", "tests/tiny"):
        (root / kind).mkdir(parents=True)
    cfg = {"name": "stub_lad", "source": "test", "generator": "stub_lad_data",
           "n": 2000, "p": 1000, "intercept": False, "dtype": "float32",
           "reduced": ["n"], "deployment": "one H100, a test's stand-in"}
    (root / "configs" / "stub_lad.json").write_text(json.dumps(cfg))
    (root / "tests" / "tiny" / "stub_lad.json").write_text(
        json.dumps({"n": 60, "p": 6}))
    (root / "data" / "stub_lad_data.py").write_text(_LAD_DATA)
    (root / "traffic" / "stub_fit.json").write_text(json.dumps(
        {"entry": "stub_lad_fit", "warmup_calls": 1, "check_calls": 2}))
    (root / "entries" / "stub_lad_fit.py").write_text(_LAD_ENTRY)
    (root / "limits" / "stub_lad.fit.json").write_text(
        '{"objective_gap": 1e-3}')
    (root / "roofline" / "stub_lad_solve.py").write_text(_LAD_ROOFLINE)
    (root / "metrics" / "stub_lad_solve_roofline.py").write_text(
        "def read(ctx):\n    return ctx.roofline_pct('stub_lad_solve')\n")
    b = bench()
    b["configs"].append({"name": "stub_lad", "source": "test",
                         "file": "port_bench/configs/stub_lad.json",
                         "reduced": ["n"], "why": "test"})
    b["workloads"].append({"name": "stub_lad.fit", "config": "stub_lad",
                           "traffic": "stub_fit", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] in ("fits_per_s", "fit_ms_p95"):
            m["workloads"].append("stub_lad.fit")
    b["per_layer"].append({"name": "stub_lad_solve_roofline", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernels", "moves": "fits_per_s",
                           "workloads": ["stub_lad.fit"]})
    return b, root


def test_a_cell_of_another_family_joins_by_new_files_alone(tmp_path):
    """The stub LAD cell passes the contract that BENCHMARK.json passes,
    with no grid, a fifth roofline and a cut configuration, and runs
    through the harness on the CPU at its tiny sizes, correct."""
    from conftest import write_tiny
    from port_bench.run import run_cell

    b, root = _other_family(tmp_path)
    check_contract(b, Registry(b, roots=[root]))
    one_four = copy.deepcopy(b)
    one_four["workloads"][-1]["chips"] = 4
    check_shape(one_four)
    tiny = write_tiny(tmp_path / "tiny", extra=root)
    assert json.loads((tiny / "configs" / "stub_lad.json").read_text())[
        "n"] == 60
    reg = Registry(b, roots=[tiny, root])
    res = run_cell(reg, "stub_lad.fit", 2 ** 31 + 7, 0.2, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"fits_per_s", "fit_ms_p95", "setup_s"}
    assert 0 <= res["checks"]["objective_gap"]["value"] <= 1e-3
    res = run_cell(reg, "stub_lad.fit", 2 ** 31 + 8, 0.1, True, "cpu")
    assert res["correct"] and res["metrics"] == {}   # no trace on the CPU


def _refusal(case, b, root):
    """Break the stub cell's benchmark one way; the reason to expect."""
    cfg_path = root / "configs" / "stub_lad.json"
    cfg = json.loads(cfg_path.read_text())
    stub_cfg = b["configs"][-1]
    if case in ("reduced_names_no_key", "reduced_names_a_width"):
        key = "rows" if case == "reduced_names_no_key" else "p"
        cfg["reduced"] = stub_cfg["reduced"] = ["n", key]
        cfg_path.write_text(json.dumps(cfg))
        return "no key rows" if key == "rows" else "names a width, p"
    if case == "reduced_without_deployment":
        del cfg["deployment"]
        cfg_path.write_text(json.dumps(cfg))
        return "states no deployment"
    if case == "second_four_chip_cell":
        assert len(b["workloads"]) == 5
        b["workloads"][-1]["chips"] = 4
        b["workloads"][0]["chips"] = 4
        return "at most 1 of 5"
    if case == "roofline_without_work":
        path = root / "roofline" / "stub_lad_solve.py"
        path.write_text(path.read_text().split("def work")[0])
        return "no work"
    if case == "roofline_metric_without_kernel":
        (root / "metrics" / "nowhere_roofline.py").write_text(
            "def read(ctx):\n    return None\n")
        b["per_layer"].append(dict(b["per_layer"][-1],
                                   name="nowhere_roofline"))
        return "no roofline/nowhere.py"
    if case == "config_without_tiny_file":
        (root / "tests" / "tiny" / "stub_lad.json").unlink()
        return "has no tiny file"
    if case == "lasso_entry_drops_nlambda":
        (root / "traffic" / "no_grid.json").write_text(json.dumps(
            {"entry": "stub_lad_fit", "check_calls": 1}))
        b["workloads"].append({"name": "lasso_flagship.no_grid",
                               "config": "lasso_flagship",
                               "traffic": "no_grid", "chips": 1,
                               "why": "test"})
        return "does not state the grid's nlambda"
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "reduced_names_no_key", "reduced_names_a_width",
    "reduced_without_deployment", "second_four_chip_cell",
    "roofline_without_work", "roofline_metric_without_kernel",
    "config_without_tiny_file", "lasso_entry_drops_nlambda"])
def test_the_contract_refuses(tmp_path, case):
    b, root = _other_family(tmp_path)
    reason = _refusal(case, b, root)
    with pytest.raises(AssertionError, match=reason):
        check_contract(b, Registry(b, roots=[root]))
