"""BENCHMARK.json against its contract, every part found by name, and a
new configuration, mix and metric added as new files alone."""
import json
import re

from conftest import BENCH, ROOT

from port_bench.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "port_bench/run.py"
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in b["configs"]:
        assert c["file"].startswith("port_bench/") and c["reduced"] == []
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_resolves_and_reports():
    b = bench()
    reg = Registry(b)
    for w in b["workloads"]:
        cfg = reg.json("configs", w["config"])
        mix = reg.json("traffic", w["traffic"])
        entry = reg.module("entries", mix["entry"])
        assert entry.arguments(cfg, mix)["nlambda"] == cfg["nlambda"]
        reg.module("data", cfg["generator"])
        assert reg.limits(w["name"])
        e2e = reg.metrics(w["name"], trace=False)
        layer = reg.metrics(w["name"], trace=True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        moved = {m["name"] for m in e2e}
        for m in e2e + layer:
            assert callable(reg.module("metrics", m["name"]).read)
        assert all(m["moves"] in moved for m in layer)
    kernels = reg.names("roofline")
    assert kernels == ["tall_path_batch", "tall_path_scan", "wide_path_batch"]
    for k in kernels:
        mod = reg.module("roofline", k)
        assert mod.DEVICE_NAME and len(mod.TARGET) == 2


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
