"""The benchmark's contract as checks of a benchmark and a registry, so
that ``BENCHMARK.json`` and a throwaway benchmark in a temporary folder
are held to the same rules.  A cell of any family passes them with new
files alone and its name appended to ``BENCHMARK.json``; each failed
rule raises ``AssertionError`` with its reason."""
import importlib
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: The kernels of the Lasso cells: a later cell adds kernels, and these stay.
LASSO_KERNELS = {"tall_path_batch", "tall_path_scan", "wide_path_batch"}
#: Entry-point functions every ``entries/<entry>.py`` exposes to ``run.py``.
ENTRY_FUNCTIONS = ("arguments", "call", "reference", "compare", "iterations",
                   "flops")
#: A configuration's widths, which ``reduced`` never names: the columns
#: (``p``: a record's width) and any key of these endings.
WIDTH_KEYS = {"p"}
WIDTH_ENDINGS = ("_dim", "_rank", "_width")


def check_shape(bench: dict) -> None:
    """The rules ``BENCHMARK.json`` keeps by itself: its keys, names,
    units, bounds, sources, chips and each ``why``."""
    b = bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "port_bench/run.py"
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)), "a name is used twice"
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
        assert c["file"] == f"port_bench/configs/{c['name']}.json", c["file"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert w["chips"] in (1, 4), f"{w['name']}: chips {w['chips']}"
        assert len(w["why"]) <= 200
    # A quarter of the cells, rounded down, may take 4 chips; one always may.
    four = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    cap = max(1, len(b["workloads"]) // 4)
    assert len(four) <= cap, (f"four-chip cells {four}: at most {cap} of "
                              f"{len(b['workloads'])}")


def _check_config(c: dict, cfg: dict, reg) -> None:
    name = c["name"]
    for key in ("generator", "source", "reduced"):
        assert key in cfg, f"configuration {name} states no {key}"
    red = cfg["reduced"]
    assert isinstance(red, list) and all(isinstance(k, str) for k in red)
    assert sorted(red) == sorted(c["reduced"]), (
        f"configuration {name}: reduced {red} in its file, "
        f"{c['reduced']} in the benchmark")
    for key in red:
        assert key in cfg, f"configuration {name}: reduced names no key {key}"
        assert key not in WIDTH_KEYS and not key.endswith(WIDTH_ENDINGS), (
            f"configuration {name}: reduced names a width, {key}")
    if red:
        assert cfg.get("deployment"), (
            f"configuration {name} is reduced and states no deployment")
    try:
        tiny = reg.json("tests/tiny", name)
    except FileNotFoundError:
        raise AssertionError(f"configuration {name} has no tiny file") \
            from None
    assert set(tiny) <= set(cfg), (
        f"configuration {name}: tiny keys {sorted(set(tiny) - set(cfg))} "
        f"are not its own")
    assert callable(reg.module("data", cfg["generator"]).make_pool)


def _check_roofline(kernel: str, reg) -> None:
    mod = reg.module("roofline", kernel)
    assert isinstance(getattr(mod, "DEVICE_NAME", None), str) \
        and mod.DEVICE_NAME, f"roofline {kernel}: no DEVICE_NAME"
    target = getattr(mod, "TARGET", None)
    assert (isinstance(target, tuple) and len(target) == 2
            and all(isinstance(t, str) for t in target)), (
        f"roofline {kernel}: TARGET is not a (module, function) pair")
    assert target[0].split(".")[0] == "admm_tpu_torch", (
        f"roofline {kernel}: {target[0]} is not the program's")
    assert callable(getattr(importlib.import_module(target[0]), target[1],
                            None)), f"roofline {kernel}: no {target}"
    for fn in ("record", "work"):
        assert callable(getattr(mod, fn, None)), f"roofline {kernel}: no {fn}"


def check_cells(bench: dict, reg) -> None:
    """Every part of every cell found by name under the registry's roots
    and usable by ``run.py``, whatever the cell's family."""
    b = bench
    for c in b["configs"]:
        _check_config(c, reg.json("configs", c["name"]), reg)
    for w in b["workloads"]:
        cfg = reg.json("configs", w["config"])
        mix = reg.json("traffic", w["traffic"])
        entry = reg.module("entries", mix["entry"])
        for fn in ENTRY_FUNCTIONS:
            assert callable(getattr(entry, fn, None)), (
                f"entry {mix['entry']}: no {fn}")
        args = entry.arguments(cfg, mix)
        assert isinstance(args, dict)
        if "nlambda" in cfg:
            assert args.get("nlambda") == cfg["nlambda"], (
                f"{w['name']}: the entry does not state the grid's nlambda")
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
    assert LASSO_KERNELS <= set(kernels)
    for k in kernels:
        _check_roofline(k, reg)
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert kernel in kernels, f"{m['name']}: no roofline/{kernel}.py"


def check_contract(bench: dict, reg) -> None:
    check_shape(bench)
    check_cells(bench, reg)
