"""The three kernels' operations and bytes reproduce the bounds that the
earlier chip runs recorded (PERF.md, the kernel table) at the flagship
and wide shapes, from the lane-iterations those runs reported."""
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import peaks
from port_bench.peaks import bound_s
from port_bench.registry import Registry


def _mod(kernel):
    return Registry(json.loads((ROOT / "BENCHMARK.json").read_text())) \
        .module("roofline", kernel)


@pytest.mark.parametrize("kernel,args,iters,bound_ms", [
    ("tall_path_scan", ((1000, 1000), (1000,), (100,)), 1178, 0.0352),
    ("tall_path_batch", ((1000, 1000), (1000,), (100,)), 2492, 0.0744),
    ("wide_path_batch", ((1000, 2000), (1000,), (100,)), 7333, 0.8756),
])
def test_bounds_at_the_flagship_and_wide_shapes(kernel, args, iters,
                                                bound_ms):
    mod = _mod(kernel)
    tensors = [torch.zeros(s) for s in args]
    k = args[2][0]
    niter = torch.full((k,), iters // k, dtype=torch.int32)
    niter[: iters % k] += 1
    rec = mod.record(tensors, (None, niter))
    flops, nbytes = mod.work(rec, int(rec["niter"].sum()))
    assert np.isclose(bound_s(flops, nbytes) * 1e3, bound_ms, rtol=2e-3)
    assert flops / 67e12 > nbytes / 3.35e12     # bound by operations


def test_bytes_count_each_input_and_output_once():
    mod = _mod("wide_path_batch")
    rec = mod.record([torch.zeros(3, 5), torch.zeros(3), torch.zeros(2)],
                     (None, torch.zeros(2)))
    assert mod.work(rec, 0) == (0.0, 4.0 * (15 + 3 + 2 * 2 + 2 * 5 + 2))


def test_cv_count_takes_every_fold_solve():
    """The CV's operations take its solves from the call's kernel launches
    (the result reports no fold's iterations); with none seen, no count."""
    reg = Registry(json.loads((ROOT / "BENCHMARK.json").read_text()))
    cv = reg.module("entries", "cv_lasso_path")
    cfg = reg.json("configs", "lasso_flagship")
    kw = cv.arguments(cfg, reg.json("traffic", "cv"))
    out = {"lambdas": np.zeros(100)}
    setup = 11 * peaks.path_setup_flops(10000, 1000)
    assert cv.flops(out, cfg, kw, 5e9) == setup + 2.0 * 10000 * 1000 * 100 + 5e9
    assert cv.flops(out, cfg, kw, 0.0) is None
