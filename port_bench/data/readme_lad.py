"""The reference README's LAD generator, as a pool drawn from a seed.

X iid N(0, x_sd^2) (n, p); b iid U(0, 1), dense; y = X b + N(0,
noise_sd^2), formed in float64 and handed over in float32 (the README's
"LAD larger problem", ``chip_smoke.py::lad_problem`` and
``benchmarks/run_baselines.py::lad_problem``).

The pool has ``designs`` matrices and ``responses_per_design`` responses
of each; every response has its own b and noise.  It is drawn on the
device by one ``torch.Generator`` seeded with the run's seed, in a few
large calls, and copied to host numpy once, into the Lasso generator's
``Pool`` (problem i is design ``i % D`` with its response ``i // D``).
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.data.readme_lasso import Pool


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> Pool:
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    D, R = int(traffic["designs"]), int(traffic["responses_per_design"])
    n, p = int(cfg["n"]), int(cfg["p"])
    X = float(cfg["x_sd"]) * torch.randn((D, n, p), generator=g, device=dev,
                                         dtype=torch.float32)
    b = torch.rand((D, R, p), generator=g, device=dev, dtype=torch.float64)
    noise = torch.randn((D, R, n), generator=g, device=dev,
                        dtype=torch.float64)
    Y = torch.stack([(X[d].double() @ b[d].mT).mT for d in range(D)])
    Y = Y + float(cfg["noise_sd"]) * noise
    call_seeds = torch.randint(0, 2 ** 31 - 1, (D * R,), generator=g,
                               device=dev)
    return Pool(X.cpu().numpy(), Y.float().cpu().numpy(),
                call_seeds.cpu().numpy().astype(np.int64))
