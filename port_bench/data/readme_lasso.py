"""The reference README's Lasso generator, as a pool drawn from a seed.

X iid N(0, 1) (n, p); b with ``nonzeros`` entries drawn U(-1, 1) at
random positions; y = intercept + X b + N(0, noise_sd^2), formed in
float64 and handed over in float32 (the README's
``microbenchmark`` problem, and ``chip_smoke.py::make_problem``'s).

The pool has ``designs`` matrices and ``responses_per_design`` responses
of each; every response has its own b and noise.  It is drawn on the
device by one ``torch.Generator`` seeded with the run's seed, in a few
large calls, and copied to host numpy once.
"""
from __future__ import annotations

import numpy as np
import torch


class Pool:
    """The pool on the host: ``X`` (D, n, p) and ``Y`` (D, R, n) float32
    numpy, ``call_seeds`` (D R,) int64.  Problem i (taken modulo the
    pool's size) is design ``i % D`` with its response ``i // D`` and its
    own seed (the CV's folds)."""

    def __init__(self, X, Y, call_seeds):
        self.X, self.Y, self.call_seeds = X, Y, call_seeds

    def __len__(self) -> int:
        return len(self.call_seeds)

    def problem(self, i: int) -> dict:
        """``{"X", "y", "seed"}``: the inputs that both sides are handed."""
        i %= len(self)
        D = self.X.shape[0]
        return {"X": self.X[i % D], "y": self.Y[i % D, i // D],
                "seed": int(self.call_seeds[i])}


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> Pool:
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    D, R = int(traffic["designs"]), int(traffic["responses_per_design"])
    n, p, m = int(cfg["n"]), int(cfg["p"]), int(cfg["nonzeros"])
    X = torch.randn((D, n, p), generator=g, device=dev, dtype=torch.float32)
    where = torch.rand((D, R, p), generator=g, device=dev).argsort(dim=-1)
    vals = torch.rand((D, R, m), generator=g, device=dev,
                      dtype=torch.float64) * 2.0 - 1.0
    b = torch.zeros((D, R, p), dtype=torch.float64, device=dev)
    b.scatter_(-1, where[..., :m], vals)
    noise = torch.randn((D, R, n), generator=g, device=dev,
                        dtype=torch.float64)
    Y = torch.stack([(X[d].double() @ b[d].mT).mT for d in range(D)])
    Y = float(cfg["intercept"]) + Y + float(cfg["noise_sd"]) * noise
    call_seeds = torch.randint(0, 2 ** 31 - 1, (D * R,), generator=g,
                               device=dev)
    return Pool(X.cpu().numpy(), Y.float().cpu().numpy(),
                call_seeds.cpu().numpy().astype(np.int64))
