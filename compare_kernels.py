#!/usr/bin/env python3
"""Time the LAD and tall-batch CUDA kernels of several checkouts of the
port on one GPU, in turns.

    python3 compare_kernels.py TREE [TREE ...]

Each TREE is a directory that holds an ``admm_tpu_torch`` package (a
checkout of the repository, or an unpacked ``git archive`` of one).  The
trees are run in the order given and then in reverse (for two trees:
A, B, B, A), each in a process of its own, which builds that tree's kernels
into its own ``admm_tpu_torch/_build/``.  Every run times, with CUDA events
(median of 5 after a warm-up), the main path's kernel calls: ``lad_solve``
on the hat matrices of ``admm_lad(intercept=False).fit()`` at 1000 x 500
and 5000 x 1000, and ``tall_path_batch`` on the inputs of
``admm_lasso().fit()`` at 10000 x 1000 with 100 lambdas (the problems of
``chip_smoke.py``, seed 123).  Beside the kernels it times the consensus
loop, which has none: ``parallel_lasso_path`` on the flagship at W = 2 and
8 and on the wide 1000 x 2000 problem at W = 2, end to end on the host
clock (median of 3 after a warm-up).  It prints one line per run and
call (ms, iterations, us per iteration of the slowest lane or path) and
the card's name and power limit.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RHO_L1, EPS_L1, EPS, MAXIT = 5.0, 2e-5, 1e-5, 10000


def _worker(tree: str) -> dict:
    """Time one tree's kernels; runs in a process of its own."""
    sys.path.insert(0, str(Path(tree).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import admm_tpu_torch
    from admm_tpu_torch.data.standardize import standardize
    from admm_tpu_torch.kernels import lad, tall_path
    from admm_tpu_torch.models.lad import _hat_matrix, _lad_setup
    from admm_tpu_torch.models.lasso import _auto_lambdas, _tall_setup
    from chip_smoke import (cuda_median_ms, host_median_ms, lad_problem,
                            make_problem)

    assert Path(admm_tpu_torch.__file__).resolve().is_relative_to(
        Path(tree).resolve()), admm_tpu_torch.__file__
    dev = torch.device("cuda:0")
    f32 = dict(dtype=torch.float32, device=dev)
    out = {}
    for n, p in ((1000, 500), (5000, 1000)):
        X, y = lad_problem(n, p)
        Xa, ys, _, Ginv, ynorm = _lad_setup(torch.as_tensor(X, **f32),
                                            torch.as_tensor(y, **f32), False)
        args = (_hat_matrix(Xa, Ginv), ys.contiguous(), RHO_L1, EPS_L1,
                EPS_L1, float(ynorm), MAXIT)
        _, _, it = lad.lad_solve(*args)
        ms = cuda_median_ms(torch, lambda: lad.lad_solve(*args))
        out[f"lad_solve {n} x {p}"] = dict(ms=ms, iters=int(it),
                                          slowest=int(it))
    X, y = make_problem()
    Xs, ys, st = standardize(torch.as_tensor(X, **f32),
                             torch.as_tensor(y, **f32), standardize_x=True,
                             intercept=True)
    lams = _auto_lambdas(Xs, ys, st, 100, 1e-4, 1.0, False)
    ilams = (lams * Xs.shape[0] / st.scale_y).contiguous()
    Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], -1.0)
    args = (Minv.contiguous(), Xty.contiguous(), ilams, rho, EPS, EPS, 1.0,
            MAXIT)
    _, niter = tall_path.tall_path_batch(*args)
    ms = cuda_median_ms(torch, lambda: tall_path.tall_path_batch(*args))
    out["tall_path_batch 1000 x 1000 x 100"] = dict(
        ms=ms, iters=int(niter.sum()), slowest=int(niter.max()))
    Xw, yw = make_problem(1000, 2000, 100)
    for label, (A, b, W) in {"consensus flagship W = 2": (X, y, 2),
                             "consensus flagship W = 8": (X, y, 8),
                             "consensus wide W = 2": (Xw, yw, 2)}.items():
        ms, res = host_median_ms(torch, lambda: admm_tpu_torch.
                                 parallel_lasso_path(A, b, nworkers=W),
                                 reps=3)
        it = int(res.niter.sum())
        out[label] = dict(ms=ms, iters=it, slowest=it)
    return out


def main(trees) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    results = {t: [] for t in trees}
    for tree in list(trees) + list(reversed(trees)):
        res = subprocess.run([sys.executable, __file__, "--worker", tree],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(f"{tree}: failed\n{res.stderr[-4000:]}", file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        results[tree].append(run)
        for name, r in run.items():
            print(f"  {tree} | {name}: {r['ms']:.3f} ms, {r['iters']} "
                  f"iterations (slowest lane {r['slowest']}), "
                  f"{r['ms'] * 1e3 / r['slowest']:.2f} us per iteration of "
                  "the slowest lane", flush=True)
    print("medians over the runs of each tree (ms):")
    for tree, runs in results.items():
        print(f"  {tree}: " + ", ".join(
            f"{name} {statistics.median(r[name]['ms'] for r in runs):.3f}"
            for name in runs[0]))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(_worker(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
