#!/usr/bin/env python3
"""Compare cuSOLVER's SVD drivers for the port's singular-value
thresholding on one GPU.

    python3 compare_svd.py

``admm_tpu_torch.models.rpca.svt`` runs its SVD in float64 on a CUDA
tensor.  This script shows why: for each of the float32 drivers of
``torch.linalg.svd`` (the default, ``gesvd``, ``gesvdj``, ``gesvda``) and
the float64 route, at the 500 x 500 PCP matrix of ``chip_smoke.py``
(seed 123), it prints the SVT's gap to a float64 LAPACK SVT on the host,
its time (median of 5 CUDA-event timings after a warm-up) and ``max |U'U -
I|``; then, with ``svt`` replaced by each route, the iterations and time
(host clock to a synchronize) of ``rpca`` and ``matrix_complete`` at 500 x
500, of ``multitask_nuclear_path`` at 10000 x 1000 x K=8 x 50 lambdas, and
of ``cv_rpca`` at 500 x 500 (20% unobserved; 5 lambdas and 3 folds) for
the accurate routes, and its defaults for ``gesvda``.  A route whose SVD
fails is reported as such.  Prints the card's name and power limit
first.  Needs one CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_svd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import admm_tpu_torch as t
    import chip_smoke as cs
    from admm_tpu_torch.models import multitask, rpca

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    port_svt = rpca.svt

    def route(driver):
        """An SVT whose SVD runs in float32 through ``driver``."""
        def svt(A, tau):
            U, s, Vh = torch.linalg.svd(A, full_matrices=False,
                                        driver=driver)
            return (U * torch.clamp(s - tau, min=0.0)[..., None, :]) @ Vh
        return svt

    routes = {"float32 default": route(None), "float32 gesvd":
              route("gesvd"), "float32 gesvdj": route("gesvdj"),
              "float32 gesvda": route("gesvda"), "float64 (the port)":
              port_svt}
    P = cs.last_problems()
    A = torch.as_tensor(P["rpca500"], device="cuda")
    ref = rpca.svt(A.double().cpu(), 5.0)
    for name, svt in routes.items():
        gap = float((svt(A, 5.0).double().cpu() - ref).abs().max())
        ms = cs.cuda_median_ms(torch, lambda: svt(A, 5.0))
        if name.startswith("float32"):
            U = torch.linalg.svd(A, full_matrices=False,
                                 driver=name.split()[1]
                                 if name != "float32 default" else None)[0]
        else:
            U = torch.linalg.svd(A.double(), full_matrices=False)[0]
        orth = float((U.mT @ U - torch.eye(U.shape[1], dtype=U.dtype,
                                           device="cuda")).abs().max())
        print(f"svt 500 x 500, {name}: {ms:.3f} ms, gap to float64 LAPACK "
              f"{gap:.3e}, max |U'U - I| {orth:.2e}", flush=True)

    Xm, Ym = cs.second_problems()["multitask"]
    calls = {
        "rpca 500 x 500": lambda: t.rpca(P["rpca500"], maxit=2000,
                                         eps_abs=1e-6, eps_rel=1e-5),
        "matrix_complete 500 x 500": lambda: t.matrix_complete(
            P["low_rank500"], P["observed500"], maxit=600),
        "multitask_nuclear_path 10000 x 1000 x 8": lambda: (
            t.multitask_nuclear_path(Xm, Ym)),
        "cv_rpca 500 x 500, 5 lambdas, 3 folds": lambda: t.cv_rpca(
            P["rpca500"], observed=P["observed500"], nlambda=5, nfolds=3,
            maxit=2000, eps_abs=1e-6, eps_rel=1e-5),
        "cv_rpca 500 x 500, defaults": lambda: t.cv_rpca(
            P["rpca500"], observed=P["observed500"], maxit=2000,
            eps_abs=1e-6, eps_rel=1e-5),
    }
    slow = ("float32 default", "float32 gesvdj")
    for name, svt in routes.items():
        rpca.svt = multitask.svt = svt
        try:
            for label, call in calls.items():
                # The inaccurate routes run the CVs to maxit (see rpca and
                # completion); the CV's defaults (10 lambdas, 5 folds) run
                # on the fast route alone, where its SVD fails.
                if label.startswith("cv_rpca") and name in slow or (
                        label.endswith("defaults")
                        and name != "float32 gesvda"):
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    out = call()
                except torch.linalg.LinAlgError as err:
                    print(f"  {label} with {name}: the SVD failed ({err})",
                          flush=True)
                    continue
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                res = out.fit if hasattr(out, "fit") else out
                niter = (res.niter if hasattr(res, "niter")
                         else res[1]).reshape(-1)
                print(f"  {label} with {name}: {ms:.1f} ms, niter total "
                      f"{int(niter.sum())} max {int(niter.max())}",
                      flush=True)
        finally:
            rpca.svt = multitask.svt = port_svt
    return 0


if __name__ == "__main__":
    sys.exit(main())
