#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's Lasso/Elastic-Net path once on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels are built from
``admm_tpu_torch/csrc`` into ``admm_tpu_torch/_build/`` at first use).
Phases, in order:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions
   and the TF32 settings, which must be off;
2. the kernel build, timed;
3. each CUDA kernel against its plain PyTorch version on the same inputs
   at the main path's shapes (the flagship 10000 x 1000 problem with 100
   lambdas, and the wide 1000 x 2000 one), at the kernel tests' bars;
4. the main path through the public entry points on the card, with every
   launch count set to 0 before and read after, each call's coefficients
   held against the port's float64 engine run on the card;
5. kernel and plain times: median of 5 CUDA-event timings after a warm-up.

Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the
last line.  Exits nonzero, printing no result, without a CUDA device,
outside a checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
EPS = 1e-5
MAXIT = 10000
COEF_BAR = 1e-5       # kernel vs plain coefficients (tests/test_torch_kernels.py)
PATH_BAR = 5e-4       # main path (float32 kernels) vs float64 engine


def make_problem(n=10000, p=1000, m=100, seed=123):
    """The reference README's Lasso generator (bench.py::make_problem,
    benchmarks/run_baselines.py::regression_problem)."""
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.uniform(-1, 1, m)
    X = rng.normal(size=(n, p))
    y = 5.0 + X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def cuda_median_ms(torch, fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failures.append(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "admm_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: admm_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import admm_tpu_torch
    from admm_tpu_torch import kernels
    from admm_tpu_torch.data.standardize import standardize
    from admm_tpu_torch.kernels import _build, tall_path, wide_path
    from admm_tpu_torch.models.lasso import (_auto_lambdas, _tall_setup,
                                             _wide_setup)

    smoke = Smoke()
    dev = torch.device("cuda:0")

    # 1. The card and the settings.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    print(f"torch.backends.cuda.matmul.allow_tf32={tf32}, "
          f"float32_matmul_precision={prec}")
    smoke.check(not tf32 and prec == "highest", "float32 matmuls in full fp32")

    # 2. Build.
    print("phase: build", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"  kernels built and loaded in {build_s:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. Kernel vs plain at the main path's shapes.
    X, y = make_problem()
    Xw, yw = make_problem(1000, 2000, 100)
    f32 = dict(dtype=torch.float32, device=dev)

    def tall_inputs():
        Xs, ys, st = standardize(torch.as_tensor(X, **f32),
                                 torch.as_tensor(y, **f32),
                                 standardize_x=True, intercept=True)
        lams = _auto_lambdas(Xs, ys, st, 100, 1e-4, 1.0, False)
        ilams = lams * Xs.shape[0] / st.scale_y
        Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], -1.0)
        return Minv.contiguous(), Xty.contiguous(), ilams.contiguous(), rho

    def wide_inputs():
        Xs, ys, st = standardize(torch.as_tensor(Xw, **f32),
                                 torch.as_tensor(yw, **f32),
                                 standardize_x=True, intercept=True)
        lams = _auto_lambdas(Xs, ys, st, 100, 1e-2, 1.0, False)
        ilams = lams * Xs.shape[0] / st.scale_y
        lambda0, sprad, rho = _wide_setup(Xs, ys, ilams, -1.0, 1.0, False)
        return (Xs.contiguous(), ys.contiguous(), ilams.contiguous(),
                rho.contiguous(), sprad, lambda0)

    Minv, Xty, ilams, rho = tall_inputs()
    Xs_w, ys_w, ilams_w, rhos_w, sprad_w, lambda0_w = wide_inputs()
    torch.cuda.synchronize()
    tall_args = (Minv, Xty, ilams, rho, EPS, EPS, 1.0, MAXIT)
    wide_args = (Xs_w, ys_w, ilams_w, rhos_w, sprad_w, lambda0_w, EPS, EPS,
                 1.0, MAXIT)
    cases = {
        "tall_path_batch": (tall_path.tall_path_batch,
                            tall_path.tall_path_batch_reference, tall_args,
                            "admm_tpu_torch/csrc/tall_path.cu",
                            "admm_tpu/ops/tall_path.py:77"),
        "tall_path_scan": (tall_path.tall_path_scan,
                           tall_path.tall_path_scan_reference, tall_args,
                           "admm_tpu_torch/csrc/tall_path.cu",
                           "admm_tpu/ops/tall_path.py:178"),
        "wide_path_batch": (wide_path.wide_path_batch,
                            wide_path.wide_path_batch_reference, wide_args,
                            "admm_tpu_torch/csrc/wide_path.cu",
                            "admm_tpu/ops/wide_path.py:45"),
    }
    record = {}
    for name, (kernel, plain, args, source, replaces) in cases.items():
        print(f"phase: {name} kernel vs plain", flush=True)
        zk, nk = kernel(*args)
        torch.cuda.synchronize()
        zp, np_ = plain(*args)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(zk - zp)))
        nk, np_ = nk.cpu().numpy(), np_.cpu().numpy()
        print(f"  max |coef gap| {err:.3e}; niter total kernel {nk.sum()} "
              f"plain {np_.sum()}, max kernel {nk.max()} plain {np_.max()}, "
              f"max lane gap {np.abs(nk - np_).max()}")
        far = np.flatnonzero(np.abs(nk - np_) > 1)
        if far.size:
            print("  lanes more than 1 apart (lane: kernel, plain): " + ", ".join(
                f"{i}: {nk[i]}, {np_[i]}" for i in far[:20]))
        smoke.check(bool(torch.isfinite(zk).all()), f"{name}: finite")
        smoke.check(err <= COEF_BAR, f"{name}: coef gap <= {COEF_BAR}")
        if name == "tall_path_scan":
            tot_k, tot_p = int(nk.sum()), int(np_.sum())
            smoke.check(abs(tot_k - tot_p) <= max(3, int(0.1 * tot_p)),
                        f"{name}: niter totals within max(3, 10%)")
        else:
            smoke.check(int(np.abs(nk - np_).max()) <= 1,
                        f"{name}: niter within 1 per lane")
        if name == "wide_path_batch":
            smoke.check(float(torch.abs(zk[0]).max()) == 0.0,
                        f"{name}: lane at lambda0 exactly 0")
        record[name] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=err,
                            niter_total=int(nk.sum()),
                            niter_total_plain=int(np_.sum()))

    # 4. The main path through the public entry points.
    print("phase: main path", flush=True)
    calls = [
        ("admm_lasso(X, y).fit()  [tall batch]", "tall_path_batch",
         lambda: admm_tpu_torch.admm_lasso(X, y).fit(),
         dict(path_mode="batch")),
        ("lasso_path(X, y)  [tall scan]", "tall_path_scan",
         lambda: admm_tpu_torch.lasso_path(X, y), dict(path_mode="scan")),
        ("enet_path(X, y, alpha=0.6)  [tall scan]", "tall_path_scan",
         lambda: admm_tpu_torch.enet_path(X, y, alpha=0.6),
         dict(path_mode="scan", alpha=0.6, _enet_scale=True)),
        ("admm_lasso(Xw, yw).fit()  [wide batch]", "wide_path_batch",
         lambda: admm_tpu_torch.admm_lasso(Xw, yw).fit(),
         dict(path_mode="batch")),
    ]
    kernels.reset_launch_counts()
    outputs = []
    t_main = time.perf_counter()
    for label, kname, call, _ in calls:
        before = kernels.launch_counts()[kname]
        out = call()
        torch.cuda.synchronize()
        after = kernels.launch_counts()[kname]
        smoke.check(after > before, f"{label}: launched {kname}")
        outputs.append(out)
    main_s = time.perf_counter() - t_main
    counts = kernels.launch_counts()
    print(f"  launch counts after the main path: {counts} "
          f"({main_s:.2f} s on the host clock, first calls included)")
    for name in cases:
        smoke.check(counts[name] > 0, f"{name} launched on the main path")
        record[name]["launches"] = counts[name]

    for (label, _, _, ref_kw), out in zip(calls, outputs):
        data = (Xw, yw) if "Xw" in label else (X, y)
        ref = admm_tpu_torch.lasso_path(*data, dtype=torch.float64, **ref_kw)
        if isinstance(out, admm_tpu_torch.ADMMLassoFit):
            dense = out.beta.toarray()
            beta0, coef, niter = dense[0], dense[1:].T, out.niter
        else:
            beta0 = out.beta0.cpu().numpy()
            coef, niter = out.coef.cpu().numpy(), out.niter.cpu().numpy()
        gap = float(np.abs(coef - ref.coef.cpu().numpy()).max())
        gap0 = float(np.abs(beta0 - ref.beta0.cpu().numpy()).max())
        finite = bool(np.isfinite(coef).all() and np.isfinite(beta0).all())
        print(f"  {label}: coef shape {coef.shape}, max |coef - f64 engine| "
              f"{gap:.3e}, max |beta0 gap| {gap0:.3e}, niter total "
              f"{int(np.sum(niter))} max {int(np.max(niter))} "
              f"(f64 engine total {int(ref.niter.sum())})")
        smoke.check(finite and coef.shape[0] == 100,
                    f"{label}: 100 finite lambdas")
        smoke.check(gap <= PATH_BAR, f"{label}: within {PATH_BAR} of float64")

    # 5. Times.
    print("phase: times (median of 5 after a warm-up, CUDA events)",
          flush=True)
    for name, (kernel, plain, args, _, _) in cases.items():
        ms = cuda_median_ms(torch, lambda: kernel(*args))
        plain_ms = cuda_median_ms(torch, lambda: plain(*args))
        record[name].update(ms=ms, plain_ms=plain_ms)
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    # End to end: numpy in, result on the host out (the input copy, the
    # standardization, the Gram and Cholesky set-up, the kernel, recovery).
    for label, _, call, _ in calls:
        print(f"  end to end {label}: {cuda_median_ms(torch, call):.3f} ms")

    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")}
        for r in record.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
