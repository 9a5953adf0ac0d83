#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU: the
Lasso/Elastic-Net lambda path, LAD, Basis Pursuit, the Dantzig selector,
the penalized GLM paths (logistic, Huber, Poisson), cross-validation and
prediction, the families that run on the engines, the glmnet front end,
consensus ADMM, and the checkpointed drivers and the profiler.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels are built from
``admm_tpu_torch/csrc`` into ``admm_tpu_torch/_build/`` at first use).
Phases, in order:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions
   and the TF32 settings, which must be off;
2. the kernel build, timed;
3. each of the six CUDA kernels against its plain PyTorch version on the
   same inputs at the main path's shapes (the flagship 10000 x 1000 Lasso
   problem with 100 lambdas, the wide 1000 x 2000 one, LAD at 1000 x 500
   and 5000 x 1000, BP at 1000 x 2000 with 100 signals and with one, the
   GLM path at 2000 x 200 with 30 lambdas for the logistic and Huber
   losses and at 10000 x 1000 with 100 lambdas for the logistic loss), at
   the kernel tests' bars; all six kernels (cooperative grids that add
   the blocks' partial sums in a fixed order) are also launched twice on
   the same inputs and must give identical bits (LAD at both sizes);
4. the main paths through the public entry points on the card, with every
   launch count set to 0 before and read after, each call's result held
   against the port's float64 engine run on the card; then "cv, options
   and prediction" (:func:`cv_phase`): ``cv_lasso_path`` tall and wide
   with 10 folds (exactly 11 batch-kernel launches each),
   ``cv_logistic_path``, a penalty-factor-and-box path and the adaptive
   lasso (no launch), each against its float64 run, ``predict`` and
   ``assess`` on the tall CV, their end-to-end times and the tall CV's
   stages; then "traces, active set and the first families"
   (:func:`families_phase`) and "the second families"
   (:func:`second_families_phase`: the square-root lasso, SLOPE, SVM,
   multi-task, nuclear-norm, multinomial and quantile paths and their CV
   drivers, none of which may launch a kernel, each against its float64
   run on the card) and "the last families and glmnet"
   (:func:`last_families_phase`: the Cox, graphical-lasso, robust-PCA and
   matrix-completion paths and their CV drivers, which launch nothing, and
   ``glmnet``/``cv_glmnet``/``big_glm``, which launch their drivers'
   kernels exactly; the glasso scan against batch, the logdet proxes and
   the exact against the partial SVT, timed) and "consensus"
   (:func:`consensus_phase`: the builders' ``.parallel(nthread)`` and the
   ``parallel_*`` drivers, which launch nothing, each against its float64
   consensus on the card; the flagship and wide paths against the
   reference's ``padmm`` times; the loop op by op and as a CUDA graph)
   and "diagnostics" (:func:`diag_phase`: the 17 checkpointed drivers
   whole, stopped and resumed, to the bit, on full-size problems; the
   native host packer; a profiler trace that must hold the tall kernels;
   the memory snapshot);
5. kernel and plain times, and each entry point end to end: median of 5
   (3 for the larger solves) CUDA-event timings after a warm-up, each
   kernel's time beside its bound (the larger of bytes over 3.35 TB/s and
   operations over 67 TFLOP/s float32, for the iterations this run's data
   needed); for the tall scan and LAD kernels the grid, the grid syncs and
   the time per iteration over the run (LAD: its ring, and the floor of
   streaming H from device memory every iteration); for the tall batch,
   wide, GLM and BP kernels the grid, the grid syncs per iteration, the
   time per iteration of the slowest lane and the time per iteration with
   every lane active; as yardsticks the port never calls, ``torch.mv(H,
   v)`` for one LAD iteration's product and a float32 100 x p x p product
   for one tall batch iteration's; the GLM kernel
   beside the float32 engine on the same batch problem; then the stages of
   one scan-mode Lasso path, one tall and one wide batch fit, one LAD fit,
   one batched BP solve and one logistic fit on the host clock.

Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the
last line.  Exits nonzero, printing no result, without a CUDA device,
outside a checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
EPS = 1e-5
MAXIT = 10000
COEF_BAR = 1e-5       # kernel vs plain coefficients (tests/test_torch_kernels.py)
PATH_BAR = 5e-4       # main path (float32 kernels) vs float64 engine
# LAD and BP: the precision-aware defaults of the port (models/lad.py).
RHO_L1, EPS_L1 = 5.0, 2e-5
LAD_COEF_BAR, LAD_OBJ_BAR = 5e-3, 1.001   # tests/test_pallas_kernels.py
# The quantile path at 2000 x 200 (t(3) noise): some lanes run to maxit in
# either precision, in the JAX package too, whose float32 path is 6.55e-3
# from its float64 one there on the CPU (and its float64 paths at eps 1e-5
# and 1e-6 part by 7.8e-3); the pinball objective is held at LAD_OBJ_BAR.
QUANTILE_COEF_BAR = 1e-2
# Its CV curves, relative to float64 (every lane runs to maxit): on the
# CPU the JAX package's float32 CV is 5.6e-4 to 5.9e-4 from float64 over
# four row orderings and the port's 6.9e-4 (tests/quantile_cv_gap.py);
# the 17% between them is XLA's fused multiply-adds (PyTorch rounds each
# operation, on the card too), not a port fault.  The bar is the port's
# gap rounded up (it was 2e-3 before that comparison).
QUANTILE_CV_BAR = 1e-3
BP_Z_BAR = 1e-4                           # kernel vs plain, same file
BP_F64_BAR = 1e-3                         # main path vs float64 engine
BP_RECOVERY_BAR = 2.11e-3                 # the reference README's published error
DANTZIG_SHAPE = (2000, 200, 20)           # n, p, nlambda
# GLM kernel vs plain: the JAX package's bar for its kernel
# (tests/test_pallas_kernels.py) is the requirement, COEF_BAR and identical
# niter the target.
GLM_COEF_BAR = 2e-5
GLM_SHAPE, GLM_LARGE_SHAPE = (2000, 200, 30), (10000, 1000, 100)
# The active-set comparison (n, p, nonzero slopes, nlambda): the sizes of
# the JAX package's benchmarks/wide_activeset_bench.py.
ACTIVESET_SIZES = ((1000, 2000, 100, 100), (1000, 10000, 200, 50),
                   (5000, 20000, 400, 20))
HUBER_M = 1.345
# The card's published peaks (H100 SXM data sheet), for the bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def make_problem(n=10000, p=1000, m=100, seed=123):
    """The reference README's Lasso generator (bench.py::make_problem,
    benchmarks/run_baselines.py::regression_problem)."""
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.uniform(-1, 1, m)
    X = rng.normal(size=(n, p))
    y = 5.0 + X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def lad_problem(n, p, seed=123):
    """The reference README's LAD generator
    (benchmarks/run_baselines.py::lad_problem): b = runif(p),
    x = rnorm(sd=2), y = x b + rnorm, fitted with intercept=False."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p)
    X = rng.normal(scale=2.0, size=(n, p))
    y = X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def bp_problem(n, p, k, m=1, seed=123):
    """The reference README's BP generator
    (benchmarks/run_baselines.py::bp_problem): a k-sparse signal, exact
    measurements.  Signal 0 and A are that problem's; signals 1..m-1 are
    drawn the same way from the same generator afterwards."""
    rng = np.random.default_rng(seed)
    X0 = np.zeros((m, p))
    X0[0, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    A = (rng.normal(size=(n, p)) / np.sqrt(n)).astype(np.float32)
    for i in range(1, m):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    B = (X0 @ A.astype(np.float64).T).astype(np.float32)
    return A, B, X0


def glm_problem(n, p, seed=123):
    """The JAX package's GLM benchmark problem
    (benchmarks/glm_sweep.py::problems): a normal design, 10 true slopes,
    eta = 0.3 + 0.3 X b, a Bernoulli, a noisy and a Poisson response."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[:10] = rng.uniform(0.5, 1.5, 10)
    eta = 0.3 + X @ b * 0.3
    return X, {
        "logistic": (rng.uniform(size=n) < 1 / (1 + np.exp(-eta)))
        .astype(np.float32),
        "huber": (eta + 0.3 * rng.normal(size=n)).astype(np.float32),
        "poisson": rng.poisson(np.exp(np.clip(eta * 0.3, None, 3.0)))
        .astype(np.float32),
    }


def logistic_problem(n, p, m=100, seed=123):
    """The flagship Lasso generator's design and coefficients
    (:func:`make_problem`) with a Bernoulli response of X b."""
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.uniform(-1, 1, m)
    X = rng.normal(size=(n, p))
    y = rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ b)))
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


def host_median_ms(torch, fn, reps=5):
    """Median host-clock time of ``fn`` run to ``torch.cuda.synchronize()``,
    after one warm-up; returns ``(ms, fn's last result)``."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def bound_ms(nbytes, flops):
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or this run's operations at
    the float32 rate, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str) -> None:
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failures.append(what)


class StageClock:
    """Host-clock times of the functions that one call reaches, each run
    to a ``torch.cuda.synchronize()`` on both sides.  :meth:`patch` puts
    a timed wrapper in place of ``module.attr`` for as long as the
    ``with`` lasts; a time is inclusive and keyed by the chain of timed
    callers ("fold sweep > _tall_setup"), summed over the calls.
    ``keep`` names the chains whose first call's arguments are kept."""

    def __init__(self, torch, keep=()):
        self.torch, self.keep = torch, set(keep)
        self.stack, self.ms, self.calls, self.args = [], {}, {}, {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            self.stack.append(name)
            key = " > ".join(self.stack)
            if key in self.keep and key not in self.args:
                self.args[key] = (args, kwargs)
            self.ms.setdefault(key, 0.0)            # keys in call order
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.torch.cuda.synchronize()
                self.ms[key] += (time.perf_counter() - t0) * 1e3
                self.calls[key] = self.calls.get(key, 0) + 1
                self.stack.pop()

        return timed

    @contextlib.contextmanager
    def patch(self, targets):
        """``targets``: (module, attribute, stage name) triples."""
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
        try:
            for mod, attr, name in targets:
                setattr(mod, attr, self.wrap(name, getattr(mod, attr)))
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)


def cv_phase(torch, smoke, record, X, y, Xw, yw, Xg, yg, kg, f32):
    """Phase 4b: ``cv_lasso_path`` at 10000 x 1000 and 1000 x 2000 (100
    lambdas, 10 folds; one batch-kernel launch for the full fit and one per
    fold), ``cv_logistic_path`` at 2000 x 200 (the GLM kernel for the full
    fit, the engine for the weighted folds), a penalty-factor-and-box path
    and the adaptive lasso at 10000 x 1000 (the engine, no kernel), then
    ``predict`` and ``assess`` on the tall CV.  Each call runs with the
    launch counts at 0 just before it and read just after; they add to the
    kernels' ``launches``.  Every result is held against the port's
    float64 run on the card.  Times: the kernel paths' medians of 3 after
    a warm-up; the engine-bound calls (host loops that move by up to 2x
    between calls) their first call; the tall CV's stages come from the
    real ``cv_lasso_path`` under a :class:`StageClock`."""
    import admm_tpu_torch as t
    from admm_tpu_torch import kernels
    from admm_tpu_torch.kernels import tall_path
    from admm_tpu_torch.models import cv as cv_mod
    from admm_tpu_torch.models import lasso as lasso_mod

    print("phase: cv, options and prediction", flush=True)
    f64 = dict(dtype=torch.float64)
    pf = np.random.default_rng(123).uniform(0.5, 1.5, X.shape[1])
    nfolds = 10
    # (label, the only kernel that may launch, its launches, call, float64)
    calls = [
        (f"cv_lasso_path(X, y, nfolds={nfolds})  [{X.shape[0]} x "
         f"{X.shape[1]} x 100, tall batch]", "tall_path_batch", nfolds + 1,
         lambda: t.cv_lasso_path(X, y, nfolds=nfolds),
         lambda: t.cv_lasso_path(X, y, nfolds=nfolds, **f64)),
        (f"cv_lasso_path(Xw, yw, nfolds={nfolds})  [{Xw.shape[0]} x "
         f"{Xw.shape[1]} x 100, wide batch]", "wide_path_batch", nfolds + 1,
         lambda: t.cv_lasso_path(Xw, yw, nfolds=nfolds),
         lambda: t.cv_lasso_path(Xw, yw, nfolds=nfolds, **f64)),
        (f"cv_logistic_path(Xg, yg, nlambda={kg}, nfolds={nfolds})  "
         f"[{Xg.shape[0]} x {Xg.shape[1]}, folds on the engine]",
         "glm_batch_path", 1,
         lambda: t.cv_logistic_path(Xg, yg, nlambda=kg, nfolds=nfolds),
         lambda: t.cv_logistic_path(Xg, yg, nlambda=kg, nfolds=nfolds,
                                    **f64)),
        ("lasso_path(X, y, penalty_factor=pf, lower_limits=0.0, "
         "path_mode='batch')  [engine]", None, 0,
         lambda: t.lasso_path(X, y, penalty_factor=pf, lower_limits=0.0,
                              path_mode="batch"),
         lambda: t.lasso_path(X, y, penalty_factor=pf, lower_limits=0.0,
                              path_mode="batch", **f64)),
        ("adaptive_lasso_path(X, y)  [scan, engine]", None, 0,
         lambda: t.adaptive_lasso_path(X, y),
         lambda: t.adaptive_lasso_path(X, y, **f64)),
    ]
    outs, first_ms = [], []
    for label, kname, want, call, _ in calls:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        expect = dict.fromkeys(after, 0)
        if kname is not None:
            expect[kname] = want
        smoke.check(after == expect, f"{label}: launches {after} "
                    f"(want {kname or 'none'} x {want})")
        for name, launched in after.items():
            record[name]["launches"] += launched
        print(f"  {label}: first call {first_s:.2f} s on the host clock")
        outs.append(out)
        first_ms.append(first_s * 1e3)

    def idx(cv, lam):
        return int(np.argmin(np.abs(cv.lambdas - lam)))

    for (label, _, _, _, ref_call), out in zip(calls, outs):
        ref = ref_call()
        fit, fit_ref = (out.fit, ref.fit) if hasattr(out, "fit") else (out,
                                                                        ref)
        gap = float(np.abs(to_np(fit.coef) - to_np(fit_ref.coef)).max())
        gap0 = float(np.abs(to_np(fit.beta0) - to_np(fit_ref.beta0)).max())
        finite = bool(np.isfinite(to_np(fit.coef)).all())
        print(f"  {label}: full fit max |coef - f64| {gap:.3e}, |beta0 gap| "
              f"{gap0:.3e}, niter total {int(fit.niter.sum())} (f64 "
              f"{int(fit_ref.niter.sum())})")
        smoke.check(finite and fit.coef.shape == fit_ref.coef.shape,
                    f"{label}: finite, {fit.coef.shape[0]} lambdas")
        smoke.check(gap <= PATH_BAR and gap0 <= PATH_BAR,
                    f"{label}: full fit within {PATH_BAR} of float64")
        if not hasattr(out, "fit"):
            continue
        rel = float(np.max(np.abs(out.cvm - ref.cvm) / np.abs(ref.cvm)))
        rel_sd = float(np.max(np.abs(out.cvsd - ref.cvsd) / np.abs(ref.cvsd)))
        print(f"  {label}: cvm max rel gap {rel:.3e}, cvsd {rel_sd:.3e}; "
              f"lambda_min {out.lambda_min:.6g} (index "
              f"{idx(out, out.lambda_min)}, f64 {idx(ref, ref.lambda_min)}), "
              f"lambda_1se {out.lambda_1se:.6g} (index "
              f"{idx(out, out.lambda_1se)}, f64 {idx(ref, ref.lambda_1se)}), "
              f"min cvm {out.cvm.min():.6f}")
        smoke.check(np.isfinite(out.cvm).all() and np.all(out.cvsd >= 0)
                    and out.cvm.shape == (fit.coef.shape[0],),
                    f"{label}: finite curves of the grid's length")
        smoke.check(rel <= 1e-4, f"{label}: cvm within rtol 1e-4 of float64")
        for key in ("lambda_min", "lambda_1se"):
            i, j = idx(out, getattr(out, key)), idx(ref, getattr(ref, key))
            tie = abs(ref.cvm[i] - ref.cvm[j]) <= 1e-5 * abs(ref.cvm[j])
            smoke.check(i == j or tie, f"{label}: {key} at float64's grid "
                        f"point, or a tie of cvm within rtol 1e-5")

    # predict and assess on the tall CV: float64 on the card, numpy out.
    cv = outs[0]
    i = idx(cv, cv.lambda_min)
    Xt = torch.as_tensor(X, **f32)
    eta = t.predict(cv, X, lam="lambda.min")
    want = (to_np(cv.fit.beta0)[i]
            + X.astype(np.float64) @ to_np(cv.fit.coef)[i])
    pgap = float(np.abs(eta - want).max())
    dgap = float(np.abs(t.predict(cv, Xt, lam="lambda.min") - eta).max())
    print(f"  predict(cv, X, lam='lambda.min'): shape {eta.shape}, max |eta "
          f"- (beta0 + X coef)| {pgap:.3e}; X on the card vs numpy X "
          f"{dgap:.3e}")
    smoke.check(eta.shape == (X.shape[0],) and pgap <= 1e-9 and dgap == 0.0,
                "predict(cv, X, lam='lambda.min') = beta0 + X coef at it")
    a = t.assess(cv, X, y)
    print(f"  assess(cv, X, y) at lambda.1se: "
          + ", ".join(f"{k} {float(v):.6f}" for k, v in a.items()))
    smoke.check(sorted(a) == ["deviance", "mae", "mse"]
                and all(np.isfinite(float(v)) for v in a.values()),
                "assess(cv, X, y) runs")

    # End to end: the kernel paths median of 3 after a warm-up (CUDA
    # events), the engine-bound calls their first call above.
    for (label, kname, _, call, _), ms0 in zip(calls, first_ms):
        if kname is None:
            print(f"  end to end {label}: {ms0:.3f} ms (one call, host "
                  f"clock)")
        else:
            print(f"  end to end {label}: "
                  f"{cuda_median_ms(torch, call, reps=3):.3f} ms (median "
                  f"of 3)")
    yt = torch.as_tensor(y, **f32)
    for what, Xa, ya in (("numpy X, y", X, y), ("X, y on the card", Xt, yt)):
        predict_ms = cuda_median_ms(
            torch, lambda: t.predict(cv, Xa, lam="lambda.min"), reps=3)
        assess_ms = cuda_median_ms(torch, lambda: t.assess(cv, Xa, ya),
                                   reps=3)
        print(f"  end to end predict(cv, X, lam='lambda.min'): "
              f"{predict_ms:.3f} ms; assess(cv, X, y): {assess_ms:.3f} ms "
              f"({what}; medians of 3)")

    # Stages of the tall cv_lasso_path itself, each timed function run to
    # a synchronize: a warm-up, then the median of 3 per stage.
    n = X.shape[0]
    title = f"cv_lasso_path {n} x {X.shape[1]} x 100, {nfolds} folds"
    fold_kernel = "fold sweep > tall_path_batch"
    targets = [(cv_mod, "_as_tensor", "X to the card"),
               (cv_mod, "lasso_path", "full fit"),
               (cv_mod, "_fold_sweep", "fold sweep"),
               (lasso_mod, "standardize", "standardize"),
               (lasso_mod, "_tall_setup", "_tall_setup"),
               (tall_path, "tall_path_batch", "tall_path_batch"),
               (lasso_mod, "recover", "recover"),
               (cv_mod, "_score_reduce_dev", "scoring"),
               (cv_mod, "to_numpy", "to the host")]
    runs = []
    for _ in range(4):
        clock = StageClock(torch, keep=(fold_kernel,))
        with clock.patch(targets):
            t0 = time.perf_counter()
            t.cv_lasso_path(X, y, nfolds=nfolds)
            torch.cuda.synchronize()
            clock.ms["whole call"] = (time.perf_counter() - t0) * 1e3
        runs.append(clock)
    keys = list(runs[1].ms)
    med = {k: statistics.median(r.ms.get(k, 0.0) for r in runs[1:])
           for k in keys}
    for k in keys:
        print(f"  {title} | {k}: {med[k]:.3f} ms ({runs[1].calls.get(k, 1)}"
              f" calls)")
    top = [k for k in keys if " > " not in k and k != "whole call"]
    sweep = [k for k in keys if k.startswith("fold sweep > ")
             and k.count(" > ") == 1]
    print(f"  {title} | fold sweep outside its timed stages (grid scaling, "
          f"own-fold predictors): "
          f"{med['fold sweep'] - sum(med[k] for k in sweep):.3f} ms")
    print(f"  {title} | outside the timed stages (foldid, masks, y, "
          f"choice of lambda): {med['whole call'] - sum(med[k] for k in top):.3f}"
          f" ms")

    # Fold 0's kernel against its plain form, on the inputs the real fold
    # sweep gave it, outside the counted calls.
    args, kwargs = runs[0].args[fold_kernel]
    zk, nk = tall_path.tall_path_batch(*args, **kwargs)
    zp, np_ = tall_path.tall_path_batch_reference(*args, **kwargs)
    fgap = float((zk - zp).abs().max())
    lane_gap = int((nk - np_).abs().max())
    print(f"  tall_path_batch on fold 0's inputs: max |coef gap| {fgap:.3e}, "
          f"niter total {int(nk.sum())}, max lane gap {lane_gap}")
    smoke.check(fgap <= COEF_BAR and lane_gap <= 1,
                f"fold 0: kernel within {COEF_BAR} of plain, niter within 1")
    del runs, args, kwargs


def activeset_problem(n, p, m, seed=123):
    """The JAX package's active-set benchmark problem
    (benchmarks/wide_activeset_bench.py::problem): m normal slopes at
    random columns, noise 0.1."""
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.normal(size=m)
    X = rng.normal(size=(n, p))
    y = X @ b + 0.1 * rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


@contextlib.contextmanager
def activeset_threshold(lasso_mod, p):
    """``_ACTIVESET_AUTO_P`` set to ``p`` for as long as the ``with``
    lasts (past a problem's width: the scan row's dense engine)."""
    saved = lasso_mod._ACTIVESET_AUTO_P
    lasso_mod._ACTIVESET_AUTO_P = p
    try:
        yield
    finally:
        lasso_mod._ACTIVESET_AUTO_P = saved


def to_np(v):
    return v.detach().cpu().numpy().astype(np.float64)


def gap_of(a, b):
    return float(np.abs(to_np(a) - to_np(b)).max())


def counted_call(torch, smoke, record, label, call, want):
    """``call()`` with the launch counts at 0 before and read after;
    ``want`` maps the kernels that must launch to their count (none other
    may); the counts add to ``record``'s.  Returns (result, first call's
    ms on the host clock)."""
    from admm_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = kernels.launch_counts()
    smoke.check(after == {**dict.fromkeys(after, 0), **want},
                f"{label}: launches {after} (want {want or 'none'})")
    for name, launched in after.items():
        record[name]["launches"] += launched
    return out, ms


def held_to(smoke, label, out, ref, bar=PATH_BAR, what="float64",
            fields=("coef", "beta0")):
    """Finite, the reference's shape, each of ``fields`` within ``bar`` of
    the reference's.  Returns the first field's gap."""
    first = getattr(out, fields[0])
    gaps = [gap_of(getattr(out, f), getattr(ref, f)) for f in fields]
    smoke.check(bool(np.isfinite(to_np(first)).all())
                and first.shape == getattr(ref, fields[0]).shape,
                f"{label}: finite, shape {tuple(first.shape)}")
    smoke.check(max(gaps) <= bar,
                f"{label}: within {bar} of {what} ("
                + ", ".join(f"{f} gap {g:.3e}" for f, g in zip(fields, gaps))
                + ")")
    return gaps[0]


def families_phase(torch, smoke, record, X, y, Xw, yw, Xd, yd, Xl, yl):
    """Phase 4c, "traces, active set and the first families": traced
    ``lasso_path`` (scan and batch) and a traced LAD fit, the active-set
    path's three modes at ``ACTIVESET_SIZES``, the
    group lasso (tall and wide), the fused and zero-sum lasso, the relaxed
    lasso, and the five new CV drivers at 2000 x 200 (10 folds, 5 for the
    group, fused and generalized lasso; the relaxed CV at 10000 x 1000).  Every call runs with the launch counts
    at 0 just before it and read just after (they add to the kernels'
    ``launches``), and is held against the port's float64 run on the
    card at ``PATH_BAR``.  Times: the kernel paths' medians of 3 CUDA-event
    timings after a warm-up; the engine-bound calls their first call on
    the host clock; the relaxed lasso and its CV also stage by stage."""
    import admm_tpu_torch as t
    from admm_tpu_torch.kernels import tall_path, wide_path
    from admm_tpu_torch.models import cv as cv_mod
    from admm_tpu_torch.models import lasso as lasso_mod
    from admm_tpu_torch.models import relaxed as relaxed_mod

    print("phase: traces, active set and the first families", flush=True)
    f64 = dict(dtype=torch.float64)
    nfolds = 10

    counted = partial(counted_call, torch, smoke, record)
    held = partial(held_to, smoke)

    # -- Tracing: the engine, never a kernel. -----------------------------
    # The traced path is the float32 engine; so is the untraced path with
    # unit penalty factors (the factors multiply by 1.0 exactly), which
    # it must equal to the bit.  The kernels accumulate in float64, so
    # against them niter is held to the scan kernel's bar against its
    # plain form (totals within max(3, 10%)) and the per-lambda gap shown.
    n, p = X.shape
    ones = np.ones(p)
    for mode, kname in (("scan", "tall_path_scan"),
                        ("batch", "tall_path_batch")):
        label = (f"lasso_path(X, y, path_mode={mode!r}, trace_len=512)  "
                 f"[{n} x {p} x 100, engine]")
        traced, ms = counted(label, lambda: t.lasso_path(
            X, y, path_mode=mode, trace_len=512), {})
        engine, _ = counted(f"lasso_path(X, y, path_mode={mode!r}, "
                            "penalty_factor=ones)  [engine, untraced]",
                            lambda: t.lasso_path(X, y, path_mode=mode,
                                                 penalty_factor=ones), {})
        plain, _ = counted(f"lasso_path(X, y, path_mode={mode!r})",
                           lambda: t.lasso_path(X, y, path_mode=mode),
                           {kname: 1})
        buf = to_np(traced.trace)
        nit = to_np(traced.niter).astype(int)
        nk = to_np(plain.niter).astype(int)
        rows = (~np.isnan(buf[..., 0])).sum(axis=1)
        print(f"  {label}: first call {ms:.1f} ms (host clock), trace "
              f"{tuple(buf.shape)}, niter total {nit.sum()} (kernel "
              f"{nk.sum()}), max niter gap to the kernel per lambda "
              f"{int(np.abs(nit - nk).max())}, coef gap to the kernel "
              f"{gap_of(traced.coef, plain.coef):.3e}")
        smoke.check(traced.trace.shape == (100, 512, 5)
                    and traced.trace.device.type == "cuda",
                    f"{label}: a (100, 512, 5) trace on the card")
        smoke.check(np.array_equal(rows, np.minimum(nit, 512)),
                    f"{label}: recorded rows = min(niter, 512) per lambda")
        smoke.check(torch.equal(traced.coef, engine.coef)
                    and torch.equal(traced.niter, engine.niter),
                    f"{label}: equals the untraced engine to the bit")
        smoke.check(abs(int(nit.sum()) - int(nk.sum()))
                    <= max(3, int(0.1 * nk.sum())),
                    f"{label}: niter total within max(3, 10%) of the "
                    "kernel's")
        smoke.check(gap_of(traced.coef, plain.coef) <= PATH_BAR,
                    f"{label}: within {PATH_BAR} of the kernel path")
    label = f"admm_lad(Xl, yl).opts(trace=True).fit()  [{Xl.shape[0]} x " \
            f"{Xl.shape[1]}, engine]"
    lad_fit, ms = counted(label, lambda: t.admm_lad(Xl, yl).opts(
        trace=True).fit(), {})
    lad_ref = t.lad_fit(Xl, yl, dtype=torch.float64, eps_abs=EPS_L1,
                        eps_rel=EPS_L1)
    rows = int((~np.isnan(lad_fit.trace[:, 0])).sum())
    lgap = float(np.abs(lad_fit.beta[1:] - to_np(lad_ref.coef)).max())
    print(f"  {label}: first call {ms:.1f} ms (host clock), trace "
          f"{lad_fit.trace.shape}, niter {lad_fit.niter}, {rows} rows, max "
          f"|coef - f64| {lgap:.3e}")
    smoke.check(lad_fit.trace.shape == (512, 5)
                and rows == min(lad_fit.niter, 512),
                f"{label}: recorded rows = min(niter, 512)")
    smoke.check(lgap <= LAD_COEF_BAR, f"{label}: within {LAD_COEF_BAR} of "
                "float64")
    smoke.check("resid_primal" in lad_fit.format_trace(),
                f"{label}: format_trace renders the table")

    # -- The active set: three modes at two sizes. ------------------------
    for na, pa, ma, ka in ACTIVESET_SIZES:
        Xa, ya = activeset_problem(na, pa, ma)
        size = f"{na} x {pa} x {ka}"
        # The scan-mode dispatch: one iteration per lambda is enough to
        # see which solver the default mode reaches.
        calls = []
        real = lasso_mod._solve_path_wide_activeset
        lasso_mod._solve_path_wide_activeset = \
            lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            t.lasso_path(Xa, ya, nlambda=ka, maxit=1)
        finally:
            lasso_mod._solve_path_wide_activeset = real
        want_auto = pa >= lasso_mod._ACTIVESET_AUTO_P
        smoke.check(bool(calls) == want_auto,
                    f"{size}: scan mode takes the active set: "
                    f"{bool(calls)} (p = {pa}, _ACTIVESET_AUTO_P = "
                    f"{lasso_mod._ACTIVESET_AUTO_P})")
        rows = {}

        def mode_call(mode, **kw):
            # The scan row is the dense engine: the threshold past p.
            with (activeset_threshold(lasso_mod, pa + 1) if mode == "scan"
                  else contextlib.nullcontext()):
                return t.lasso_path(Xa, ya, nlambda=ka, path_mode=mode, **kw)

        for mode in ("activeset", "scan", "batch"):
            label = f"lasso_path(Xa, ya, path_mode={mode!r})  [{size}]"
            kernel = mode == "batch" and wide_path.fits(na, pa)
            out, ms = counted(label, lambda: mode_call(mode),
                              {"wide_path_batch": 1} if kernel else {})
            if kernel:
                ms = cuda_median_ms(torch, lambda: mode_call(mode), reps=3)
            gap = held(label, out, mode_call(mode, **f64))
            rows[mode] = [out, [ms]]
            print(f"  {label}: {ms:.1f} ms ("
                  + ("wide kernel, median of 3, CUDA events" if kernel
                     else "first call, host clock; "
                     + ("batched engine" if mode == "batch" else "engine"))
                  + f"), niter total {int(to_np(out.niter).sum())}, max "
                  f"{int(to_np(out.niter).max())}, |coef - f64| {gap:.3e}")
        # Two solvers stopped by the same relative test: their gap scales
        # with the response (sd(y) 14 and 20 here), so it is held on the
        # standardized scale, as the JAX package's benchmark reports it.
        agap = gap_of(rows["activeset"][0].coef, rows["scan"][0].coef)
        sd_y = float(np.std(ya.astype(np.float64)))
        smoke.check(agap / sd_y <= PATH_BAR,
                    f"{size}: activeset within {PATH_BAR} of the dense scan "
                    f"on the standardized scale ({agap:.3e} / sd(y) "
                    f"{sd_y:.3f} = {agap / sd_y:.3e})")
        print(f"  active-set table {size}: " + ", ".join(
            f"{m} " + " and ".join(f"{v:.1f}" for v in r[1]) + " ms"
            for m, r in rows.items()))
        del Xa, ya, rows, out
        torch.cuda.empty_cache()

    # -- The families on the flagship (and the wide group lasso). ---------
    groups = np.arange(p) // 10
    Ng, Pg = Xw.shape
    family_calls = [
        (f"group_lasso_path(X, y, groups of 10)  [{n} x {p} x 100, tall, "
         "engine]", lambda **kw: t.group_lasso_path(X, y, groups, **kw)),
        (f"group_lasso_path(Xw, yw, groups of 10)  [{Ng} x {Pg} x 100, wide, "
         "engine]", lambda **kw: t.group_lasso_path(
             Xw, yw, np.arange(Pg) // 10, **kw)),
        (f"zerosum_lasso_path(X, y)  [{n} x {p} x 50, batch, engine]",
         lambda **kw: t.zerosum_lasso_path(X, y, **kw)),
    ]
    for label, call in family_calls:
        out, ms = counted(label, call, {})
        ref = call(**f64)
        gap = held(label, out, ref)
        print(f"  {label}: first call {ms:.1f} ms (host clock), niter total "
              f"{int(to_np(out.niter).sum())} max {int(to_np(out.niter).max())}"
              f", |coef - f64| {gap:.3e}")
        if "zerosum" in label:
            # C b = d holds to solver tolerance (the support threshold drops
            # x's O(eps) entries): as closely as in the float64 run.
            csum = [float(np.abs(to_np(r.coef).sum(axis=1)).max())
                    for r in (out, ref)]
            print(f"  {label}: max |sum_j b_j| {csum[0]:.3e} (float64 "
                  f"{csum[1]:.3e})")
            smoke.check(csum[0] <= 1.5 * csum[1],
                        f"{label}: sum_j b_j = 0 as closely as in float64")

    # The fused lasso.  Its float32 path parts from its float64 path by
    # far more than PATH_BAR here (8.8e-2), and does so in the JAX package
    # too: tests/test_torch_genlasso.py holds the port's float32 error to
    # the JAX package's.  So the float32 call (the default) is timed and
    # its gap shown, and the gate holds the float64 path on the card
    # against the same path on the host's CPU, both stopped at 2000
    # iterations (the top lambdas run to maxit in both precisions).
    label = f"fused_lasso_path(X, y)  [{n} x {p} x 50, batch, engine]"
    out, ms = counted(label, lambda: t.fused_lasso_path(X, y), {})
    ref, ms64 = counted(f"{label}, float64", lambda: t.fused_lasso_path(
        X, y, **f64), {})
    print(f"  {label}: first call {ms:.1f} ms (host clock; float64 "
          f"{ms64:.1f} ms), niter total {int(to_np(out.niter).sum())} max "
          f"{int(to_np(out.niter).max())} (float64 max "
          f"{int(to_np(ref.niter).max())}), float32 |coef - f64| "
          f"{gap_of(out.coef, ref.coef):.3e}")
    smoke.check(bool(torch.isfinite(out.coef).all()),
                f"{label}: float32 finite")
    card = t.fused_lasso_path(X, y, maxit=2000, **f64)
    t0 = time.perf_counter()
    host = t.fused_lasso_path(X, y, maxit=2000, device="cpu", **f64)
    print(f"  {label}, float64, maxit 2000: the host's CPU took "
          f"{time.perf_counter() - t0:.1f} s")
    held(f"{label}, float64, maxit 2000", card, host, bar=1e-8,
         what="the same path on the CPU")

    # -- The relaxed lasso: one tall scan launch, then the refits. --------
    label = f"relaxed_lasso_path(X, y)  [{n} x {p} x 100, 5 gammas]"
    rel, ms = counted(label, lambda: t.relaxed_lasso_path(X, y),
                      {"tall_path_scan": 1})
    rel_ref = t.relaxed_lasso_path(X, y, **f64)
    lasso = t.lasso_path(X, y)
    g1 = int(np.flatnonzero(to_np(rel.gammas) == 1.0)[0])
    smoke.check(torch.equal(rel.coef[g1], lasso.coef)
                and torch.equal(rel.beta0[g1], lasso.beta0),
                f"{label}: gamma = 1 equals lasso_path to the bit")
    gap = held(label, rel, rel_ref)
    print(f"  {label}: first call {ms:.1f} ms (host clock), median of 3 "
          f"{cuda_median_ms(torch, lambda: t.relaxed_lasso_path(X, y), reps=3):.3f}"
          f" ms (CUDA events), |coef - f64| {gap:.3e} over the (5, 100, "
          f"{p}) grid")
    targets = [(relaxed_mod, "lasso_path", "lasso_path"),
               (lasso_mod, "standardize", "standardize"),
               (lasso_mod, "_tall_setup", "_tall_setup"),
               (tall_path, "tall_path_scan", "tall_path_scan"),
               (relaxed_mod, "_masked_refits", "_masked_refits"),
               (relaxed_mod, "standardize", "standardize"),
               (relaxed_mod, "gram", "X'X"),
               (torch.linalg, "cholesky_ex", "batched cholesky_ex"),
               (torch, "cholesky_solve", "cholesky_solve")]
    title = f"relaxed_lasso_path {n} x {p} x 100, 5 gammas"

    def staged(title, targets, call):
        runs = []
        for _ in range(4):
            clock = StageClock(torch)
            with clock.patch(targets):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                clock.ms["whole call"] = (time.perf_counter() - t0) * 1e3
            runs.append(clock)
        keys = list(runs[1].ms)
        for k in keys:
            med = statistics.median(r.ms.get(k, 0.0) for r in runs[1:])
            print(f"  {title} | {k}: {med:.3f} ms "
                  f"({runs[1].calls.get(k, 1)} calls)")

    staged(title, targets, lambda: t.relaxed_lasso_path(X, y))

    # -- The CV drivers. --------------------------------------------------
    nd, pd = Xd.shape
    gd = np.arange(pd) // 10
    C2 = np.vstack([np.ones(pd), np.r_[1.0, -1.0, np.zeros(pd - 2)]])
    # The three slowest CVs (0.6-1.3 s a fold on the engine) run 5 folds, so
    # that the script stays within its time.
    kfolds = 5
    cv_calls = [
        (f"cv_group_lasso_path(Xd, yd, groups of 10, nfolds={kfolds})  "
         f"[{nd} x {pd} x 100]",
         lambda **kw: t.cv_group_lasso_path(Xd, yd, gd, nfolds=kfolds, **kw),
         {}),
        (f"cv_fused_lasso_path(Xd, yd, nfolds={kfolds})  [{nd} x {pd} x 50]",
         lambda **kw: t.cv_fused_lasso_path(Xd, yd, nfolds=kfolds, **kw), {}),
        (f"cv_gen_lasso_path(Xd, yd, D = 1st differences, weights, "
         f"nfolds={kfolds})  [{nd} x {pd} x 50]",
         lambda **kw: t.cv_gen_lasso_path(
             Xd, yd, t.difference_matrix(pd, 1), nfolds=kfolds,
             weights=np.random.default_rng(123).uniform(0.5, 1.5, nd), **kw),
         {}),
        (f"cv_zerosum_lasso_path(Xd, yd)  [{nd} x {pd} x 50]",
         lambda **kw: t.cv_zerosum_lasso_path(Xd, yd, nfolds=nfolds, **kw),
         {}),
        (f"cv_constrained_lasso_path(Xd, yd, 2 rows)  [{nd} x {pd} x 50]",
         lambda **kw: t.cv_constrained_lasso_path(
             Xd, yd, C2, np.array([0.5, 0.0]), nfolds=nfolds, **kw), {}),
        (f"cv_relaxed_lasso_path(X, y)  [{n} x {p} x 100, 5 gammas]",
         lambda **kw: t.cv_relaxed_lasso_path(X, y, nfolds=nfolds, **kw),
         {"tall_path_scan": 1, "tall_path_batch": nfolds}),
    ]

    def idx(lams, lam):
        return int(np.argmin(np.abs(np.asarray(lams) - lam)))

    for label, call, want in cv_calls:
        out, ms = counted(label, call, want)
        ref = call(**f64)
        relaxed = isinstance(out, dict)
        get = (lambda r, k: r[k]) if relaxed else getattr
        fit, fit_ref = get(out, "fit"), get(ref, "fit")
        # The generalized lasso's float32 path is the JAX package's,
        # 1.2e-3 from float64 at this size: its bar is that package's own
        # for the family (2e-3, tests/test_genlasso.py), for the full fit
        # and the CV curve.
        bar, cv_bar = ((2e-3, 2e-3) if "fused" in label or "gen" in label
                       else (PATH_BAR, 1e-4))
        held(f"{label} full fit", fit, fit_ref, bar=bar)
        cvm, cvm_ref = get(out, "cvm"), get(ref, "cvm")
        rel = float(np.max(np.abs(cvm - cvm_ref) / np.abs(cvm_ref)))
        i, j = (idx(get(r, "lambdas"), get(r, "lambda_min"))
                for r in (out, ref))
        cvm_at = lambda r, k: (r["cvm"].min(axis=0)[k] if relaxed
                               else r.cvm[k])
        tie = abs(cvm_at(ref, i) - cvm_at(ref, j)) <= 1e-5 * abs(
            cvm_at(ref, j))
        print(f"  {label}: first call {ms:.1f} ms (host clock), cvm "
              f"{cvm.shape} max rel gap to f64 {rel:.3e}, lambda_min index "
              f"{i} (f64 {j})"
              + (f", gamma_min {out['gamma_min']} (f64 {ref['gamma_min']})"
                 if relaxed else ""))
        smoke.check(np.isfinite(cvm).all() and cvm.shape == cvm_ref.shape,
                    f"{label}: finite curves")
        smoke.check(rel <= cv_bar,
                    f"{label}: cvm within rtol {cv_bar} of float64")
        smoke.check(i == j or tie, f"{label}: lambda_min at float64's grid "
                    "point, or a tie of cvm within rtol 1e-5")
        if not relaxed:
            eta = t.predict(out, Xd[:4], lam="lambda.min")
            smoke.check(eta.shape == (4,) and np.isfinite(eta).all(),
                        f"{label}: predict(cv, X, lam='lambda.min') runs")
    title = f"cv_relaxed_lasso_path {n} x {p} x 100, {nfolds} folds"
    staged(title, [(relaxed_mod, "relaxed_lasso_path", "full fit"),
                   (cv_mod, "_fold_sweep", "fold sweep"),
                   (lasso_mod, "_tall_setup", "_tall_setup"),
                   (tall_path, "tall_path_scan", "tall_path_scan"),
                   (tall_path, "tall_path_batch", "tall_path_batch"),
                   (relaxed_mod, "_masked_refits", "_masked_refits")],
           lambda: t.cv_relaxed_lasso_path(X, y, nfolds=nfolds))


def second_problems(seed=123):
    """The second families' problems, after the JAX package's benchmark
    generators (benchmarks/run_baselines.py ``bench_round4`` and
    ``bench_multi``), each from its own ``default_rng(seed)``: the
    10000 x 500 design of the SLOPE and sqrt-lasso rows (10 normal slopes,
    unit noise), the 2000 x 100 SVM problem, the 10000 x 1000 x K=8
    multi-task problem (100 random rows of uniform(-1, 1) slopes), the
    2000 x 200 x C=5 multinomial problem (10 rows of uniform(-1.5, 1.5)
    slopes, labels drawn from the softmax), and for the quantile path, which
    has no benchmark row, the GLM sweep's 2000 x 200 design
    (:func:`glm_problem`'s) with the JAX package's quantile test response
    (0.7 + X b + t(3) noise)."""
    out = {}
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(10000, 500))
    b = np.zeros(500)
    b[:10] = rng.normal(size=10)
    out["sqrt"] = (X.astype(np.float32),
                   (X @ b + rng.normal(size=10000)).astype(np.float32))
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, 100))
    out["svm"] = (X.astype(np.float32),
                  np.sign(X @ rng.normal(size=100)
                          + 0.3 * rng.normal(size=2000)))
    rng = np.random.default_rng(seed)
    B = np.zeros((1000, 8))
    B[rng.choice(1000, 100, replace=False)] = rng.uniform(-1, 1, (100, 8))
    X = rng.normal(size=(10000, 1000))
    out["multitask"] = (X.astype(np.float32),
                        (X @ B + rng.normal(size=(10000, 8)))
                        .astype(np.float32))
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, 200))
    BC = np.zeros((200, 5))
    BC[:10] = rng.uniform(-1.5, 1.5, (10, 5))
    eta = X @ BC
    pr = np.exp(eta - eta.max(axis=1, keepdims=True))
    pr /= pr.sum(axis=1, keepdims=True)
    out["multinomial"] = (X.astype(np.float32),
                          np.array([rng.choice(5, p=pi) for pi in pr]))
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, 200))
    b = np.zeros(200)
    b[:10] = rng.uniform(0.5, 1.5, 10)
    out["quantile"] = (X.astype(np.float32),
                       (0.7 + X @ b + rng.standard_t(3, size=2000))
                       .astype(np.float32))
    return out


def pinball_objective(res, X, y):
    """(T, L) objectives of a quantile path on the original scale: the
    mean check loss plus lambda times the l1 norm of the standardized
    slopes (the solved objective, times sd(y))."""
    X = X.astype(np.float64)
    y = y.astype(np.float64)
    taus = to_np(res.taus)[:, None, None]
    coef = to_np(res.coef)                              # (T, L, p)
    r = y - (to_np(res.beta0)[..., None] + coef @ X.T)
    loss = np.where(r > 0, taus * r, (taus - 1.0) * r).mean(axis=-1)
    scale = X.std(axis=0) / y.std()
    return loss + to_np(res.lambdas) * (np.abs(coef) * scale).sum(axis=-1)


def second_families_phase(torch, smoke, record):
    """Phase 4d, "the second families": ``sqrt_lasso_path`` (batch and
    scan), ``slope_path`` (auto -> scan), ``svm_path``,
    ``multitask_lasso_path`` and ``multitask_nuclear_path``,
    ``multinomial_lasso_path`` at the JAX package's benchmark sizes
    (:func:`second_problems`), then their CV drivers with 10 folds, and
    ``cv_quantile_lasso_path`` with 3 at maxit 10000 (its full fit is the
    quantile path's cell).  None may launch a kernel: every call runs with
    the launch counts at 0 just before it and read just after.  Each is held against
    the port's float64 run on the card at ``PATH_BAR``, the quantile path
    as LAD is (the pinball objective within ``LAD_OBJ_BAR``; coefficients
    within ``QUANTILE_COEF_BAR``); times are first calls on the host
    clock.  Then the sorted-l1 prox's two isotonic projections
    on the card at p = 500 and 4096."""
    import admm_tpu_torch as t
    from admm_tpu_torch.models import slope as slope_mod

    print("phase: the second families", flush=True)
    t_phase = time.perf_counter()
    counted = partial(counted_call, torch, smoke, record)
    held = partial(held_to, smoke)
    f64 = dict(dtype=torch.float64)
    nfolds = 10
    P = second_problems()
    Xs, ys = P["sqrt"]
    Xv, yv = P["svm"]
    Xm, Ym = P["multitask"]
    Xc, yc = P["multinomial"]
    Xq, yq = P["quantile"]
    taus = [0.25, 0.5, 0.75]
    ns, ps = Xs.shape
    nm, pm = Xm.shape
    nc, pc = Xc.shape

    def line(label, out, ms, gap, extra=""):
        nit = to_np(out.niter)
        print(f"  {label}: first call {ms:.1f} ms (host clock), niter total "
              f"{int(nit.sum())} max {int(nit.max())}, max gap to f64 "
              f"{gap:.3e}{extra}", flush=True)

    paths = [
        (f"sqrt_lasso_path(Xs, ys)  [{ns} x {ps} x 30, batch]",
         lambda **kw: t.sqrt_lasso_path(Xs, ys, **kw), ("coef", "beta0")),
        (f"sqrt_lasso_path(Xs, ys, path_mode='scan')  [{ns} x {ps} x 30]",
         lambda **kw: t.sqrt_lasso_path(Xs, ys, path_mode="scan", **kw),
         ("coef", "beta0")),
        (f"slope_path(Xs, ys)  [{ns} x {ps} x 30, BH q = 0.1, auto -> scan]",
         lambda **kw: t.slope_path(Xs, ys, **kw), ("coef", "beta0")),
        (f"svm_path(Xv, yv)  [{Xv.shape[0]} x {Xv.shape[1]} x 20 C, "
         "squared hinge]", lambda **kw: t.svm_path(Xv, yv, **kw),
         ("coef", "intercept")),
        (f"multitask_lasso_path(Xm, Ym)  [{nm} x {pm} x K=8 x 50]",
         lambda **kw: t.multitask_lasso_path(Xm, Ym, **kw),
         ("coef", "beta0")),
        (f"multitask_nuclear_path(Xm, Ym)  [{nm} x {pm} x K=8 x 50]",
         lambda **kw: t.multitask_nuclear_path(Xm, Ym, **kw),
         ("coef", "beta0")),
        (f"multinomial_lasso_path(Xc, yc, nlambda=50)  [{nc} x {pc} x C=5]",
         lambda **kw: t.multinomial_lasso_path(Xc, yc, nlambda=50, **kw),
         ("coef", "beta0")),
    ]
    for label, call, fields in paths:
        out, ms = counted(label, call, {})
        ref = call(**f64)
        gap = held(label, out, ref, fields=fields)
        line(label, out, ms, gap)
        del out, ref
    # -- The CV drivers. ---------------------------------------------------
    def lam_index(grid, lam):
        return int(np.argmin(np.abs(np.asarray(grid) - lam)))

    def curve(label, cvm, cvm_ref, grid, lam, lam_ref, bar, what):
        rel = float(np.max(np.abs(cvm - cvm_ref) / np.abs(cvm_ref)))
        i, j = lam_index(grid, lam), lam_index(grid, lam_ref)
        tie = abs(cvm_ref[i] - cvm_ref[j]) <= 1e-5 * abs(cvm_ref[j])
        smoke.check(np.isfinite(cvm).all() and cvm.shape == cvm_ref.shape,
                    f"{label}: finite curves")
        smoke.check(bool(np.all(np.abs(cvm - cvm_ref)
                                <= bar * np.abs(cvm_ref))),
                    f"{label}: cvm within {what} of float64 (max rel gap "
                    f"{rel:.3e})")
        smoke.check(i == j or tie, f"{label}: lambda_min at float64's grid "
                    f"point ({i} vs {j}) or a cvm tie within rtol 1e-5")
        return rel

    cv_calls = [
        (f"cv_sqrt_lasso_path(Xs, ys)  [{ns} x {ps} x 30, {nfolds} folds]",
         lambda **kw: t.cv_sqrt_lasso_path(Xs, ys, nfolds=nfolds, **kw)),
        (f"cv_slope_path(Xs, ys)  [{ns} x {ps} x 30, {nfolds} folds]",
         lambda **kw: t.cv_slope_path(Xs, ys, nfolds=nfolds, **kw)),
        (f"cv_multitask_lasso_path(Xm, Ym)  [{nm} x {pm} x K=8 x 50, "
         f"{nfolds} folds]",
         lambda **kw: t.cv_multitask_lasso_path(Xm, Ym, nfolds=nfolds, **kw)),
        (f"cv_multinomial_path(Xc, yc, nlambda=50)  [{nc} x {pc} x C=5, "
         f"{nfolds} folds]",
         lambda **kw: t.cv_multinomial_path(Xc, yc, nlambda=50,
                                            nfolds=nfolds, **kw)),
    ]
    for label, call in cv_calls:
        out, ms = counted(label, call, {})
        ref = call(**f64)
        held(f"{label} full fit", out.fit, ref.fit)
        rel = curve(label, out.cvm, ref.cvm, ref.lambdas, out.lambda_min,
                    ref.lambda_min, 1e-4, "rtol 1e-4")
        eta = t.predict(out, (Xm if "multitask" in label else Xc
                              if "multinomial" in label else Xs)[:4],
                        lam="lambda.min")
        smoke.check(np.isfinite(eta).all() and eta.shape[0] == 4,
                    f"{label}: predict(cv, X, lam='lambda.min') runs")
        print(f"  {label}: first call {ms:.1f} ms (host clock), cvm max rel "
              f"gap to f64 {rel:.3e}, lambda_min index "
              f"{lam_index(ref.lambdas, out.lambda_min)} (f64 "
              f"{lam_index(ref.lambdas, ref.lambda_min)}), full fit niter "
              f"total {int(to_np(out.fit.niter).sum())}", flush=True)
        del out, ref
    # The SVM's default measure is misclassification, which moves in steps
    # of 1/n: a row at the margin may flip between precisions, so the
    # curve is held to two rows.
    label = (f"cv_svm_path(Xv, yv)  [{Xv.shape[0]} x {Xv.shape[1]} x 20 C, "
             f"{nfolds} folds, class measure]")
    out, ms = counted(label, lambda: t.cv_svm_path(Xv, yv, nfolds=nfolds), {})
    ref = t.cv_svm_path(Xv, yv, nfolds=nfolds, **f64)
    held(f"{label} full fit", out.fit, ref.fit, fields=("coef", "intercept"))
    flips = float(np.max(np.abs(out.cvm - ref.cvm)) * Xv.shape[0])
    smoke.check(flips <= 2.0 + 1e-6, f"{label}: cvm within 2 rows of "
                f"float64 ({flips:.1f} rows)")
    i, j = lam_index(ref.Cs, out.C_min), lam_index(ref.Cs, ref.C_min)
    smoke.check(i == j or abs(ref.cvm[i] - ref.cvm[j]) <= 2.0 / Xv.shape[0],
                f"{label}: C_min at float64's grid point ({i} vs {j}) or "
                "within 2 rows of its cvm")
    cls = t.predict(out, Xv[:4], type="class")
    smoke.check(set(np.unique(cls)) <= {-1.0, 1.0},
                f"{label}: predict(cv, X, type='class') gives the labels")
    print(f"  {label}: first call {ms:.1f} ms (host clock), cvm max gap "
          f"{flips:.1f} rows, C_min index {i} (f64 {j})", flush=True)
    # The quantile path and its CV, in one call: its full fit is the
    # path the user calls, held as LAD is (pinball objective within
    # LAD_OBJ_BAR of float64) with the coefficients at QUANTILE_COEF_BAR;
    # the curves at QUANTILE_CV_BAR.  Some lanes run to maxit (20000), so
    # each solve takes maxit iterations (2 ms each, whatever the number of
    # lanes): 3 folds, not 10, and maxit 10000, not the default 20000, in
    # both precisions.  (With 2 folds the curves part by 2.1e-3.)
    qfolds, qmaxit = 3, 10000
    label = (f"cv_quantile_lasso_path(Xq, yq, tau={taus}, maxit={qmaxit})  "
             f"[{Xq.shape[0]} x {Xq.shape[1]} x 30, {qfolds} folds]")
    out, ms = counted(label, lambda: t.cv_quantile_lasso_path(
        Xq, yq, tau=taus, nfolds=qfolds, maxit=qmaxit), {})
    ref = t.cv_quantile_lasso_path(Xq, yq, tau=taus, nfolds=qfolds,
                                   maxit=qmaxit, **f64)
    fit, fit_ref = out["fit"], ref["fit"]
    gap = held(f"{label} full fit", fit, fit_ref, bar=QUANTILE_COEF_BAR)
    ratio = float(np.max(pinball_objective(fit, Xq, yq)
                         / pinball_objective(fit_ref, Xq, yq)))
    smoke.check(ratio <= LAD_OBJ_BAR, f"{label} full fit: pinball objective "
                f"within {LAD_OBJ_BAR} of float64 (worst ratio {ratio:.6f})")
    rels = [curve(f"{label} tau {tau}", out["cvm"][k], ref["cvm"][k],
                  ref["lambdas"][k], out["lambda_min"][k],
                  ref["lambda_min"][k], QUANTILE_CV_BAR,
                  f"rtol {QUANTILE_CV_BAR}")
            for k, tau in enumerate(taus)]
    eta = t.predict(out, Xq[:4], tau=0.5, lam="lambda.min")
    smoke.check(np.isfinite(eta).all() and eta.shape == (4,),
                f"{label}: predict(cv, X, tau=0.5) runs")
    nit, nit_ref = to_np(fit.niter), to_np(fit_ref.niter)
    print(f"  {label}: first call {ms:.1f} ms (host clock), full fit niter "
          f"total {int(nit.sum())} max {int(nit.max())} (f64 "
          f"{int(nit_ref.sum())}, max {int(nit_ref.max())}), coef gap to "
          f"f64 {gap:.3e}, worst objective ratio {ratio:.6f}, cvm max rel gap "
          f"to f64 {max(rels):.3e}", flush=True)
    del out, ref, fit, fit_ref

    # -- The sorted-l1 prox's two projections on the card. -----------------
    # Timed in float32; the two agree in float64 (in float32 the dense
    # table's prefix-sum differences round at ~1e-7 * sum|v|).
    for p in (500, 4096):
        v64 = torch.as_tensor(np.random.default_rng(123).normal(size=p),
                              dtype=torch.float64, device="cuda")
        lam64 = torch.as_tensor(t.bh_sequence(p, 0.1) * 0.05,
                                dtype=torch.float64, device="cuda")
        gap = gap_of(slope_mod.prox_sorted_l1(v64, lam64, "dense"),
                     slope_mod.prox_sorted_l1(v64, lam64, "pava"))
        smoke.check(gap <= 1e-10, f"prox_sorted_l1 p = {p}: dense and pava "
                    f"agree in float64 ({gap:.2e})")
        v, lam = v64.float(), lam64.float()
        ms = {m: cuda_median_ms(torch, lambda m=m: slope_mod.prox_sorted_l1(
            v, lam, m)) for m in ("dense", "pava")}
        print(f"  prox_sorted_l1 p = {p}: dense {ms['dense']:.3f} ms, pava "
              f"{ms['pava']:.3f} ms (median of 5, CUDA events)")
    print(f"  phase 'the second families': {time.perf_counter() - t_phase:.1f}"
          " s on the host clock", flush=True)


# The last families: the JAX package's own float32 bars where they are
# larger than PATH_BAR.  The graphical lasso: its float32 paths by the two
# x-updates within 5e-3 (tests/test_glasso.py::test_newton_eigh_xupdates_
# agree); the Cox CV curves: the JAX package's bar between its two CV
# protocols, rtol 5e-4 (tests/test_cox.py).
GLASSO_BAR = 5e-3
COX_CV_BAR = 5e-4
# The glasso scan-against-batch comparison: paired calls per size.
GLASSO_PAIRS = 3


def last_problems(seed=123):
    """The last families' problems, after the JAX package's benchmark
    generators (benchmarks/run_baselines.py), each from its own
    ``default_rng(seed)``: the Cox path's (``bench_multi``: the 2000 x 200
    multinomial design, times exponential with rate exp(0.5 X b), 50%
    events), the Cox CV's (``bench_cv``: 10 signed slopes, 70% events),
    the graphical lasso's 2000 x p normal data (``bench_round4``, p = 200
    and 500), PCP's rank-5 500 x 500 and 2000 x 2000 matrices with 5% of
    the entries corrupted by +-10 (``bench_round4``), and for matrix
    completion and the PCP CV, which have no benchmark row, the 500 x 500
    matrices with 20% of the entries unobserved."""
    out = {}
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, 200)).astype(np.float32)
    BC = np.zeros((200, 5), np.float32)
    BC[:10] = rng.uniform(-1.5, 1.5, (10, 5))
    eta = X @ BC
    pr = np.exp(eta - eta.max(axis=1, keepdims=True))
    pr /= pr.sum(axis=1, keepdims=True)
    for pi in pr:                       # the multinomial labels' draws
        rng.choice(5, p=pi)
    t = rng.exponential(np.exp(-(X @ BC[:, 0] * 0.5)))
    out["cox"] = (X, t, (rng.uniform(size=2000) < 0.5).astype(np.float32))
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2000, 200))
    b = np.zeros(200)
    b[:10] = rng.uniform(0.5, 1.5, 10) * rng.choice([-1, 1], 10)
    t = rng.exponential(np.exp(-(X @ b)))
    out["cox_cv"] = (X.astype(np.float32), t,
                     (rng.uniform(size=2000) < 0.7).astype(np.float32))
    for p in (200, 500):
        out[f"glasso{p}"] = np.random.default_rng(seed).normal(
            size=(2000, p)).astype(np.float32)
    for m, scale in ((500, 1.0), (2000, 1.0 / np.sqrt(5))):
        rng = np.random.default_rng(seed)
        L0 = rng.normal(size=(m, 5)) @ rng.normal(size=(5, m)) * scale
        S0 = np.zeros((m, m))
        hit = rng.uniform(size=S0.shape) < 0.05
        S0[hit] = 10 * rng.choice([-1.0, 1.0], size=hit.sum())
        out[f"rpca{m}"] = (L0 + S0).astype(np.float32)
        if m == 500:
            out["low_rank500"] = L0.astype(np.float32)
            out["observed500"] = rng.uniform(size=S0.shape) >= 0.2
    return out


def last_families_phase(torch, smoke, record, X, y):
    """Phase 4e, "the last families and glmnet": ``cox_lasso_path`` (2000
    x 200, 30 lambdas, scan) and ``cv_cox_path`` (5 folds, 20 lambdas,
    onepass), ``glasso_path`` (p = 200 scan and batch, p = 500 scan) and
    ``cv_glasso_path`` (p = 200), ``rpca`` (500 x 500 exact SVT, 2000 x 2000
    partial SVT at rank 5), ``matrix_complete`` and ``cv_rpca`` (500 x
    500, 20% unobserved; 3 lambdas, 3 folds) at the JAX package's
    benchmark sizes (:func:`last_problems`), none of which may launch a
    kernel; then the
    glmnet front end on the kernel paths: ``glmnet`` gaussian on the
    flagship problem (the tall scan kernel once), binomial and huber on
    ``logistic_problem(2000, 200, 30)`` (the GLM kernel once each),
    ``cv_glmnet`` gaussian on the flagship (the tall batch kernel 11
    times) and ``big_glm`` gaussian at 2000 x 200 (the tall scan kernel
    once), each equal to its family driver's result on the same inputs to
    the bit.  Every call runs with the launch counts at 0 just before it
    and read just after, and is held against the port's float64 run on
    the card (``PATH_BAR``, or ``GLASSO_BAR``/``COX_CV_BAR``); times are
    first calls on the host clock.  Then the glasso path's scan against
    its batch mode (``GLASSO_PAIRS`` paired calls at p = 200 and 500), and
    one lane each of the two logdet proxes and of the exact and partial
    SVT (CUDA events)."""
    from types import SimpleNamespace

    import admm_tpu_torch as t
    from admm_tpu_torch.models import glasso as glasso_mod
    from admm_tpu_torch.models import rpca as rpca_mod

    print("phase: the last families and glmnet", flush=True)
    t_phase = time.perf_counter()
    counted = partial(counted_call, torch, smoke, record)
    f64 = dict(dtype=torch.float64)
    P = last_problems()

    def line(label, out, ms, gap, extra=""):
        nit = to_np(out.niter).reshape(-1)
        print(f"  {label}: first call {ms:.1f} ms (host clock), niter total "
              f"{int(nit.sum())} max {int(nit.max())}, max gap to f64 "
              f"{gap:.3e}{extra}", flush=True)

    def curve(label, out, ref, bar):
        rel = float(np.max(np.abs(out.cvm - ref.cvm) / np.abs(ref.cvm)))
        grid = np.asarray(ref.lambdas)
        i = int(np.argmin(np.abs(grid - out.lambda_min)))
        j = int(np.argmin(np.abs(grid - ref.lambda_min)))
        tie = abs(ref.cvm[i] - ref.cvm[j]) <= 1e-5 * abs(ref.cvm[j])
        smoke.check(np.isfinite(out.cvm).all()
                    and out.cvm.shape == ref.cvm.shape,
                    f"{label}: finite curves")
        smoke.check(rel <= bar, f"{label}: cvm within rtol {bar} of float64 "
                    f"(max rel gap {rel:.3e})")
        smoke.check(i == j or tie, f"{label}: lambda_min at float64's grid "
                    f"point ({i} vs {j}) or a cvm tie within rtol 1e-5")
        return rel, i, j

    # -- Cox. ---------------------------------------------------------------
    Xc, tc, dc = P["cox"]
    label = f"cox_lasso_path(Xc, t, d, nlambda=30)  [{Xc.shape[0]} x " \
        f"{Xc.shape[1]}, scan, 50% events]"
    call = lambda **kw: t.cox_lasso_path(Xc, tc, dc, nlambda=30, **kw)
    out, ms = counted(label, call, {})
    ref = call(**f64)
    line(label, out, ms, held_to(smoke, label, out, ref, fields=("coef",)))
    Xv, tv, dv = P["cox_cv"]
    label = (f"cv_cox_path(Xv, t, d, nfolds=5, nlambda=20, "
             f"cv_mode='onepass')  [{Xv.shape[0]} x {Xv.shape[1]}, 70% "
             "events]")
    call = lambda **kw: t.cv_cox_path(Xv, tv, dv, nfolds=5, nlambda=20,
                                      cv_mode="onepass", seed=1, **kw)
    out, ms = counted(label, call, {})
    ref = call(**f64)
    held_to(smoke, f"{label} full fit", out.fit, ref.fit, fields=("coef",))
    rel, i, j = curve(label, out, ref, COX_CV_BAR)
    sf = t.survfit_cox(out, Xv, tv, dv, Xnew=Xv[:4])
    smoke.check(bool(np.isfinite(sf.surv).all()) and sf.surv.shape[1] == 4
                and bool(np.all(np.diff(sf.surv, axis=0) <= 0)),
                f"{label}: survfit_cox(cv) gives finite falling curves")
    print(f"  {label}: first call {ms:.1f} ms (host clock), cvm max rel gap "
          f"to f64 {rel:.3e}, lambda_min index {i} (f64 {j}), full fit niter"
          f" total {int(to_np(out.fit.niter).sum())}", flush=True)
    del out, ref

    # -- The graphical lasso. -----------------------------------------------
    for p, modes in ((200, ("scan", "batch")), (500, ("scan",))):
        A = P[f"glasso{p}"]
        for mode in modes:
            label = (f"glasso_path(A, path_mode='{mode}')  [2000 x {p}, 20 "
                     "lambdas, newton]")
            call = lambda mode=mode, A=A, **kw: t.glasso_path(
                A, path_mode=mode, **kw)
            out, ms = counted(label, call, {})
            ref = call(**f64)
            gap = held_to(smoke, label, out, ref, bar=GLASSO_BAR,
                          fields=("precision",))
            line(label, out, ms, gap, f" (bar {GLASSO_BAR})")
            del out, ref
    A = P["glasso200"]
    label = "cv_glasso_path(A, nfolds=5)  [2000 x 200, 20 lambdas]"
    call = lambda **kw: t.cv_glasso_path(A, nfolds=5, **kw)
    out, ms = counted(label, call, {})
    ref = call(**f64)
    held_to(smoke, f"{label} full fit", out.fit, ref.fit, bar=GLASSO_BAR,
            fields=("precision",))
    rel, i, j = curve(label, out, ref, 1e-4)
    print(f"  {label}: first call {ms:.1f} ms (host clock), cvm max rel gap "
          f"to f64 {rel:.3e}, lambda_min index {i} (f64 {j})", flush=True)
    del out, ref

    # -- Robust PCA and matrix completion. ------------------------------------
    rpca_kw = dict(maxit=2000, eps_abs=1e-6, eps_rel=1e-5)
    for m, rank in ((500, None), (2000, 5)):
        M = P[f"rpca{m}"]
        label = (f"rpca(M, rank={rank}, maxit=2000, eps_abs=1e-6, "
                 f"eps_rel=1e-5)  [{m} x {m}, "
                 f"{'exact' if rank is None else 'partial'} SVT]")
        call = lambda M=M, rank=rank, **kw: t.rpca(M, rank=rank, **rpca_kw,
                                                   **kw)
        out, ms = counted(label, call, {})
        ref = call(**f64)
        gap = held_to(smoke, label, out, ref, fields=("low_rank", "sparse"))
        sat = "" if rank is None else \
            f", rank_saturated {bool(out.rank_saturated)}"
        if rank is not None:
            smoke.check(not bool(out.rank_saturated),
                        f"{label}: the rank bound holds at the solution")
        line(label, out, ms, gap, sat)
        del out, ref
    L0, obs = P["low_rank500"], P["observed500"]
    label = "matrix_complete(L0, observed)  [500 x 500, 20% unobserved]"
    call = lambda **kw: SimpleNamespace(**dict(zip(
        ("low_rank", "niter"), t.matrix_complete(L0, obs, **kw))))
    out, ms = counted(label, call, {})
    ref = call(**f64)
    gap = held_to(smoke, label, out, ref, fields=("low_rank",))
    rec = float(np.abs(to_np(out.low_rank) - L0).max() / np.abs(L0).max())
    line(label, out, ms, gap, f", max |L - L0| / max |L0| {rec:.3e}")
    M = P["rpca500"]
    # Three lambdas within 1.5x of the universal 1/sqrt(500) and 3 folds:
    # at 3x away the masked fold paths take hundreds of 30 ms SVDs each.
    label = ("cv_rpca(M, observed, nlambda=3, lambda_scale=1.5, nfolds=3)  "
             "[500 x 500, 20% unobserved]")
    call = lambda **kw: t.cv_rpca(M, observed=obs, nlambda=3,
                                  lambda_scale=1.5, nfolds=3, **rpca_kw,
                                  **kw)
    out, ms = counted(label, call, {})
    ref = call(**f64)
    held_to(smoke, f"{label} full fit", out.fit, ref.fit,
            fields=("low_rank", "sparse"))
    rel, i, j = curve(label, out, ref, 1e-4)
    print(f"  {label}: first call {ms:.1f} ms (host clock), cvm max rel gap "
          f"to f64 {rel:.3e}, lambda_min index {i} (f64 {j}), full fit niter"
          f" {to_np(out.fit.niter).astype(int).tolist()}", flush=True)
    del out, ref

    # -- The glmnet front end on the kernel paths. --------------------------
    Xb, yb = logistic_problem(2000, 200, 30)
    Xg2, yg2 = make_problem(2000, 200, 20)
    fronts = [
        (f"glmnet(X, y, 'gaussian')  [{X.shape[0]} x {X.shape[1]}, 100 "
         "lambdas, scan]",
         lambda **kw: t.glmnet(X, y, "gaussian", **kw),
         lambda: t.lasso_path(X, y), {"tall_path_scan": 1}),
        ("glmnet(Xb, yb, 'binomial', nlambda=30)  [2000 x 200]",
         lambda **kw: t.glmnet(Xb, yb, "binomial", nlambda=30, **kw),
         lambda: t.logistic_lasso_path(Xb, yb, nlambda=30),
         {"glm_batch_path": 1}),
        ("glmnet(Xb, yb, 'huber', nlambda=30)  [2000 x 200]",
         lambda **kw: t.glmnet(Xb, yb, "huber", nlambda=30, **kw),
         lambda: t.huber_lasso_path(Xb, yb, nlambda=30),
         {"glm_batch_path": 1}),
        (f"cv_glmnet(X, y, 'gaussian')  [{X.shape[0]} x {X.shape[1]}, 100 "
         "lambdas, 10 folds]",
         lambda **kw: t.cv_glmnet(X, y, "gaussian", **kw),
         lambda: t.cv_lasso_path(X, y), {"tall_path_batch": 11}),
        ("big_glm(Xg2, yg2, 'gaussian')  [2000 x 200, lambda = 0]",
         lambda **kw: t.big_glm(Xg2, yg2, "gaussian", **kw),
         lambda: t.lasso_path(Xg2, yg2, lambdas=np.zeros(1), rho=1.0,
                              lower_limits=None, upper_limits=None,
                              intercept=True), {"tall_path_scan": 1}),
    ]
    for label, call, driver, want in fronts:
        out, ms = counted(label, call, want)
        own = driver()
        fit, own_fit = (out.fit, own.fit) if hasattr(out, "fit") \
            else (out, own)
        same = all(torch.equal(getattr(fit, f), getattr(own_fit, f))
                   for f in ("coef", "beta0", "niter"))
        if hasattr(out, "cvm"):
            same = same and np.array_equal(out.cvm, own.cvm)
        smoke.check(same, f"{label}: the family driver's result to the bit")
        ref = call(**f64)
        gap = held_to(smoke, label, fit, ref.fit if hasattr(ref, "fit")
                      else ref)
        extra = ""
        if hasattr(out, "cvm"):
            rel, i, j = curve(label, out, ref, 1e-4)
            extra = f", cvm max rel gap {rel:.3e}, lambda_min index {i} " \
                f"(f64 {j})"
        line(label, fit, ms, gap, extra)
        del out, own, ref

    # -- The glasso path: scan against batch, paired calls. -------------------
    for p in (200, 500):
        A = torch.as_tensor(P[f"glasso{p}"], dtype=torch.float32,
                            device="cuda")
        times = {"scan": [], "batch": []}
        niter = {}
        for k in range(GLASSO_PAIRS):
            for mode in (("scan", "batch") if k % 2 == 0
                         else ("batch", "scan")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = t.glasso_path(A, path_mode=mode)
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
                nit = to_np(res.niter)
                niter[mode] = (int(nit.sum()), int(nit.max()))
        print(f"  glasso_path p = {p}, 20 lambdas, {GLASSO_PAIRS} paired "
              f"calls (host clock, ms): scan "
              f"{[round(v, 1) for v in times['scan']]} (niter total "
              f"{niter['scan'][0]}), batch "
              f"{[round(v, 1) for v in times['batch']]} (niter total "
              f"{niter['batch'][0]}, slowest lane {niter['batch'][1]})",
              flush=True)

    # -- One lane of each prox, CUDA events. --------------------------------
    for p in (200, 500):
        S = glasso_mod.empirical_covariance(P[f"glasso{p}"])
        G = torch.eye(S.shape[0], device="cuda") - S - 0.05
        G = 0.5 * (G + G.mT)
        rho = torch.tensor(1.0, device="cuda")
        ms = {name: cuda_median_ms(torch, lambda fn=fn: fn(G, rho))
              for name, fn in (("newton", glasso_mod._logdet_prox_newton),
                               ("eigh", glasso_mod._logdet_prox_eigh))}
        gap = gap_of(glasso_mod._logdet_prox_newton(G, rho),
                     glasso_mod._logdet_prox_eigh(G.double(), rho.double()))
        print(f"  logdet prox p = {p}: newton {ms['newton']:.3f} ms, eigh "
              f"{ms['eigh']:.3f} ms (median of 5, CUDA events); newton "
              f"float32 against eigh float64 {gap:.2e}", flush=True)
    for m, r in ((500, 5), (2000, 5)):
        A = torch.as_tensor(P[f"rpca{m}"], dtype=torch.float32, device="cuda")
        V = rpca_mod._start_basis(A.shape[1], r + rpca_mod._SVT_OVERSAMPLE,
                                  torch.float32, "cuda")
        # The threshold at the (r + oversample + 1)-th singular value:
        # the exact SVT's rank then fits the partial basis.
        tau = float(torch.linalg.svdvals(A)[r + rpca_mod._SVT_OVERSAMPLE])
        V = rpca_mod.svt_partial(A, tau, V, 8)[1]       # a warm basis
        ms_exact = cuda_median_ms(torch, lambda: rpca_mod.svt(A, tau))
        ms_part = cuda_median_ms(
            torch, lambda: rpca_mod.svt_partial(A, tau, V))
        gap = gap_of(rpca_mod.svt(A, tau), rpca_mod.svt_partial(A, tau, V)[0])
        print(f"  SVT {m} x {m}: exact {ms_exact:.3f} ms, partial (rank "
              f"{r} + {rpca_mod._SVT_OVERSAMPLE}, 2 power iterations, warm "
              f"basis) {ms_part:.3f} ms (median of 5, CUDA events); gap "
              f"{gap:.2e}", flush=True)
    print(f"  phase 'the last families and glmnet': "
          f"{time.perf_counter() - t_phase:.1f} s on the host clock",
          flush=True)


# niter totals (and the slowest lambda) of the JAX package's float32
# consensus on the CPU, one device, seed 123 (the figures that motivated
# this phase); the port's own are printed beside them.
JAX_CPU_NITER = {("lasso", 2): (1886, 76), ("lasso", 4): (2147, 93),
                 ("lasso", 8): (2462, 119), ("wide", 2): (6228, 219),
                 ("enet", 4): (1717, 58), ("group", 4): (3603, 224)}
# The reference's published consensus times (BASELINE.md, padmm).
PADMM_MS = {"lasso": 512.5, "wide": 5345.6}


def chunk_sweep(torch, cons, fit, modes, reps=3):
    """Median-of-``reps`` host-clock times of ``fit`` for each (loop,
    chunk) of ``modes``, in turns there and back: "eager" runs the chunk
    op by op, "graph" replays it as a CUDA graph; ``_CHUNK`` iterations
    between two host reads."""
    chunk, graphed = cons._CHUNK, cons._graphed
    times = {}
    try:
        for mode, k in modes + modes[::-1]:
            cons._CHUNK = k
            cons._graphed = (graphed if mode == "graph"
                             else lambda advance, *a: advance)
            times.setdefault((mode, k), []).append(
                host_median_ms(torch, fit, reps=reps)[0])
    finally:
        cons._CHUNK, cons._graphed = chunk, graphed
    return times


def consensus_phase(torch, smoke, record, X, y, Xw, yw, A, b, x0):
    """Phase 4f, "consensus": consensus ADMM over W row blocks on the
    card through the builders' ``.parallel(nthread)`` and the
    ``parallel_*`` drivers: the flagship and the wide Lasso path at W = 2
    (first call and median of 3, against the reference's published
    ``padmm`` times), the flagship at W = 4 and 8, the Elastic Net at
    W = 4, Basis Pursuit at W = 2, and at W = 4 the group, SLOPE and
    zero-sum masters, the logistic, Poisson and multinomial Newton workers
    and the multi-task rows and nuclear masters.  None may launch a
    kernel; each is held against the port's float64 consensus at the same
    W on the card (``PATH_BAR``; BP, against float64 at the same eps, at
    ``BP_F64_BAR`` and ``BP_RECOVERY_BAR``).  Then the flagship at W = 2
    by loop: op by op with a host read every iteration, and as a CUDA
    graph of 1 and of ``_CHUNK`` iterations per host read
    (:func:`chunk_sweep`)."""
    from types import SimpleNamespace

    import admm_tpu_torch as t
    from admm_tpu_torch.parallel import consensus as cons

    print("phase: consensus", flush=True)
    t_phase = time.perf_counter()
    counted = partial(counted_call, torch, smoke, record)
    held = partial(held_to, smoke)
    f64 = dict(dtype=torch.float64)
    n, p = X.shape
    P = second_problems()
    Xs, ys = P["sqrt"]
    Xm, Ym = P["multitask"]
    Xc, yc = P["multinomial"]
    Xg, yg = glm_problem(2000, 200)

    def as_path(fit):
        """An ADMMLassoFit's sparse beta as (beta0, coef, niter) tensors."""
        dense = fit.beta.toarray()
        return SimpleNamespace(beta0=torch.as_tensor(dense[0]),
                               coef=torch.as_tensor(dense[1:].T),
                               niter=torch.as_tensor(fit.niter))

    def line(label, out, ms, gap, key=None):
        nit = to_np(out.niter).astype(np.int64).reshape(-1)
        jax = JAX_CPU_NITER.get(key)
        print(f"  {label}: first call {ms:.1f} ms (host clock), niter total "
              f"{int(nit.sum())}, slowest lambda {int(nit.max())}"
              + (f" (JAX CPU float32: {jax[0]}, {jax[1]})" if jax else "")
              + f", {ms / max(int(nit.sum()), 1):.3f} ms per iteration with "
              f"set-up, max gap to f64 {gap:.3e}", flush=True)

    calls = [
        (f"admm_lasso(X, y).parallel(2).fit()  [{n} x {p} x 100, W = 2]",
         lambda: as_path(t.admm_lasso(X, y).parallel(2).fit()),
         lambda: t.parallel_lasso_path(X, y, nworkers=2, **f64),
         ("lasso", 2)),
        *[(f"parallel_lasso_path(X, y, nworkers={W})  [{n} x {p} x 100]",
           partial(t.parallel_lasso_path, X, y, nworkers=W),
           partial(t.parallel_lasso_path, X, y, nworkers=W, **f64),
           ("lasso", W)) for W in (4, 8)],
        (f"admm_lasso(Xw, yw).parallel(2).fit()  [{Xw.shape[0]} x "
         f"{Xw.shape[1]} x 100, W = 2, Woodbury]",
         lambda: as_path(t.admm_lasso(Xw, yw).parallel(2).fit()),
         lambda: t.parallel_lasso_path(Xw, yw, nworkers=2, **f64),
         ("wide", 2)),
        (f"admm_enet(X, y).penalty(alpha=0.6).parallel(4).fit()  [{n} x {p} "
         "x 100]",
         lambda: as_path(t.admm_enet(X, y).penalty(alpha=0.6).parallel(4)
                         .fit()),
         lambda: t.parallel_enet_path(X, y, alpha=0.6, nworkers=4, **f64),
         ("enet", 4)),
        (f"parallel_group_lasso_path(X, y, groups of 10, nworkers=4)  "
         f"[{n} x {p} x 100]",
         lambda **kw: t.parallel_group_lasso_path(X, y, np.arange(p) // 10,
                                                  nworkers=4, **kw),
         None, ("group", 4)),
        (f"parallel_slope_path(Xs, ys, nworkers=4, nlambda=30)  "
         f"[{Xs.shape[0]} x {Xs.shape[1]}]",
         lambda **kw: t.parallel_slope_path(Xs, ys, nworkers=4, nlambda=30,
                                            **kw), None, None),
        (f"parallel_zerosum_lasso_path(Xs, ys, nworkers=4, nlambda=30)  "
         f"[{Xs.shape[0]} x {Xs.shape[1]}]",
         lambda **kw: t.parallel_zerosum_lasso_path(
             Xs, ys, nworkers=4, nlambda=30, **kw), None, None),
        ("parallel_logistic_lasso_path(Xg, yg, nworkers=4, nlambda=30)  "
         "[2000 x 200, fixed Hessian]",
         lambda **kw: t.parallel_logistic_lasso_path(
             Xg, yg["logistic"], nworkers=4, nlambda=30, **kw), None, None),
        ("parallel_poisson_lasso_path(Xg, yg, nworkers=4, nlambda=30)  "
         "[2000 x 200, exact Hessian]",
         lambda **kw: t.parallel_poisson_lasso_path(
             Xg, yg["poisson"], nworkers=4, nlambda=30, **kw), None, None),
        ("parallel_multinomial_lasso_path(Xc, yc, nworkers=4, nlambda=30)  "
         "[2000 x 200, C = 5]",
         lambda **kw: t.parallel_multinomial_lasso_path(
             Xc, yc, nworkers=4, nlambda=30, **kw), None, None),
        *[(f"parallel_multitask_lasso_path(Xm, Ym, nworkers=4, "
           f"penalty='{pen}')  [{Xm.shape[0]} x {Xm.shape[1]} x K = 8 x 50]",
           partial(t.parallel_multitask_lasso_path, Xm, Ym, nworkers=4,
                   penalty=pen), None, None) for pen in ("rows", "nuclear")],
    ]
    for label, call, ref_call, key in calls:
        out, ms = counted(label, call, {})
        ref = ref_call() if ref_call is not None else call(**f64)
        gap = held(label, out, ref)
        line(label, out, ms, gap, key)
        del out, ref
    # -- Basis Pursuit by consensus (the reference's never-built parbp). ---
    label = (f"admm_bp(A, b).parallel(2).fit()  [{A.shape[0]} x "
             f"{A.shape[1]}, signal 0, W = 2]")
    out, ms = counted(label, lambda: t.admm_bp(A, b).parallel(2).fit(), {})
    ref = t.parallel_bp_fit(A, b, nworkers=2, dtype=torch.float64,
                            eps_abs=EPS_L1, eps_rel=EPS_L1)
    coef = out.beta.toarray()[:, 0]
    gap = float(np.abs(coef - to_np(ref.coef)).max())
    rec = float(np.abs(coef - x0).max())
    smoke.check(bool(np.isfinite(coef).all()) and coef.shape == x0.shape,
                f"{label}: finite, shape")
    smoke.check(gap <= BP_F64_BAR, f"{label}: within {BP_F64_BAR} of "
                f"float64 ({gap:.3e})")
    smoke.check(rec <= BP_RECOVERY_BAR, f"{label}: recovery error "
                f"{rec:.3e} <= {BP_RECOVERY_BAR}")
    print(f"  {label}: first call {ms:.1f} ms (host clock), niter "
          f"{out.niter} (f64 {int(ref.niter)}), max gap to f64 {gap:.3e}, "
          f"max |coef - true signal| {rec:.3e}", flush=True)
    # -- End to end against the reference's padmm, and the chunk size. -----
    for key, (Xn, yn) in (("lasso", (X, y)), ("wide", (Xw, yw))):
        fit = lambda: t.admm_lasso(Xn, yn).parallel(2).fit()
        ms, out = host_median_ms(torch, fit, reps=3)
        print(f"  admm_lasso().parallel(2).fit() {Xn.shape[0]} x "
              f"{Xn.shape[1]}: {ms:.1f} ms, median of 3 (host clock, "
              f"_CHUNK = {cons._CHUNK}; reference padmm {PADMM_MS[key]} ms), "
              f"{ms / int(out.niter.sum()):.3f} ms per iteration", flush=True)
    times = chunk_sweep(torch, cons, lambda: t.admm_lasso(X, y).parallel(2)
                        .fit(), [("eager", 1), ("graph", 1),
                                 ("graph", cons._CHUNK)])
    print("  flagship at W = 2 by loop (median of 3 each, in turns there and "
          "back): " + ", ".join(f"{m} _CHUNK = {k}: "
                                + ", ".join(f"{v:.1f}" for v in vs) + " ms"
                                for (m, k), vs in times.items()), flush=True)
    print(f"  phase 'consensus': {time.perf_counter() - t_phase:.1f} s on "
          "the host clock", flush=True)


# The checkpointed flagship's chunk.
DIAG_CHUNK = 10


def diag_problems(X, y):
    """The checkpointed families' problems: the full-size ones that the
    earlier phases build (the flagship X, y; :data:`DANTZIG_SHAPE`'s;
    :func:`glm_problem`'s; :func:`second_problems`' and
    :func:`last_problems`'), and for the quantile path alone the 50 x 5
    corner of its CPU parity test's regression (tests/test_torch_checkpoint_
    families.py), from ``default_rng(123)``: its engine runs 1-1.5 ms an
    iteration on the card and up to 20000 iterations a lambda, so one run
    at 2000 x 200 would take tens of seconds and three of them the
    phase's budget."""
    second, last = second_problems(), last_problems()
    rng = np.random.default_rng(123)
    Xq = rng.normal(size=(120, 12))
    bq = rng.uniform(size=12) * (rng.uniform(size=12) < 0.5)
    yq = 1.5 + Xq @ bq + 0.3 * rng.normal(size=120)
    Xg, yg = glm_problem(2000, 200)
    return dict(flagship=(X, y), dantzig=make_problem(*DANTZIG_SHAPE[:2], 20),
                glm=(Xg, yg), quantile=(Xq[:50, :5], yq[:50]),
                **{k: second[k] for k in ("sqrt", "svm", "multitask",
                                          "multinomial")},
                **{k: last[k] for k in ("cox", "glasso500", "rpca500",
                                        "rpca2000")})


def diag_cases(t, diag, P):
    """The 15 family drivers' cases on :func:`diag_problems`' ``P``:
    (label, driver, its positional arguments, its options, the one-shot
    path (``**kw`` -> result) whose grid it is given, the grid's field,
    the fields held to the bit and to the bar, the family's bar).  The
    one-shot path runs on its own grid of a few points (``nlambda``,
    ``nC``); the driver gets that grid (``grid`` None: the options hold
    it) and cuts it into three chunks."""
    from admm_tpu_torch.models.genlasso import difference_matrix
    from admm_tpu_torch.models.glm import binomial, poisson

    X, y = P["flagship"]
    Xd, yd = P["dantzig"]
    Xg, yg = P["glm"]
    Xs, ys = P["sqrt"]
    Xv, yv = P["svm"]
    Xm, Ym = P["multitask"]
    Xc, yc = P["multinomial"]
    Xx, tx, dx = P["cox"]
    Xq, yq = P["quantile"]
    groups = np.arange(X.shape[1]) // 10
    D = difference_matrix(Xd.shape[1], 1)
    C0 = np.ones((1, X.shape[1]))
    tau, qlams = np.array([0.3, 0.7]), np.array([0.05, 0.02])
    rpca_kw = dict(maxit=2000, eps_abs=1e-6, eps_rel=1e-5)
    lam, coef = "lambdas", ("coef", "beta0")
    return [
        ("dantzig", diag.checkpointed_dantzig_path, (Xd, yd), {},
         lambda **kw: t.dantzig_path(Xd, yd, nlambda=12, **kw), lam, coef,
         PATH_BAR),
        ("group lasso (groups of 10)", diag.checkpointed_group_lasso_path,
         (X, y, groups), {},
         lambda **kw: t.group_lasso_path(X, y, groups, nlambda=12, **kw),
         lam, coef,
         PATH_BAR),
        ("glm binomial (fixed)", diag.checkpointed_glm_path,
         (Xg, yg["logistic"], binomial()), dict(hessian="fixed"),
         lambda **kw: t.glm_lasso_path(Xg, yg["logistic"], binomial(),
                                       nlambda=12, path_mode="scan",
                                       hessian="fixed", **kw), lam, coef,
         PATH_BAR),
        ("glm poisson (exact)", diag.checkpointed_glm_path,
         (Xg, yg["poisson"], poisson()), dict(hessian="exact"),
         lambda **kw: t.glm_lasso_path(Xg, yg["poisson"], poisson(),
                                       nlambda=12, path_mode="scan",
                                       hessian="exact", **kw), lam, coef,
         PATH_BAR),
        ("fused lasso (D = 1st differences)", diag.checkpointed_gen_lasso_path,
         (Xd, yd, D), {},
         lambda **kw: t.gen_lasso_path(Xd, yd, D, nlambda=12,
                                       path_mode="scan", **kw), lam, coef,
         2e-3),
        ("multi-task rows", diag.checkpointed_multitask_lasso_path, (Xm, Ym),
         {}, lambda **kw: t.multitask_lasso_path(Xm, Ym, nlambda=12,
                                                 path_mode="scan", **kw),
         lam, coef, PATH_BAR),
        ("multi-task nuclear", diag.checkpointed_multitask_lasso_path,
         (Xm, Ym), dict(penalty="nuclear"),
         lambda **kw: t.multitask_nuclear_path(Xm, Ym, nlambda=12,
                                               path_mode="scan", **kw),
         lam, coef, PATH_BAR),
        ("multinomial", diag.checkpointed_multinomial_path, (Xc, yc), {},
         lambda **kw: t.multinomial_lasso_path(Xc, yc, nlambda=12,
                                               path_mode="scan", **kw),
         lam, coef, PATH_BAR),
        ("SLOPE", diag.checkpointed_slope_path, (Xs, ys), {},
         lambda **kw: t.slope_path(Xs, ys, nlambda=12, path_mode="scan",
                                   **kw), lam, coef, PATH_BAR),
        ("graphical lasso (p = 500)", diag.checkpointed_glasso_path,
         (P["glasso500"],), {},
         lambda **kw: t.glasso_path(P["glasso500"], nlambda=12,
                                    path_mode="scan", **kw), lam,
         ("precision",), GLASSO_BAR),
        ("SVM", diag.checkpointed_svm_path, (Xv, yv), {},
         lambda **kw: t.svm_path(Xv, yv, nC=12, path_mode="scan", **kw),
         "Cs", ("coef", "intercept"), PATH_BAR),
        ("Cox", diag.checkpointed_cox_path, (Xx, tx, dx), {},
         lambda **kw: t.cox_lasso_path(Xx, tx, dx, nlambda=12, **kw), lam,
         ("coef",), PATH_BAR),
        ("square-root lasso", diag.checkpointed_sqrt_lasso_path, (Xs, ys),
         {}, lambda **kw: t.sqrt_lasso_path(Xs, ys, nlambda=12,
                                            path_mode="scan", **kw),
         lam, coef, PATH_BAR),
        ("zero-sum lasso", diag.checkpointed_constrained_lasso_path,
         (X, y, C0), {},
         lambda **kw: t.constrained_lasso_path(X, y, C0, nlambda=12,
                                               path_mode="scan", **kw),
         lam, coef, PATH_BAR),
        ("relaxed lasso", diag.checkpointed_relaxed_lasso_path, (X, y), {},
         lambda **kw: t.relaxed_lasso_path(X, y, nlambda=12, **kw), lam,
         coef + ("refit_coef",), PATH_BAR),
        ("quantile (2 taus x 2 lambdas, CPU test size)",
         diag.checkpointed_quantile_lasso_path, (Xq, yq),
         dict(tau=tau, lambdas=qlams, eps_abs=1e-4, eps_rel=1e-4),
         lambda **kw: t.quantile_lasso_path(
             Xq, yq, tau=tau, lambdas=qlams, eps_abs=1e-4, eps_rel=1e-4,
             path_mode="scan", **kw), None, coef, QUANTILE_COEF_BAR),
        ("robust PCA (exact SVT)", diag.checkpointed_rpca_path,
         (P["rpca500"],), dict(rpca_kw),
         lambda **kw: t.rpca_path(P["rpca500"], nlambda=3, **rpca_kw, **kw),
         lam, ("low_rank", "sparse"), PATH_BAR),
        ("robust PCA (partial SVT, rank 5)", diag.checkpointed_rpca_path,
         (P["rpca2000"],), dict(rpca_kw, rank=5),
         lambda **kw: t.rpca_path(P["rpca2000"], nlambda=3, rank=5,
                                  **rpca_kw, **kw),
         lam, ("low_rank", "sparse"), PATH_BAR),
    ]


def diag_phase(torch, smoke, record, X, y, Xw, yw):
    """Phase 4g, "diagnostics": the checkpointed drivers
    (``admm_tpu_torch.diag.checkpoint``) and the profiler on the card.

    The checkpointed Lasso on the flagship (the 100 lambdas ``lasso_path``
    picks, ``chunk_size=10``) and on the wide problem, and the consensus
    Lasso on the flagship at W = 2, each run whole, stopped after 4 chunks
    and resumed: the resumed result equals the whole run's to the bit
    (coef, beta0, niter), the file is gone afterwards, and the path is
    within ``PATH_BAR`` of the port's float64 one-shot path (consensus:
    float64 consensus) on the card; each run's time, one save's time and
    the file's size are printed.  Then the other 15 drivers on the
    full-size problems of the earlier phases (:func:`diag_problems`,
    :func:`diag_cases`; the quantile path alone at its CPU test's size),
    each on the grid of a few points that its float32 one-shot path
    picks, in three chunks, stopped after one and resumed: to the bit,
    and within their family's bar of that one-shot path on the card.  No
    driver may launch a kernel (they run the engines).  Then the native
    host packer against SciPy at the flagship fit's ``beta``.  Then
    ``diag.profile.trace`` around the flagship's ``lasso_path`` and
    ``admm_lasso().fit()`` inside ``annotate``: the trace must hold both
    tall kernels and the annotation; their device times are returned for
    the kernel table.  Then ``device_memory_profile``."""
    import json
    import os
    import tempfile

    import admm_tpu_torch as t
    from admm_tpu_torch import diag
    from admm_tpu_torch.data.standardize import standardize
    from admm_tpu_torch.diag import checkpoint as ck_mod
    from admm_tpu_torch.models.lasso import _auto_lambdas

    print("phase: diagnostics", flush=True)
    t_phase = time.perf_counter()
    counted = partial(counted_call, torch, smoke, record)
    f32 = dict(dtype=torch.float32, device="cuda")
    saves = []
    real_save = ck_mod.save_pytree

    def timed_save(path, tree, **extras):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(path, tree, **extras)
        saves.append(((time.perf_counter() - t0) * 1e3,
                      os.path.getsize(path)))

    def same_bits(label, a, b, fields):
        """``fields`` may be dotted ("fit.niter")."""
        for f in fields:
            get = lambda r: functools.reduce(getattr, f.split("."), r)
            smoke.check(torch.equal(get(a), get(b)),
                        f"{label}: resumed {f} equals the whole run's to "
                        "the bit")

    def crash_resume(label, driver, args, kw, stop, fields):
        """Whole, stopped after ``stop`` chunks, resumed: (whole run,
        host-clock ms of the three runs)."""
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "run.npz")
            ms = []
            whole, m = counted(f"{label}: whole run", lambda: driver(
                *args, checkpoint=os.path.join(tmp, "whole.npz"), **kw), {})
            ms.append(m)
            out, m = counted(f"{label}: stopped after {stop} chunks",
                             lambda: driver(*args, checkpoint=ck,
                                            _stop_after_chunks=stop, **kw),
                             {})
            ms.append(m)
            smoke.check(out is None and os.path.exists(ck),
                        f"{label}: stopped run left its checkpoint")
            res, m = counted(f"{label}: resumed", lambda: driver(
                *args, checkpoint=ck, **kw), {})
            ms.append(m)
            smoke.check(not os.path.exists(ck),
                        f"{label}: checkpoint deleted on completion")
        same_bits(label, res, whole, fields)
        return whole, ms

    # -- The flagship and the wide Lasso, the consensus flagship. --------
    def grid(Xn, yn, ratio):
        Xs, ys, st = standardize(torch.as_tensor(Xn, **f32),
                                 torch.as_tensor(yn, **f32),
                                 standardize_x=True, intercept=True)
        return _auto_lambdas(Xs, ys, st, 100, ratio, 1.0, False).cpu().numpy()

    big = [
        ("checkpointed_lasso_path flagship", diag.checkpointed_lasso_path,
         (X, y), dict(lambdas=grid(X, y, 1e-4)),
         lambda kw: t.lasso_path(X, y, dtype=torch.float64, **kw)),
        ("checkpointed_lasso_path wide", diag.checkpointed_lasso_path,
         (Xw, yw), dict(lambdas=grid(Xw, yw, 1e-2)),
         lambda kw: t.lasso_path(Xw, yw, dtype=torch.float64, **kw)),
        ("checkpointed_parallel_lasso_path flagship, W = 2",
         diag.checkpointed_parallel_lasso_path, (X, y),
         dict(lambdas=grid(X, y, 1e-4), nworkers=2),
         lambda kw: t.parallel_lasso_path(X, y, dtype=torch.float64, **kw)),
    ]
    ck_mod.save_pytree = timed_save
    try:
        for label, driver, args, kw, ref_call in big:
            n_, p_ = args[0].shape
            label = f"{label}  [{n_} x {p_} x 100, chunk_size={DIAG_CHUNK}]"
            saves.clear()
            whole, ms = crash_resume(label, driver, args,
                                     dict(kw, chunk_size=DIAG_CHUNK, **f32),
                                     4, ("coef", "beta0", "niter"))
            ref = ref_call(kw)
            gap = held_to(smoke, label, whole, ref)
            save_ms = [m for m, _ in saves]
            nit = to_np(whole.niter).astype(np.int64)
            print(f"  {label}: whole {ms[0]:.1f} ms, stopped after 4 chunks "
                  f"{ms[1]:.1f} ms, resumed {ms[2]:.1f} ms (host clock); "
                  f"{len(saves)} saves, median {statistics.median(save_ms):.2f}"
                  f" ms, file {saves[-1][1]} bytes at the end; niter total "
                  f"{int(nit.sum())}, max gap to float64 {gap:.3e}",
                  flush=True)
            del whole, ref
    finally:
        ck_mod.save_pytree = real_save

    # -- The other 15 drivers at full size (the quantile path at its CPU
    # test's). -------------------------------------------------------------
    t_small = time.perf_counter()
    for name, driver, args, kw, one_shot, grid_of, fields, bar in \
            diag_cases(t, diag, diag_problems(X, y)):
        label = f"checkpointed {name}"
        ref = one_shot(**f32)
        if grid_of is not None:
            kw = {**kw, grid_of: to_np(getattr(ref, grid_of))}
        nlam = len(kw["Cs" if grid_of == "Cs" else "lambdas"])
        chunk = -(-nlam // 3)
        whole, ms = crash_resume(
            label, driver, args, {**kw, "chunk_size": chunk, **f32}, 1,
            fields + ("fit.niter" if name == "relaxed lasso" else "niter",))
        gap = held_to(smoke, label, whole, ref, bar=bar,
                      what="the float32 one-shot path", fields=fields)
        niter = to_np(getattr(whole, "fit", whole).niter)
        print(f"  {label}  [{' x '.join(map(str, args[0].shape))}, {nlam} "
              f"points, chunk_size={chunk}]: whole {ms[0]:.1f} ms, stopped "
              f"after 1 chunk {ms[1]:.1f} ms, resumed {ms[2]:.1f} ms (host "
              f"clock); niter total {int(niter.sum())} max {int(niter.max())}"
              f", gap {gap:.3e} (bar {bar})", flush=True)
        del whole, ref
    print(f"  the 15 family drivers: {time.perf_counter() - t_small:.1f} s "
          "on the host clock", flush=True)

    # -- The native host packer against SciPy at the flagship fit's beta. --
    from scipy import sparse

    from admm_tpu_torch import _native

    fit = t.admm_lasso(X, y).fit()
    dense = fit.beta.toarray()                       # (p + 1, nlambda)
    beta0, coefs = dense[0].copy(), dense[1:].T.copy()
    smoke.check(_native.get_lib() is not None,
                "native host packer: g++ built native/admm_host.cpp")
    native_ms, packed = host_median_ms(
        torch, lambda: _native.pack_beta_csc(beta0, coefs), reps=21)
    scipy_ms, want = host_median_ms(torch, lambda: sparse.csc_matrix(
        np.concatenate([beta0[:, None], coefs], axis=1).T), reps=21)
    smoke.check(all(np.array_equal(getattr(packed, k), getattr(want, k))
                    for k in ("indptr", "indices", "data")),
                "native host packer: SciPy's CSC to the bit")
    print(f"  pack_beta_csc {coefs.shape[0]} x {coefs.shape[1] + 1} "
          f"({fit.beta.nnz} nonzeros): native {native_ms:.3f} ms, SciPy "
          f"{scipy_ms:.3f} ms (median of 21, host clock)", flush=True)

    # -- The profiler. -----------------------------------------------------
    label = "diag.profile.trace(lasso_path + admm_lasso().fit(), flagship)"
    with tempfile.TemporaryDirectory() as logdir:
        def traced():
            with diag.profile.trace(logdir):
                with diag.annotate("flagship"):
                    t.lasso_path(X, y)
                    t.admm_lasso(X, y).fit()

        _, ms = counted(label, traced,
                        {"tall_path_scan": 1, "tall_path_batch": 1})
        files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        smoke.check(len(files) == 1, f"{label}: one trace file ({files})")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(files[0])
    trace_ms = {}
    for name in ("tall_path_scan", "tall_path_batch"):
        durs = [e["dur"] / 1e3 for e in events if e.get("cat") == "kernel"
                and f"{name}_kernel" in e.get("name", "")]
        smoke.check(len(durs) == 1, f"{label}: the trace holds "
                    f"{name}_kernel once ({len(durs)})")
        trace_ms[name] = sum(durs)
    smoke.check(any(e.get("name") == "flagship" for e in events),
                f"{label}: the trace holds the annotation")
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    print(f"  {label}: {ms:.1f} ms traced (host clock), {len(events)} events,"
          f" {len(kernel_events)} device kernels, {size} bytes; "
          + ", ".join(f"{k}_kernel {v:.3f} ms on the device"
                      for k, v in trace_ms.items()), flush=True)

    # -- The memory snapshot. ----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "memory.pickle")
        diag.device_memory_profile(path)
        size = os.path.getsize(path)
    smoke.check(size > 0, f"device_memory_profile: {size} bytes")
    print(f"  device_memory_profile: {size} bytes; peak allocated "
          f"{torch.cuda.max_memory_allocated()} bytes over the script so "
          "far", flush=True)
    print(f"  phase 'diagnostics': {time.perf_counter() - t_phase:.1f} s on "
          "the host clock", flush=True)
    return trace_ms


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
    from admm_tpu_torch.api import _sparse_beta
    from admm_tpu_torch.data.standardize import recover, standardize
    from admm_tpu_torch.core.engine import make_batched_solver
    from admm_tpu_torch.kernels import (_build, bp, glm, lad, tall_path,
                                        wide_path)
    from admm_tpu_torch.models.bp import _bp_fit, _bp_fit_engine, _bp_setup
    from admm_tpu_torch.models.glm import (_glm_auto_rho, _glm_engine,
                                           _glm_fixed_minv, binomial, huber,
                                           prep_design, recover_glm)
    from admm_tpu_torch.models.lad import _hat_matrix, _lad_setup
    from admm_tpu_torch.models.lasso import (_auto_lambdas,
                                             _batched_cold_states, _linspace,
                                             _tall_setup, _wide_setup)

    smoke = Smoke()
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # 1. The card and the settings.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)
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
    # The host packer of the builders' sparse beta (g++, first use).
    from admm_tpu_torch import _native
    cached = _native._SO.exists()
    t0 = time.perf_counter()
    smoke.check(_native.get_lib() is not None,
                "native host packer: native/admm_host.cpp built and loaded")
    print(f"  native host packer {'loaded from _build/' if cached else 'built'}"
          f" in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. Kernel vs plain at the main path's shapes.
    X, y = make_problem()
    Xw, yw = make_problem(1000, 2000, 100)
    Xl, yl = lad_problem(1000, 500)
    Xl5, yl5 = lad_problem(5000, 1000)
    A, B, X0 = bp_problem(1000, 2000, 100, m=100)
    nd, pd, kd = DANTZIG_SHAPE
    Xd, yd = make_problem(nd, pd, 20)
    ng, pg, kg = GLM_SHAPE
    nG, pG, kG = GLM_LARGE_SHAPE
    Xg, yg = glm_problem(ng, pg)
    XG, yG = logistic_problem(nG, pG)
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

    def lad_inputs(Xn, yn):
        """What ``lad_fit(intercept=False)`` hands the kernel, plus the
        pieces of the recovery solve."""
        Xa, ys, _, Ginv, ynorm = _lad_setup(torch.as_tensor(Xn, **f32),
                                            torch.as_tensor(yn, **f32), False)
        args = (_hat_matrix(Xa, Ginv), ys.contiguous(), RHO_L1, EPS_L1,
                EPS_L1, float(ynorm), MAXIT)
        return args, (Xa, ys, Ginv)

    def bp_inputs():
        At, Bt = torch.as_tensor(A, **f32), torch.as_tensor(B, **f32)
        Winv = _bp_setup(At)
        AAAB = (Bt @ (Winv @ At)).contiguous()
        return At.contiguous(), Winv.contiguous(), AAAB

    def glm_lambdas(Xa, yt, fam, nlam, ratio=1e-2):
        """The auto grid of ``glm_lasso_path`` (intercept, no weights)."""
        r0 = fam.null_resid(yt, True)
        lam0 = torch.max(torch.abs(Xa[:, 1:].mT @ r0)) / Xa.shape[0]
        return torch.exp(_linspace(torch.log(lam0), torch.log(ratio * lam0),
                                   nlam))

    def glm_inputs(Xn, yn, fam, nlam):
        """What ``glm_lasso_path(X, y, fam, nlambda=nlam)`` hands the
        kernel, plus the pieces of the float32 engine on the same problem."""
        yt = torch.as_tensor(yn, **f32)
        Xa, pen_mask, _, _ = prep_design(torch.as_tensor(Xn, **f32), True,
                                         True)
        rho_g = _glm_auto_rho(fam, -1.0)
        Minv_g = _glm_fixed_minv(Xa, fam, rho_g).contiguous()
        lams = glm_lambdas(Xa, yt, fam, nlam).contiguous()
        args = (Xa.contiguous(), Minv_g, yt, pen_mask, lams, rho_g, EPS, EPS,
                1.0, MAXIT)
        return args, dict(family=fam.name, huber_m=fam.param, newton_steps=2)

    Minv, Xty, ilams, rho = tall_inputs()
    Xs_w, ys_w, ilams_w, rhos_w, sprad_w, lambda0_w = wide_inputs()
    lad_args, lad_rec = lad_inputs(Xl, yl)
    lad5_args, lad5_rec = lad_inputs(Xl5, yl5)
    At, Winv, AAAB = bp_inputs()
    glm_cases = {   # label: (kernel arguments, keywords, family)
        f"glm_batch_path {nG} x {pG} x {kG} binomial":
            (*glm_inputs(XG, yG, binomial(), kG), binomial()),
        f"glm_batch_path {ng} x {pg} x {kg} binomial":
            (*glm_inputs(Xg, yg["logistic"], binomial(), kg), binomial()),
        f"glm_batch_path {ng} x {pg} x {kg} huber":
            (*glm_inputs(Xg, yg["huber"], huber(HUBER_M), kg),
             huber(HUBER_M)),
    }
    glm_large = next(iter(glm_cases))
    torch.cuda.synchronize()
    tall_args = (Minv, Xty, ilams, rho, EPS, EPS, 1.0, MAXIT)
    wide_args = (Xs_w, ys_w, ilams_w, rhos_w, sprad_w, lambda0_w, EPS, EPS,
                 1.0, MAXIT)
    bp_args = (At, Winv, AAAB, RHO_L1, EPS_L1, EPS_L1, MAXIT)
    bp1_args = (At, Winv, AAAB[:1].contiguous(), RHO_L1, EPS_L1, EPS_L1,
                MAXIT)
    P, (Nw, Pw), K = Minv.shape[0], Xs_w.shape, ilams.shape[0]
    Nl, (Nb, Pb), Mb = lad_args[0].shape[0], At.shape, AAAB.shape[0]

    def glm_work(args, kw):
        """(bytes in + out, operations per lane-iteration) of a GLM solve."""
        (n_, q_), k_ = args[0].shape, args[4].shape[0]
        return (4 * (n_ * q_ + q_ * q_ + n_ + q_ + k_ + k_ * q_ + k_),
                kw["newton_steps"] * (4 * n_ * q_ + 2 * q_ * q_))

    def glm_fns(label):
        """(kernel, plain) of one GLM case, each taking the case's args."""
        kw = glm_cases[label][1]
        return (partial(glm.glm_batch_path, **kw),
                partial(glm.glm_batch_path_reference, **kw))
    # name: (kernel, plain, args, source, replaces,
    #        bytes in + out, operations per lane-iteration)
    cases = {
        "tall_path_batch": (tall_path.tall_path_batch,
                            tall_path.tall_path_batch_reference, tall_args,
                            "admm_tpu_torch/csrc/tall_path.cu",
                            "admm_tpu/ops/tall_path.py:77",
                            4 * (P * P + P + K + K * P + K), 2 * P * P),
        "tall_path_scan": (tall_path.tall_path_scan,
                           tall_path.tall_path_scan_reference, tall_args,
                           "admm_tpu_torch/csrc/tall_path.cu",
                           "admm_tpu/ops/tall_path.py:178",
                           4 * (P * P + P + K + K * P + K), 2 * P * P),
        "wide_path_batch": (wide_path.wide_path_batch,
                            wide_path.wide_path_batch_reference, wide_args,
                            "admm_tpu_torch/csrc/wide_path.cu",
                            "admm_tpu/ops/wide_path.py:45",
                            4 * (Nw * Pw + Nw + 2 * K + K * Pw + K),
                            4 * Nw * Pw),
        "lad_solve": (lad.lad_solve, lad.lad_solve_reference, lad_args,
                      "admm_tpu_torch/csrc/lad.cu",
                      "admm_tpu/ops/lad_kernel.py:42",
                      4 * (Nl * Nl + Nl + 2 * Nl + 1), 2 * Nl * Nl),
        "bp_batch_solve": (bp.bp_batch_solve, bp.bp_batch_solve_reference,
                           bp_args, "admm_tpu_torch/csrc/bp.cu",
                           "admm_tpu/ops/bp_kernel.py:62",
                           4 * (Nb * Pb + Nb * Nb + 2 * Mb * Pb + Mb),
                           4 * Nb * Pb + 2 * Nb * Nb),
        # The JSON line carries the large shape; the two small ones are
        # compared and timed beside it (glm_cases).
        "glm_batch_path": (*glm_fns(glm_large), glm_cases[glm_large][0],
                           "admm_tpu_torch/csrc/glm.cu",
                           "admm_tpu/ops/glm_kernel.py:55",
                           *glm_work(*glm_cases[glm_large][:2])),
    }
    record = {}

    def lad_compare(label, args, rec):
        """LAD kernel against plain: the invariant is the recovered
        coefficient vector and its L1 objective (the terminal duals are
        path-dependent near the L1 kinks); the raw state's gap and niter
        are printed beside it, and a second launch must repeat the bits."""
        Xa, ys, Ginv = rec
        ay, az, nk = lad.lad_solve(*args)
        torch.cuda.synchronize()
        same_bits_twice(label, lad.lad_solve, args, (ay, az, nk))
        ay_p, az_p, np_ = lad.lad_solve_reference(*args)
        coef_of = lambda a_y, a_z: Ginv @ (Xa.mT @ (ys - a_y / RHO_L1 + a_z))
        obj_of = lambda c: float(torch.sum(torch.abs(
            ys.double() - Xa.double() @ c.double())))
        c, c_p = coef_of(ay, az), coef_of(ay_p, az_p)
        err = float(torch.max(torch.abs(c - c_p)))
        raw = max(float((ay - ay_p).abs().max()), float((az - az_p).abs().max()))
        nk, np_ = int(nk), int(np_)
        print(f"  {label}: max |coef gap| {err:.3e} (standardized scale), "
              f"max |adj gap| {raw:.3e}, L1 objective kernel {obj_of(c):.6f} "
              f"plain {obj_of(c_p):.6f}, niter kernel {nk} plain {np_}")
        smoke.check(bool(torch.isfinite(c).all()) and 0 < nk < MAXIT,
                    f"{label}: finite, converged before maxit")
        smoke.check(err <= LAD_COEF_BAR, f"{label}: coef gap <= {LAD_COEF_BAR}")
        smoke.check(obj_of(c) <= obj_of(c_p) * LAD_OBJ_BAR,
                    f"{label}: objective <= {LAD_OBJ_BAR} x plain's")
        print(f"  {label}: the path kernels' bars (coef gap <= {COEF_BAR}, niter within "
              f"1): {'met' if err <= COEF_BAR and abs(nk - np_) <= 1 else 'not met'}")
        print(f"  {label}: the target (gap 0, identical niter): "
              f"{'met' if err == 0.0 and nk == np_ else 'not met'}")
        return err, nk, np_

    glm_iters, slowest = {}, {}   # lane-iterations; slowest lane's niter

    def same_bits_twice(label, kernel, args, first):
        """No atomics, sums in a fixed order: a second launch on the same
        inputs must repeat every output of the first one, niter included."""
        again = kernel(*args)
        torch.cuda.synchronize()
        smoke.check(all(torch.equal(a, b) for a, b in zip(again, first)),
                    f"{label}: two launches give identical bits and niter")

    def glm_compare(label):
        """GLM kernel against plain: coefficients and niter per lane."""
        kernel, plain = glm_fns(label)
        args = glm_cases[label][0]
        zk, nk = kernel(*args)
        torch.cuda.synchronize()
        same_bits_twice(label, kernel, args, (zk, nk))
        zp, np_ = plain(*args)
        err = float(torch.max(torch.abs(zk - zp)))
        nk, np_ = nk.cpu().numpy(), np_.cpu().numpy()
        lane_gap = int(np.abs(nk - np_).max())
        print(f"  {label}: max |coef gap| {err:.3e} (standardized scale); "
              f"niter total kernel {nk.sum()} plain {np_.sum()}, max kernel "
              f"{nk.max()} plain {np_.max()}, min kernel {nk.min()}, max lane "
              f"gap {lane_gap}, lanes that differ {int((nk != np_).sum())}")
        smoke.check(bool(torch.isfinite(zk).all()) and int(nk.max()) < MAXIT,
                    f"{label}: finite, converged before maxit")
        smoke.check(err <= GLM_COEF_BAR,
                    f"{label}: coef gap <= {GLM_COEF_BAR}")
        smoke.check(lane_gap <= 1, f"{label}: niter within 1 per lane")
        print(f"  {label}: the path kernels' bars (coef gap <= {COEF_BAR}, "
              f"identical niter): "
              f"{'met' if err <= COEF_BAR and lane_gap == 0 else 'not met'}")
        glm_iters[label], slowest[label] = int(nk.sum()), int(nk.max())
        return err, int(nk.sum()), int(np_.sum())

    for name, (kernel, plain, args, source, replaces, _, _) in cases.items():
        print(f"phase: {name} kernel vs plain", flush=True)
        if name == "glm_batch_path":
            # The JSON line carries the largest gap of the three shapes and
            # the large shape's iterations (its bound and times).
            err = 0.0
            for label in glm_cases:
                gap, *iters = glm_compare(label)
                err = max(err, gap)
                if label == glm_large:
                    nk, np_ = iters
            record[name] = dict(name=name, route="cuda", source=source,
                                replaces=replaces, max_abs_err=err,
                                niter_total=nk, niter_total_plain=np_)
            continue
        if name == "lad_solve":
            err, nk, np_ = lad_compare("lad_solve 1000 x 500", args, lad_rec)
            lad_compare("lad_solve 5000 x 1000", lad5_args, lad5_rec)
            record[name] = dict(name=name, route="cuda", source=source,
                                replaces=replaces, max_abs_err=err,
                                niter_total=nk, niter_total_plain=np_)
            continue
        zk, nk = kernel(*args)
        torch.cuda.synchronize()
        if name in ("bp_batch_solve", "tall_path_scan", "wide_path_batch",
                    "tall_path_batch"):
            same_bits_twice(name, kernel, args, (zk, nk))
        zp, np_ = plain(*args)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(zk - zp)))
        nk, np_ = nk.cpu().numpy(), np_.cpu().numpy()
        slowest[name] = int(nk.max())
        print(f"  max |coef gap| {err:.3e}; niter total kernel {nk.sum()} "
              f"plain {np_.sum()}, max kernel {nk.max()} plain {np_.max()}, "
              f"max lane gap {np.abs(nk - np_).max()}")
        far = np.flatnonzero(np.abs(nk - np_) > 1)
        if far.size:
            print("  lanes more than 1 apart (lane: kernel, plain): " + ", ".join(
                f"{i}: {nk[i]}, {np_[i]}" for i in far[:20]))
        smoke.check(bool(torch.isfinite(zk).all()), f"{name}: finite")
        if name == "bp_batch_solve":
            smoke.check(err <= BP_Z_BAR, f"{name}: z gap <= {BP_Z_BAR}")
            smoke.check(all(abs(int(a) - int(b)) <= max(3, int(0.05 * int(b)))
                            for a, b in zip(nk, np_)),
                        f"{name}: niter within max(3, 5%) per lane")
            smoke.check(int(nk.max()) < MAXIT, f"{name}: converged before maxit")
            print(f"  {name}: the path kernels' bars (gap <= {COEF_BAR}, niter within 1): "
                  f"{'met' if err <= COEF_BAR and np.abs(nk - np_).max() <= 1 else 'not met'}")
            z1, n1 = kernel(*bp1_args)
            torch.cuda.synchronize()
            same_bits_twice(f"{name}, m = 1", kernel, bp1_args, (z1, n1))
            smoke.check(torch.equal(z1[0], zk[0]) and int(n1[0]) == int(nk[0]),
                        f"{name}: one lane alone (m = 1) equals lane 0 of the "
                        "batch, to the bit")
        else:
            smoke.check(err <= COEF_BAR, f"{name}: coef gap <= {COEF_BAR}")
        if name == "tall_path_batch":
            print(f"  {name}: the target (gap 0, identical niter in every "
                  f"lane): {'met' if err == 0.0 and (nk == np_).all() else 'not met'}"
                  f"; slowest lane {int(nk.max())} iterations")
        if name == "tall_path_scan":
            tot_k, tot_p = int(nk.sum()), int(np_.sum())
            smoke.check(abs(tot_k - tot_p) <= max(3, int(0.1 * tot_p)),
                        f"{name}: niter totals within max(3, 10%)")
            print(f"  {name}: the target (gap 0, identical niter at every "
                  f"lambda): {'met' if err == 0.0 and (nk == np_).all() else 'not met'}")
        elif name != "bp_batch_solve":
            smoke.check(int(np.abs(nk - np_).max()) <= 1,
                        f"{name}: niter within 1 per lane")
        if name == "wide_path_batch":
            smoke.check(float(torch.abs(zk[0]).max()) == 0.0,
                        f"{name}: lane at lambda0 exactly 0")
        record[name] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=err,
                            niter_total=int(nk.sum()),
                            niter_total_plain=int(np_.sum()))

    # 4. The main paths through the public entry points.
    print("phase: main path", flush=True)
    t = admm_tpu_torch
    f64 = dict(dtype=torch.float64)
    l1_f64 = dict(dtype=torch.float64, eps_abs=EPS_L1, eps_rel=EPS_L1)
    # (label, kernel that must launch or None, call, float64 engine reference)
    calls = [
        ("admm_lasso(X, y).fit()  [tall batch]", "tall_path_batch",
         lambda: t.admm_lasso(X, y).fit(),
         lambda: t.lasso_path(X, y, path_mode="batch", **f64)),
        ("lasso_path(X, y)  [tall scan]", "tall_path_scan",
         lambda: t.lasso_path(X, y),
         lambda: t.lasso_path(X, y, path_mode="scan", **f64)),
        ("enet_path(X, y, alpha=0.6)  [tall scan]", "tall_path_scan",
         lambda: t.enet_path(X, y, alpha=0.6),
         lambda: t.enet_path(X, y, alpha=0.6, path_mode="scan", **f64)),
        ("admm_lasso(Xw, yw).fit()  [wide batch]", "wide_path_batch",
         lambda: t.admm_lasso(Xw, yw).fit(),
         lambda: t.lasso_path(Xw, yw, path_mode="batch", **f64)),
        ("admm_lad(Xl, yl, intercept=False).fit()  [1000 x 500]",
         "lad_solve", lambda: t.admm_lad(Xl, yl, intercept=False).fit(),
         lambda: t.lad_fit(Xl, yl, intercept=False, **l1_f64)),
        ("admm_lad(Xl5, yl5, intercept=False).fit()  [5000 x 1000]",
         "lad_solve", lambda: t.admm_lad(Xl5, yl5, intercept=False).fit(),
         lambda: t.lad_fit(Xl5, yl5, intercept=False, **l1_f64)),
        ("bp_fit_batch(A, B)  [1000 x 2000 x 100]", "bp_batch_solve",
         lambda: t.bp_fit_batch(A, B),
         lambda: t.bp_fit_batch(A, B, **l1_f64)),
        ("admm_bp(A, b).fit()  [1000 x 2000, m = 1]", "bp_batch_solve",
         lambda: t.admm_bp(A, B[0]).fit(),
         lambda: t.bp_fit(A, B[0], **l1_f64)),
        (f"admm_dantzig(Xd, yd).penalty(nlambda={kd}).fit()  "
         f"[{nd} x {pd}, batch, engine]", None,
         lambda: t.admm_dantzig(Xd, yd).penalty(nlambda=kd).opts(
             path_mode="batch").fit(),
         lambda: t.dantzig_path(Xd, yd, nlambda=kd, path_mode="batch", **f64)),
        (f"logistic_lasso_path(Xg, yg, nlambda={kg})  [{ng} x {pg}]",
         "glm_batch_path",
         lambda: t.logistic_lasso_path(Xg, yg["logistic"], nlambda=kg),
         lambda: t.logistic_lasso_path(Xg, yg["logistic"], nlambda=kg, **f64)),
        (f"huber_lasso_path(Xg, yg, nlambda={kg})  [{ng} x {pg}]",
         "glm_batch_path",
         lambda: t.huber_lasso_path(Xg, yg["huber"], nlambda=kg),
         lambda: t.huber_lasso_path(Xg, yg["huber"], nlambda=kg, **f64)),
        (f"logistic_lasso_path(XG, yG, nlambda={kG})  [{nG} x {pG}]",
         "glm_batch_path",
         lambda: t.logistic_lasso_path(XG, yG, nlambda=kG),
         lambda: t.logistic_lasso_path(XG, yG, nlambda=kG, **f64)),
        (f"poisson_lasso_path(Xg, yg, nlambda={kg})  [{ng} x {pg}, scan, "
         "adaptive, engine]", None,
         lambda: t.poisson_lasso_path(Xg, yg["poisson"], nlambda=kg),
         lambda: t.poisson_lasso_path(Xg, yg["poisson"], nlambda=kg, **f64)),
    ]
    glm_labels = {c[0] for c in calls[-4:]}
    smoke.check(lad.fits(Xl5.shape[0]),
                "LAD 5000 x 1000 takes the kernel route (fits(5000))")
    # Every path is driven with the counts at 0 just before it and read
    # just after; a kernel's `launches` is its sum over the paths.
    outputs = []
    counts = dict.fromkeys(cases, 0)
    t_main = time.perf_counter()
    for label, kname, call, _ in calls:
        kernels.reset_launch_counts()
        out = call()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        if kname is None:
            smoke.check(not any(after.values()),
                        f"{label}: no kernel on this path")
        else:
            smoke.check(after[kname] > 0, f"{label}: launched {kname}")
        if label in glm_labels and kname is not None:
            smoke.check(after == {**dict.fromkeys(after, 0), kname: 1},
                        f"{label}: {kname} once and no other launch "
                        f"(counts {after})")
        for name, launched in after.items():
            counts[name] += launched
        outputs.append(out)
    main_s = time.perf_counter() - t_main
    print(f"  launch counts over the main paths: {counts} "
          f"({main_s:.2f} s on the host clock, first calls included)")
    for name in cases:
        smoke.check(counts[name] > 0, f"{name} launched on the main path")
        record[name]["launches"] = counts[name]

    def to_np(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    for (label, _, _, ref_call), out in zip(calls, outputs):
        ref = ref_call()
        if isinstance(out, t.ADMMLADFit):
            Xn, yn = (Xl5, yl5) if "Xl5" in label else (Xl, yl)
            coef, coef_ref = out.beta[1:], to_np(ref.coef)
            gap = float(np.abs(coef - coef_ref).max())
            obj = lambda c: float(np.abs(
                yn.astype(np.float64) - Xn.astype(np.float64) @ c).sum())
            print(f"  {label}: max |coef - f64 engine| {gap:.3e}, L1 objective "
                  f"{obj(coef):.4f} vs f64 {obj(coef_ref):.4f}, niter "
                  f"{out.niter} (f64 engine {int(ref.niter)})")
            smoke.check(bool(np.isfinite(out.beta).all())
                        and out.beta.shape == (Xn.shape[1] + 1,)
                        and out.beta[0] == 0.0, f"{label}: finite, shape")
            smoke.check(gap <= LAD_COEF_BAR,
                        f"{label}: within {LAD_COEF_BAR} of float64")
            smoke.check(obj(coef) <= obj(coef_ref) * LAD_OBJ_BAR,
                        f"{label}: L1 objective within 0.1% of float64's")
            continue
        if isinstance(out, (t.ADMMBPFit, t.BPResult)):
            if isinstance(out, t.ADMMBPFit):
                coef, truth = out.beta.toarray()[:, 0], X0[0]
                niter = np.array([out.niter])
            else:
                coef, truth, niter = to_np(out.coef), X0, to_np(out.niter)
            gap = float(np.abs(coef - to_np(ref.coef)).max())
            rec_err = float(np.abs(coef - truth).max())
            print(f"  {label}: max |coef - f64 engine| {gap:.3e}, max "
                  f"|coef - true signal| {rec_err:.3e}, niter total "
                  f"{int(niter.sum())} max {int(niter.max())} (f64 engine "
                  f"total {int(to_np(ref.niter).sum())})")
            smoke.check(bool(np.isfinite(coef).all())
                        and coef.shape == truth.shape, f"{label}: finite, shape")
            smoke.check(gap <= BP_F64_BAR,
                        f"{label}: within {BP_F64_BAR} of float64")
            smoke.check(rec_err <= BP_RECOVERY_BAR,
                        f"{label}: recovery error <= {BP_RECOVERY_BAR}")
            continue
        if isinstance(out, t.ADMMLassoFit):
            dense = out.beta.toarray()
            beta0, coef, niter = dense[0], dense[1:].T, out.niter
        else:
            beta0, coef, niter = (to_np(out.beta0), to_np(out.coef),
                                  to_np(out.niter))
        nlam = to_np(ref.coef).shape[0]
        gap = float(np.abs(coef - to_np(ref.coef)).max())
        gap0 = float(np.abs(beta0 - to_np(ref.beta0)).max())
        finite = bool(np.isfinite(coef).all() and np.isfinite(beta0).all())
        print(f"  {label}: coef shape {coef.shape}, max |coef - f64 engine| "
              f"{gap:.3e}, max |beta0 gap| {gap0:.3e}, niter total "
              f"{int(np.sum(niter))} max {int(np.max(niter))} "
              f"(f64 engine total {int(ref.niter.sum())})")
        smoke.check(finite and coef.shape == to_np(ref.coef).shape,
                    f"{label}: {nlam} finite lambdas")
        smoke.check(gap <= PATH_BAR, f"{label}: within {PATH_BAR} of float64")
        if label in glm_labels:
            smoke.check(gap0 <= PATH_BAR,
                        f"{label}: intercepts within {PATH_BAR} of float64")

    # 4b. Cross-validation, the Lasso's options and prediction.
    cv_phase(torch, smoke, record, X, y, Xw, yw, Xg, yg["logistic"], kg, f32)

    # 4c. Traces, the active set and the first families.
    families_phase(torch, smoke, record, X, y, Xw, yw, Xd, yd, Xl, yl)

    # 4d. The second families.
    second_families_phase(torch, smoke, record)

    # 4e. The last families and the glmnet front end.
    last_families_phase(torch, smoke, record, X, y)

    # 4f. Consensus ADMM.
    consensus_phase(torch, smoke, record, X, y, Xw, yw, A, B[0], X0[0])

    # 4g. Checkpoints and the profiler.
    trace_ms = diag_phase(torch, smoke, record, X, y, Xw, yw)

    # 5. Times.
    print("phase: times (median of 5 after a warm-up, 3 where said; CUDA "
          "events)", flush=True)
    for name, (kernel, plain, args, _, _, nbytes, ops_per_iter) in cases.items():
        ms = cuda_median_ms(torch, lambda: kernel(*args))
        plain_ms = cuda_median_ms(torch, lambda: plain(*args))
        b_ms, b_by = bound_ms(nbytes, record[name]["niter_total"] * ops_per_iter)
        record[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({record[name]['niter_total']} "
              f"lane-iterations), library call: none (no single PyTorch "
              f"call computes a whole solve)"
              + (f"; in the profiler's trace of the flagship path "
                 f"{trace_ms[name]:.3f} ms on the device" if name in trace_ms
                 else ""))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def grid_line(label, ms, iters, plan, syncs, of="the slowest lane"):
        """Time per iteration of the slowest lane of a cooperative-grid
        kernel, with its grid and its grid syncs per iteration."""
        print(f"  {label}: grid {plan['grid']} blocks x {plan['threads']} "
              f"threads, {plan['smem_bytes']} bytes of dynamic shared memory, "
              f"{syncs} grid syncs per iteration, {of} {iters} "
              f"iterations, {ms * 1e3 / iters:.1f} us per iteration of {of}")

    grid_line(f"tall_path_scan {P} x {P} x {K}", record["tall_path_scan"]["ms"],
              record["tall_path_scan"]["niter_total"],
              tall_path.launch_plan(P, sms),
              tall_path.SCAN_SYNCS_PER_ITERATION, of="the one lane")
    grid_line(f"tall_path_batch {P} x {P} x {K}",
              record["tall_path_batch"]["ms"], slowest["tall_path_batch"],
              tall_path.batch_launch_plan(P, K, sms),
              tall_path.BATCH_SYNCS_PER_ITERATION)
    tb_iters = record["tall_path_batch"]["niter_total"]
    print(f"  tall_path_batch: {record['tall_path_batch']['ms'] * 1e3 / tb_iters:.3f}"
          f" us per lane-iteration over {tb_iters} lane-iterations")
    grid_line(f"lad_solve {Nl} x {Nl}", record["lad_solve"]["ms"],
              record["lad_solve"]["niter_total"], lad.launch_plan(Nl, sms),
              lad.SYNCS_PER_ITERATION, of="the one lane")
    grid_line(f"wide_path_batch {Nw} x {Pw} x {K}",
              record["wide_path_batch"]["ms"], slowest["wide_path_batch"],
              wide_path.launch_plan(Nw, Pw, K, sms),
              wide_path.SYNCS_PER_ITERATION)
    grid_line(f"bp_batch_solve {Nb} x {Pb} x {Mb}", record["bp_batch_solve"]["ms"],
              slowest["bp_batch_solve"], bp.launch_plan(Nb, Pb, Mb, sms),
              bp.SYNCS_PER_ITERATION)
    grid_line(glm_large, record["glm_batch_path"]["ms"], slowest[glm_large],
              glm.launch_plan(nG, pG + 1, kG, sms), glm.syncs_per_iteration(2))
    # The batch kernels with every lane active in every iteration (a
    # tolerance of 0 and a fixed number of iterations): what one iteration
    # costs at full width, beside the average over a run whose lanes drop
    # out as they converge.
    FULL_ITERS = 10
    bp_full = (*bp_args[:4], 0.0, 0.0, FULL_ITERS)
    glm_full_args = (*glm_cases[glm_large][0][:6], 0.0, 0.0, 1.0, FULL_ITERS)
    glm_full_kw = glm_cases[glm_large][1]
    wide_full = (*wide_args[:6], 0.0, 0.0, 1.0, FULL_ITERS)
    for label, fn, lanes in (
            (f"wide_path_batch {Nw} x {Pw} x {K}",
             lambda: wide_path.wide_path_batch(*wide_full), K),
            (f"bp_batch_solve {Nb} x {Pb} x {Mb}",
             lambda: bp.bp_batch_solve(*bp_full), Mb),
            (glm_large,
             lambda: glm.glm_batch_path(*glm_full_args, **glm_full_kw), kG)):
        _, n_full = fn()
        smoke.check(n_full.tolist() == [FULL_ITERS] * lanes,
                    f"{label}: tolerance 0 runs every lane to maxit")
        ms_full = cuda_median_ms(torch, fn)
        print(f"  {label}, all {lanes} lanes active for {FULL_ITERS} "
              f"iterations: {ms_full:.3f} ms, {ms_full * 1e3 / FULL_ITERS:.1f} "
              "us per iteration")
    # LAD at 5000 x 1000: H (100 MB) no longer fits the L2.
    n5 = lad5_args[0].shape[0]
    _, _, it5 = lad.lad_solve(*lad5_args)
    ms5 = cuda_median_ms(torch, lambda: lad.lad_solve(*lad5_args), reps=3)
    plain5 = cuda_median_ms(
        torch, lambda: lad.lad_solve_reference(*lad5_args), reps=3)
    b5, by5 = bound_ms(4 * (n5 * n5 + 3 * n5 + 1), int(it5) * 2 * n5 * n5)
    print(f"  lad_solve 5000 x 1000: kernel {ms5:.3f} ms, plain {plain5:.3f} "
          f"ms (medians of 3), bound {b5:.4f} ms by {by5} ({int(it5)} "
          "iterations)")
    grid_line(f"lad_solve {n5} x {n5}", ms5, int(it5), lad.launch_plan(n5, sms),
              lad.SYNCS_PER_ITERATION, of="the one lane")
    # LAD's floor when H is read from device memory every iteration (H at
    # n = 5000 is 100 MB, past the 50 MB L2), and the library yardsticks,
    # which the port never calls: one iteration's product as cuBLAS gemv.
    for n_, it_, ms_, H_ in (
            (Nl, record["lad_solve"]["niter_total"], record["lad_solve"]["ms"],
             lad_args[0]),
            (n5, int(it5), ms5, lad5_args[0])):
        plan_ = lad.launch_plan(n_, sms)
        v_ = torch.ones(n_, **f32)
        mv_ms = cuda_median_ms(torch, lambda: torch.mv(H_, v_), reps=20)
        floor_ms = it_ * n_ * n_ * 4 / PEAK_BYTES_PER_S * 1e3
        print(f"  lad_solve n = {n_}: ring of {plan_['stages']} stages x "
              f"{4 * plan_['seg']} bytes ({plan_['ring_bytes']} bytes), "
              f"{plan_['segments_per_row']} stage(s) per row; HBM-streaming "
              f"floor {floor_ms:.3f} ms ({it_} x n^2 x 4 B / 3.35 TB/s) beside "
              f"the kernel's {ms_:.3f} ms; yardstick torch.mv(H, v) "
              f"{mv_ms * 1e3:.2f} us per iteration, x {it_} = "
              f"{mv_ms * it_:.3f} ms")
    V_ = torch.ones((K, P), **f32)
    mm_ms = cuda_median_ms(torch, lambda: torch.mm(V_, Minv), reps=20)
    print(f"  tall_path_batch: yardstick float32 {K} x {P} x {P} product "
          f"(torch.mm) {mm_ms * 1e3:.2f} us per iteration, x the slowest "
          f"lane's {slowest['tall_path_batch']} = "
          f"{mm_ms * slowest['tall_path_batch']:.3f} ms")
    # The GLM kernel at the benchmark problem's size, and beside it the
    # float32 engine on the same batch problem (the route the path would
    # take without the kernel: one host read of `done` per iteration).  The
    # engine call builds its own majorizer inverse, so the kernel side is
    # timed with `_glm_fixed_minv` too.  Kernel, engine, engine, kernel.
    for label, (args, kw, fam) in glm_cases.items():
        if label == glm_large:
            continue
        kernel, plain = glm_fns(label)
        ms = cuda_median_ms(torch, lambda: kernel(*args))
        plain_ms = cuda_median_ms(torch, lambda: plain(*args))
        nbytes, ops = glm_work(args, kw)
        b_ms, b_by = bound_ms(nbytes, glm_iters[label] * ops)
        print(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({glm_iters[label]} lane-iterations), "
              "library call: none")
        grid_line(label, ms, slowest[label],
                  glm.launch_plan(*args[0].shape, args[4].shape[0], sms),
                  glm.syncs_per_iteration(kw["newton_steps"]))
        Xa_g, _, y_g, mask_g, lams_g, rho_g = args[:6]

        def kernel_route():
            Minv_g = _glm_fixed_minv(Xa_g, fam, rho_g).contiguous()
            return glm.glm_batch_path(Xa_g, Minv_g, *args[2:], **kw)

        def engine_route():
            st0, solve, _, _ = _glm_engine(
                Xa_g, y_g, fam, lams_g[0], -1.0, mask_g, 1.0,
                kw["newton_steps"], hessian="fixed")
            st = _batched_cold_states(lams_g.shape[0], Xa_g.shape[1], st0.rho,
                                      lams_g)
            st = make_batched_solver(solve)(st, MAXIT, EPS, EPS)
            return st.z, st.it

        (zk, nk), (ze, ne) = kernel_route(), engine_route()
        ms4 = [cuda_median_ms(torch, fn) for fn in
               (kernel_route, engine_route, engine_route, kernel_route)]
        print(f"  {label}, with the Gram and its inverse: kernel route "
              f"{ms4[0]:.3f} and {ms4[3]:.3f} ms ({int(nk.sum())} "
              f"lane-iterations, slowest lane {int(nk.max())}), float32 engine "
              f"{ms4[1]:.3f} and {ms4[2]:.3f} ms ({int(ne.sum())} "
              f"lane-iterations, slowest lane {int(ne.max())}), max |z gap| "
              f"{float((zk - ze).abs().max()):.3e}")
    # BP with one signal, from tensors on the card and with the set-up
    # (AA', its Cholesky inverse, the caches) in both: the kernel route
    # beside the float32 engine, which reads `done` on the host every
    # iteration.  Kernel, engine, engine, kernel.
    b0 = torch.as_tensor(B[0], **f32)
    solve_args = (At, b0, RHO_L1, MAXIT, EPS_L1, EPS_L1)
    res_k, res_e = _bp_fit(*solve_args), _bp_fit_engine(*solve_args)
    ms1 = [cuda_median_ms(torch, lambda: fn(*solve_args))
           for fn in (_bp_fit, _bp_fit_engine, _bp_fit_engine, _bp_fit)]
    ms1_kernel_only = cuda_median_ms(torch,
                                     lambda: bp.bp_batch_solve(*bp1_args))
    ms1_plain = cuda_median_ms(
        torch, lambda: bp.bp_batch_solve_reference(*bp1_args))
    b1, by1 = bound_ms(4 * (Nb * Pb + Nb * Nb + 2 * Pb + 1),
                       int(res_k.niter) * (4 * Nb * Pb + 2 * Nb * Nb))
    grid_line(f"bp_batch_solve {Nb} x {Pb}, m = 1", ms1_kernel_only,
              int(res_k.niter), bp.launch_plan(Nb, Pb, 1, sms),
              bp.SYNCS_PER_ITERATION)
    print(f"  bp m = 1: kernel route {ms1[0]:.3f} and {ms1[3]:.3f} ms "
          f"({int(res_k.niter)} iterations; the kernel alone "
          f"{ms1_kernel_only:.3f} ms, its plain form {ms1_plain:.3f} ms, "
          f"bound {b1:.4f} ms by {by1}), float32 engine {ms1[1]:.3f} and "
          f"{ms1[2]:.3f} ms ({int(res_e.niter)} iterations), max |z gap| "
          f"{float((res_k.coef - res_e.coef).abs().max()):.3e}")
    # End to end: numpy in, result on the host out (the input copy, the
    # set-up products and Cholesky, the kernel, recovery).
    for label, _, call, _ in calls:
        reps = 3 if ("5000" in label or "dantzig" in label
                     or f"[{nG} x {pG}]" in label) else 5
        print(f"  end to end {label}: "
              f"{cuda_median_ms(torch, call, reps=reps):.3f} ms"
              f"{' (median of 3)' if reps == 3 else ''}")

    # Stage breakdown of one scan-mode Lasso path, one tall and one wide
    # batch fit, one LAD fit, one batched BP solve and one logistic fit:
    # what the entry points do, stage by stage, on the host clock.
    print("phase: stages (host clock to a synchronize, median of 5 after a "
          "warm-up)", flush=True)

    def stages(title, steps):
        total, out = 0.0, None
        for name, fn in steps:
            ms, out = host_median_ms(torch, (lambda f=fn, a=out: f(a)))
            total += ms
            print(f"  {title} | {name}: {ms:.3f} ms")
        print(f"  {title} | sum: {total:.3f} ms")

    def lasso_stages(title, Xn, yn, ratio, setup, solve, finish):
        """The stages of ``lasso_path`` on (Xn, yn): ``setup`` and ``solve``
        are the regime's, ``finish`` what the entry point does with the
        recovered path."""
        def grid(a):
            Xs, ys, st = a
            lams = _auto_lambdas(Xs, ys, st, 100, ratio, 1.0, False)
            return Xs, ys, st, lams, lams * Xs.shape[0] / st.scale_y
        stages(title, [
            ("numpy -> device copy of X, y",
             lambda _: (torch.as_tensor(Xn, **f32), torch.as_tensor(yn, **f32))),
            ("standardize",
             lambda a: standardize(a[0], a[1], standardize_x=True,
                                   intercept=True)),
            ("lambda grid", grid),
            setup, solve,
            ("recover" + finish[0],
             lambda a: finish[1](a[3], *recover(a[2], a[5], standardize_x=True,
                                                intercept=True), a[6])),
        ])

    lasso_stages(
        f"lasso_path {X.shape[0]} x {P} x {K} (scan)", X, y, 1e-4,
        ("Gram, X'y, power iteration, ridge inverse (_tall_setup)",
         lambda a: (*a, _tall_setup(a[0], a[1], a[4][0], -1.0))),
        ("tall_path_scan kernel (with the transposed copy of Minv)",
         lambda a: (*a[:5], *tall_path.tall_path_scan(
             a[5][0].contiguous(), a[5][1].contiguous(), a[4].contiguous(),
             a[5][2], EPS, EPS, 1.0, MAXIT))),
        (", on the card", lambda lams, beta0, coef, niter: (beta0, coef)))
    lasso_stages(
        f"admm_lasso().fit() {X.shape[0]} x {P} x {K} (tall batch)", X, y,
        1e-4,
        ("Gram, X'y, power iteration, ridge inverse (_tall_setup)",
         lambda a: (*a, _tall_setup(a[0], a[1], a[4][0], -1.0))),
        ("tall_path_batch kernel (with the transposed copy of Minv)",
         lambda a: (*a[:5], *tall_path.tall_path_batch(
             a[5][0].contiguous(), a[5][1].contiguous(), a[4].contiguous(),
             a[5][2], EPS, EPS, 1.0, MAXIT))),
        (", sparse beta on the host",
         lambda lams, beta0, coef, niter: (
             lams.cpu().numpy(), _sparse_beta(beta0, coef),
             niter.cpu().numpy())))
    lasso_stages(
        f"admm_lasso().fit() {Nw} x {Pw} x {K} (wide batch)", Xw, yw, 1e-2,
        ("X'y, power iteration on XX', per-lane rho (_wide_setup)",
         lambda a: (*a, _wide_setup(a[0], a[1], a[4], -1.0, 1.0, False))),
        ("wide_path_batch kernel (with the padded and transposed copies)",
         lambda a: (*a[:5], *wide_path.wide_path_batch(
             a[0].contiguous(), a[1].contiguous(), a[4].contiguous(),
             a[5][2].contiguous(), a[5][1], a[5][0], EPS, EPS, 1.0, MAXIT))),
        (", sparse beta on the host",
         lambda lams, beta0, coef, niter: (
             lams.cpu().numpy(), _sparse_beta(beta0, coef),
             niter.cpu().numpy())))

    def lad_recover(a):
        Xa, ys, stats, Ginv, _, ay, az = a
        beta0, coef = recover(stats, Ginv @ (Xa.mT @ (ys - ay / RHO_L1 + az)),
                              standardize_x=True, intercept=False)
        return beta0.cpu().numpy(), coef.cpu().numpy()

    stages("LAD 1000 x 500", [
        ("numpy -> device copy of X, y",
         lambda _: (torch.as_tensor(Xl, **f32), torch.as_tensor(yl, **f32))),
        ("standardize, Gram, Cholesky inverse",
         lambda a: _lad_setup(a[0], a[1], False)),
        ("hat matrix H = Xa Ginv Xa'",
         lambda a: (*a, _hat_matrix(a[0], a[3]))),
        ("lad_solve kernel (||ys|| stays on the card)",
         lambda a: (*a[:5], *lad.lad_solve(a[5], a[1].contiguous(), RHO_L1,
                                           EPS_L1, EPS_L1, a[4], MAXIT)[:2])),
        ("recovery solve, un-standardize, to host", lad_recover),
    ])
    stages("BP 1000 x 2000 x 100", [
        ("numpy -> device copy of A, B",
         lambda _: (torch.as_tensor(A, **f32), torch.as_tensor(B, **f32))),
        ("AA', Cholesky inverse", lambda a: (*a, _bp_setup(a[0]))),
        ("K = Winv A, AAAB = B K",
         lambda a: (a[0], a[2].contiguous(), (a[1] @ (a[2] @ a[0])).contiguous())),
        ("bp_batch_solve kernel",
         lambda a: bp.bp_batch_solve(*a, RHO_L1, EPS_L1, EPS_L1, MAXIT)),
        ("coefficients to host", lambda a: a[0].cpu().numpy()),
    ])
    fam_b = binomial()
    rho_b = _glm_auto_rho(fam_b, -1.0)

    def glm_design(a):
        Xa, pen_mask, mean_x, sd_x = prep_design(a[0], True, True)
        return Xa.contiguous(), pen_mask, mean_x, sd_x, a[1]

    def glm_recover(a):
        beta0, coef = recover_glm(a[5][0], a[2], a[3], True)
        return beta0.cpu().numpy(), coef.cpu().numpy()

    stages(f"logistic {nG} x {pG} x {kG}", [
        ("numpy -> device copy of X, y",
         lambda _: (torch.as_tensor(XG, **f32), torch.as_tensor(yG, **f32))),
        ("prep_design (moments, scaling, ones column)", glm_design),
        ("lambda grid (null residual, score, log-linear grid)",
         lambda a: (*a, glm_lambdas(a[0], a[4], fam_b, kG).contiguous())),
        ("Gram and ridge inverse (_glm_fixed_minv)",
         lambda a: (*a, _glm_fixed_minv(a[0], fam_b, rho_b).contiguous())),
        ("glm_batch_path kernel",
         lambda a: (*a[:5], glm.glm_batch_path(
             a[0], a[6], a[4], a[1], a[5], rho_b, EPS, EPS, 1.0, MAXIT,
             family="binomial", newton_steps=2))),
        ("recover_glm, to host", glm_recover),
    ])
    print(f"  whole script: {time.perf_counter() - t_start:.1f} s on the host "
          "clock")

    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in record.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
