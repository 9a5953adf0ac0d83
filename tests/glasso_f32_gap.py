"""How far the float32 graphical lasso lies from float64, in the JAX
package and in the port, on the CPU: the measurement behind ROADMAP.md's
queue 3 item on the glasso.  Not a test (pytest does not collect it); it
imports both packages, as the parity tests do.

    python tests/glasso_f32_gap.py [--seeds 8]

The problem is ``tests/test_torch_glasso.py``'s generator (p = 10, n =
150, a sparse precision) with seeds 0..seeds-1, 6 lambdas of the auto
grid, both path modes, the Newton-Schulz x-update.  Each package's
float32 path is held against the JAX package's float64 one (the two
packages' float64 paths agree to 1e-13), and so is the JAX package's
float32 path compiled without fused multiply-adds: the script runs itself
again with ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (an ISA without FMA, so
LLVM cannot contract ``a * b + c``).  The port runs twice: as it is (its
covariance accumulated in float64 and rounded once,
``models/glasso.py::_weighted_cov``) and on a covariance formed in
float32 (the port's step before that repair).  It prints each case's
gaps, each package's float32 covariance against float64, and a check of
the contraction itself.  Takes about a minute.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import admm_tpu  # noqa: E402

MODES = ("scan", "batch")


def data(seed):
    """``tests/test_torch_glasso.py::data`` at ``seed``."""
    rng = np.random.default_rng(seed)
    p = 10
    A = rng.normal(size=(p, p)) * (rng.random((p, p)) < 0.25)
    prec = A @ A.T + np.eye(p)
    L = np.linalg.cholesky(np.linalg.inv(prec))
    return rng.normal(size=(150, p)) @ L.T


def jax_precisions(seeds, dtype):
    return {f"{s} {m}": np.asarray(admm_tpu.glasso_path(
        data(s), nlambda=6, path_mode=m, dtype=dtype).precision,
        np.float64).tolist() for s in range(seeds) for m in MODES}


def fma_share():
    """The share of ``(1 + r) a - r b`` float32 results where this XLA
    build and numpy (one rounding per operation) differ."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 100000)).astype(np.float32)
    r = np.float32(0.3719)
    xla = np.asarray(jax.jit(lambda a, b, r: (1.0 + r) * a - r * b)(a, b, r))
    ref = (np.float32(1.0) + r) * a - r * b
    return float(np.mean(xla != ref))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--jax-f32-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jax_f32_only:
        print(json.dumps({"fma_share": fma_share(),
                          "prec": jax_precisions(args.seeds, jnp.float32)}))
        return
    import torch

    import admm_tpu_torch

    torch.set_num_threads(1)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX")
    nofma = json.loads(subprocess.run(
        [sys.executable, __file__, "--seeds", str(args.seeds),
         "--jax-f32-only"], env=env, check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[-1])
    print(f"(1 + r) a - r b in float32, share rounded unlike numpy: XLA "
          f"{fma_share():.3f}, XLA without FMA {nofma['fma_share']:.3f}")
    f64 = jax_precisions(args.seeds, jnp.float64)
    f32 = jax_precisions(args.seeds, jnp.float32)
    def f32_cov(X):
        """The covariance formed in float32, the port's step before."""
        Xt = torch.as_tensor(X, dtype=torch.float32)
        Xc = Xt - Xt.mean(dim=0)[None, :]
        return Xc.mT @ Xc / Xt.shape[0]

    rows, covs = [], []
    print("case: max |precision - JAX float64| for JAX float32, JAX "
          "float32 without FMA, the port float32, the port on a float32 "
          "covariance")
    for key, ref in f64.items():
        s, m = key.split()
        X, ref = data(int(s)), np.asarray(ref)
        kw = dict(path_mode=m, dtype=torch.float32, device="cpu")
        res = admm_tpu_torch.glasso_path(X, nlambda=6, **kw)
        before = admm_tpu_torch.glasso_path(cov=f32_cov(X),
                                            lambdas=res.lambdas, **kw)
        gaps = [np.abs(np.asarray(g[key]) - ref).max()
                for g in (f32, nofma["prec"])] + [
            np.abs(r.precision.double().numpy() - ref).max()
            for r in (res, before)]
        rows.append(gaps)
        print(f"  seed {s} {m}: " + "  ".join(f"{g:.3e}" for g in gaps))
        if m == MODES[0]:
            c64 = np.cov(X.T, bias=True)
            covs.append([np.abs(np.asarray(c, np.float64) - c64).max()
                         for c in (admm_tpu.empirical_covariance(
                             X, dtype=jnp.float32), res.cov.numpy(),
                             f32_cov(X).numpy())])
    rows = np.asarray(rows)
    for k, port in ((2, "the port"), (3, "the port on a float32 covariance")):
        for j, name in ((0, "JAX float32"), (1, "JAX float32 without FMA")):
            ratio = rows[:, k] / rows[:, j]
            print(f"{port} against {name}: larger in "
                  f"{int(np.sum(rows[:, k] > rows[:, j]))} of {len(rows)}, "
                  f"ratio median {np.median(ratio):.2f}, range "
                  f"{ratio.min():.2f}-{ratio.max():.2f}")
    covs = np.asarray(covs)
    print("float32 covariance, max |S32 - S64| over the seeds: JAX "
          f"{covs[:, 0].min():.2e}-{covs[:, 0].max():.2e}, the port "
          f"{covs[:, 1].min():.2e}-{covs[:, 1].max():.2e}, formed in "
          f"float32 {covs[:, 2].min():.2e}-{covs[:, 2].max():.2e}")


if __name__ == "__main__":
    main()
