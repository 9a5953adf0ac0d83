"""How far a float32 quantile CV lies from float64, in the JAX package and
in the port, on the CPU: the measurement behind ``chip_smoke.py``'s
``QUANTILE_CV_BAR``.  Not a test (pytest does not collect it); it imports
both packages, as the parity tests do.

    python tests/quantile_cv_gap.py [--perms 3] [--threads 3]

The problem is ``chip_smoke.second_problems()``'s quantile cell (2000 x
200, t(3) noise), tau in {0.25, 0.5, 0.75}, 30 lambdas, 3 folds from
``_cv_foldid(seed 0)``, maxit 10000, as the card's cell runs it.  Each
package's float32 CV runs on the rows as given and on ``--perms`` row
permutations (rows and fold ids permuted together: the same problem,
another order of every sum); each is held against the float64 CV (the
two packages' float64 curves agree to 1e-13).  It prints the largest
relative cvm gap of each run, per tau.  A final check shows why the two
packages' float32 gaps differ: XLA on the CPU contracts ``a * b + c``
into fused multiply-adds, PyTorch rounds every operation.  Takes about
40 minutes with 3 threads.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import admm_tpu  # noqa: E402
import admm_tpu_torch  # noqa: E402
import chip_smoke  # noqa: E402
from admm_tpu_torch.models.cv import _cv_foldid  # noqa: E402

TAUS = [0.25, 0.5, 0.75]


def cv(pkg, X, y, foldid, dtype):
    if pkg == "jax":
        out = admm_tpu.cv_quantile_lasso_path(
            X, y, tau=TAUS, foldid=foldid, maxit=10000,
            dtype={"f32": jnp.float32, "f64": jnp.float64}[dtype])
    else:
        out = admm_tpu_torch.cv_quantile_lasso_path(
            X, y, tau=TAUS, foldid=foldid, maxit=10000, device="cpu",
            dtype={"f32": torch.float32, "f64": torch.float64}[dtype])
    return np.asarray(out["cvm"], np.float64)


def fma_check():
    """The share of ``(1 + r) a - r b`` results that XLA's jit (FMA
    contracted) and PyTorch (one rounding per op) round differently, and
    each one's mean error against float64."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 100000)).astype(np.float32)
    r = np.float32(0.3719)
    exact = (1 + np.float64(r)) * a.astype(np.float64) - np.float64(r) * b
    xla = np.asarray(jax.jit(lambda a, b, r: (1.0 + r) * a - r * b)(a, b, r))
    tt = ((1.0 + torch.tensor(r)) * torch.from_numpy(a)
          - torch.tensor(r) * torch.from_numpy(b)).numpy()
    print(f"(1 + r) a - r b in float32: XLA and PyTorch differ in "
          f"{int((xla != tt).sum())} of {a.size}; mean error against "
          f"float64: XLA {np.abs(xla - exact).mean():.3e}, PyTorch "
          f"{np.abs(tt - exact).mean():.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perms", type=int, default=3)
    ap.add_argument("--threads", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    fma_check()
    X, y = chip_smoke.second_problems()["quantile"]
    foldid, _ = _cv_foldid(X.shape[0], 3, 0, None)
    ref = cv("torch", X, y, foldid, "f64")
    print(f"float64: JAX against the port {np.max(np.abs(cv('jax', X, y, foldid, 'f64') - ref) / np.abs(ref)):.3e}")
    for pkg in ("jax", "torch"):
        for seed in range(args.perms + 1):
            perm = (np.arange(X.shape[0]) if seed == 0
                    else np.random.default_rng(seed).permutation(X.shape[0]))
            t0 = time.perf_counter()
            got = cv(pkg, X[perm], y[perm], foldid[perm], "f32")
            rel = np.abs(got - ref) / np.abs(ref)
            print(f"{pkg} float32, ordering {seed}: max rel cvm gap "
                  f"{rel.max():.3e} (per tau "
                  + ", ".join(f"{v:.3e}" for v in rel.max(axis=1))
                  + f"), {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
