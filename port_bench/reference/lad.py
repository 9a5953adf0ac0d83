"""Plain reference of the LAD (median regression) fit that the benchmark
times, without an intercept: ``minimize ||y - X b||_1``.

Written from the algorithm's description, not from the program: the
reference R package's ADMM in range space (yixuan/ADMM
``src/ADMMLAD.h:7-29``), with ``xx = X b`` held to Range(X),

    minimize ||z||_1   s.t.   xx - z = y,  xx in Range(X),

accelerated as the package's ``src/FADMMBase.h`` does (Goldstein et al.
2014, restart at 0.999), with the stopping rule of Boyd et al. (2011,
section 3.3):

* x-update: the orthogonal projection of ``y - u/rho + z`` onto Range(X),
  ``X (X'X)^-1 X' v``, factored through the Cholesky factor of X'X: the
  package's own route past n = 2000 (``src/ADMMLAD.h:74-77``); no hat
  matrix is formed;
* z-update: soft-thresholding at ``1/rho`` (``src/ADMMLAD.h:94-98``);
* the coefficients: ``(X'X)^-1 X' (y - u/rho + z)`` at the last
  extrapolated point (``src/ADMMLAD.h:220-225``).

Departures from the package, none of which moves the optimum:

* X's columns and y are divided by their 1/n standard deviations before
  the solve, and the coefficients scaled back (the package standardizes
  too, ``src/LAD.cpp:34``); X is not centered, as without an intercept
  centering would change the problem;
* rho is fixed at the value given (the package's accelerated base may
  adapt it);
* the tolerance is :data:`EPS`, absolute and relative: a hundredth of the
  program's float32 2e-5; at most :data:`MAXIT` iterations;
* ``(X'X)^-1`` is formed once from the Cholesky factor and applied as a
  product (two triangular solves an iteration in the package).

One solve, one lane, no batching and no kernel: the scalars of the
stopping test and the restart live on the host, one read of six norms an
iteration.

``precision`` is ``"float64"`` (the reference) or ``"tf32"`` (the control
that ``correct`` has to reject), as :class:`lasso.Math` takes it: float32
storage with both operands of every product rounded to TF32.

Imports neither JAX nor anything of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference.lasso import Math

EPS = 2e-7
MAXIT = 50000
RESTART_TOL = 0.999


def _sd(a, dim=0):
    """1/n standard deviation (two-pass)."""
    c = a - torch.mean(a, dim=dim, keepdim=True)
    return torch.sqrt(torch.mean(c * c, dim=dim))


def lad_fit(X, y, *, precision="float64", device="cuda", rho=5.0, eps=EPS,
            maxit=MAXIT) -> dict:
    """``{"coef" (p,), "niter", "converged"}``, the coefficients numpy
    float64 on the user's scale."""
    M = Math(precision, device)
    X, y = M.t(X), M.t(y)
    n = X.shape[0]
    sx, sy = _sd(X), _sd(y)
    Xs, ys = X / sx, y / sy
    Ginv = torch.cholesky_inverse(torch.linalg.cholesky(M.mm(Xs.mT, Xs)))
    Xf, XTf, Gf = (M.fixed(Xs.contiguous()), M.fixed(Xs.mT.contiguous()),
                   M.fixed(Ginv.contiguous()))

    def project(v):
        """X (X'X)^-1 X' v, as row vectors: v X, then Ginv, then X'."""
        w = M.mm_fixed(v[None, :], Xf)
        return M.mm_fixed(M.mm_fixed(w, Gf), XTf)[0]

    rho = float(rho)
    floor = math.sqrt(n) * eps
    ynorm = float(torch.linalg.vector_norm(ys))
    x = z = u = zh = uh = torch.zeros(n, dtype=M.dtype, device=M.device)
    a, c = 1.0, 9999.0
    it, done = 0, False
    while it < maxit and not done:
        x_new = project(torch.add(ys, uh, alpha=-1.0 / rho) + zh)
        d = x_new - ys
        z_new = torch.nn.functional.softshrink(
            torch.add(d, uh, alpha=1.0 / rho), 1.0 / rho)
        r = d - z_new
        u_new = torch.add(uh, r, alpha=rho)
        dz = z_new - z
        # The tolerances take the iterate's norms before the update; one
        # host read a step brings every norm the test and restart use.
        norms = torch.linalg.vector_norm(
            torch.stack([x, z, u, r, dz, z_new - zh]), dim=1)
        nx, nz, nu, r_pri, ndz, nez = norms.tolist()
        eps_pri = max(nx, nz, ynorm) * eps + floor
        eps_dua = nu * eps + floor
        done = r_pri < eps_pri and rho * ndz < eps_dua
        it += 1
        if not done:
            # On the converging step the extrapolated point is held: the
            # coefficients are read from the point that passed the test.
            c_new = rho * r_pri * r_pri + rho * nez * nez
            if c_new < RESTART_TOL * c:
                a_new = 0.5 + 0.5 * math.sqrt(1.0 + 4.0 * a * a)
                ratio = (a - 1.0) / a_new
                zh = torch.add(z_new, dz, alpha=ratio)
                uh = torch.add(u_new, u_new - u, alpha=ratio)
                a, c = a_new, c_new
            else:
                zh, uh = z, u
                a, c = 1.0, c / RESTART_TOL
        x, z, u = x_new, z_new, u_new
    b = M.mm(M.mm(torch.add(ys, uh, alpha=-1.0 / rho)[None, :] + zh, Xs),
             Ginv)[0]
    coef = (b / sx * sy).detach().to("cpu", torch.float64).numpy()
    return {"coef": coef, "niter": it, "converged": done}


def objective(X, y, coef) -> float:
    """``||y - X coef||_1`` in float64 on the host."""
    X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
    return float(np.abs(y - X @ np.asarray(coef, np.float64)).sum())
