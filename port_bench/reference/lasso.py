"""Plain reference of the Lasso path fits that the benchmark times.

Written from the algorithm's description, not from the program: glmnet's
standardization (1/n standard deviations, two-pass), its log-linear
lambda grid, and the ADMM solvers of the reference R package
(yixuan/ADMM: ``src/ADMMLassoTall.h``, ``src/ADMMLassoWide.h``,
``src/FADMMBase.h``, ``src/ADMMBase.h``), with the stopping rule of Boyd et
al. (2011, section 3.3):

* tall (n > p): accelerated ADMM (Goldstein et al. 2014, restart at 0.999)
  on ``x - z = 0`` against the ridge inverse ``(X'X + rho I)^-1``, rho fixed
  at ``eigmax(X'X)^(1/3) lambda_1^(2/3)``;
* wide (p >= n): linearized ADMM with step ``1/eigmax(XX')`` and the
  adaptive rho ladder (x2 / :2 at a tenfold imbalance, then a 1.2 nudge),
  started at ``(lambda / eigmax)^(1/3)``, frozen for the first four
  iterations of each solve.

``scan`` warm-starts the lambdas in sequence (x, z, y and rho carry over;
the momentum restarts); ``batch`` solves every lambda from a cold start at
once.  The eigenvalue is 50 power steps and a Rayleigh quotient from
``randn`` drawn by a CPU ``torch.Generator`` seeded 0, the start that the
library documents, so both sides round the same estimate.

``precision`` is ``"float64"`` (the reference) or ``"tf32"``: float32
storage with both operands of every matrix product rounded to TF32's
10-bit mantissa, as a tensor core takes them, and float32 accumulation.
The second is the control that ``correct`` has to reject.

Imports neither JAX nor anything of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-5
MAXIT = 10000
RESTART_TOL = 0.999
BIG = 9999.0
#: Iterations between host reads of the lanes' ``done`` flags; a lane that
#: is done is frozen, so the count only sets how often the host looks.
CHUNK = 16


class Math:
    """Products and dtype of one precision."""

    def __init__(self, precision: str, device):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.device = torch.device(device)

    def t(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mm_fixed(a, self.fixed(b))

    def fixed(self, b: torch.Tensor) -> torch.Tensor:
        """A matrix that many products take, rounded once."""
        return _round_tf32(b) if self.tf32 else b

    def mm_fixed(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with ``b`` from :meth:`fixed`."""
        return (_round_tf32(a) if self.tf32 else a) @ b


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at 10 mantissa bits (TF32)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _prox(v, pen, alpha):
    return (torch.sign(v) * torch.clamp(torch.abs(v) - alpha * pen, min=0.0)
            / (1.0 + pen * (1.0 - alpha)))


def _guard(scale, ref):
    floor = 8.0 * torch.finfo(scale.dtype).eps * torch.abs(ref)
    return torch.where(scale > floor, scale, torch.ones_like(scale))


def standardize(X, y, w=None):
    """Center and scale X's columns and y (1/n standard deviations); with
    observation weights ``w`` the moments are weighted (weights normalized
    to sum n) and the rows scaled by sqrt(w)."""
    n = X.shape[0]
    if w is None:
        wn = torch.ones(n, dtype=X.dtype, device=X.device)
    else:
        wn = w * (n / torch.sum(w))
    my = torch.sum(wn * y) / n
    yc = y - my
    sy = _guard(torch.sqrt(torch.sum(wn * yc * yc) / n), my)
    mx = torch.sum(wn[:, None] * X, dim=0) / n
    Xc = X - mx
    sx = _guard(torch.sqrt(torch.sum(wn[:, None] * Xc * Xc, dim=0) / n), mx)
    Xs, ys = Xc / sx, yc / sy
    if w is not None:
        sw = torch.sqrt(wn)
        Xs, ys = Xs * sw[:, None], ys * sw
    return Xs, ys, (mx, sx, my, sy)


def recover(stats, coef):
    mx, sx, my, sy = stats
    coef = coef / sx * sy
    return my - coef @ mx, coef


def lambda_grid(M: Math, Xs, ys, stats, nlambda, ratio):
    n = Xs.shape[0]
    top = torch.max(torch.abs(M.mm(ys[None, :], Xs)[0]))
    lmax = top / n * stats[3]
    lmin = ratio * lmax
    a, b = torch.log(lmax), torch.log(lmin)
    t = torch.arange(nlambda - 1, dtype=M.dtype, device=M.device) / (nlambda - 1)
    return torch.exp(torch.cat([a * (1 - t) + b * t, b.reshape(1)]))


def eigmax(M: Math, matvec, dim):
    v = torch.randn(dim, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float32).to(M.device, M.dtype)
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(50):
        w = matvec(v)
        v = w / torch.clamp(torch.sqrt(torch.sum(w * w)), min=1e-30)
    w = matvec(v)
    return torch.dot(v, w) / torch.clamp(torch.dot(v, v), min=1e-30)


# ---------------------------------------------------------------------------
# Tall regime
# ---------------------------------------------------------------------------

def tall_setup(M: Math, Xs, ys, lam_first):
    XtX = M.mm(Xs.mT, Xs)
    Xty = M.mm(ys[None, :], Xs)[0]
    sprad = eigmax(M, lambda v: M.mm(XtX, v[:, None])[:, 0], XtX.shape[0])
    rho = sprad.pow(1.0 / 3.0) * lam_first ** (2.0 / 3.0)
    eye = torch.eye(XtX.shape[0], dtype=M.dtype, device=M.device)
    Minv = torch.cholesky_inverse(torch.linalg.cholesky(XtX + rho * eye))
    return Minv, Xty, rho


def _fadmm_step(M, Minv, Xty, lam, rho, alpha, s, sqrt_p):
    """One accelerated ADMM iteration on every lane of state ``s``
    (``Minv`` from ``M.fixed``): ``(new state, converged)``."""
    x, z, y, az, ay, aa, ac = s
    eps_pri = torch.maximum(_norm(x), _norm(z)) * EPS + sqrt_p * EPS
    eps_dua = _norm(y) * EPS + sqrt_p * EPS
    rhs = Xty - ay + rho * az
    x_new = M.mm_fixed(rhs, Minv)
    z_new = _prox(x_new + ay / rho, lam / rho, alpha)
    r_dua = rho * _norm(z_new - z)
    r = x_new - z_new
    r_pri = _norm(r)
    y_new = ay + rho * r
    done = (r_pri < eps_pri) & (r_dua < eps_dua)
    c_new = rho * r_pri * r_pri + rho * torch.sum((z_new - az) ** 2, dim=-1)
    acc = c_new < RESTART_TOL * ac
    a_acc = 0.5 + 0.5 * torch.sqrt(1.0 + 4.0 * aa * aa)
    ratio = ((aa - 1.0) / a_acc)[..., None]
    keep, accv = done[..., None], acc[..., None]
    az_new = torch.where(keep, az, torch.where(
        accv, (1.0 + ratio) * z_new - ratio * z, z))
    ay_new = torch.where(keep, ay, torch.where(
        accv, (1.0 + ratio) * y_new - ratio * y, y))
    aa_new = torch.where(done, aa, torch.where(acc, a_acc,
                                               torch.ones_like(aa)))
    ac_new = torch.where(done, ac, torch.where(acc, c_new, ac / RESTART_TOL))
    return (x_new, z_new, y_new, az_new, ay_new, aa_new, ac_new), done


class _Lanes:
    """``CHUNK`` iterations of ``step(state, it, lam)`` on k lanes as one
    unit, each lane frozen once converged or at MAXIT, and one host read
    of the lanes' flags after each unit.  ``state`` and ``lam`` are
    buffers that the caller sets between solves."""

    def __init__(self, step, state, k, lam):
        self.step = step
        self.state = tuple(t.clone() for t in state)
        self.lam = lam.clone()
        self.done = torch.zeros(k, dtype=torch.bool, device=lam.device)
        self.it = torch.zeros(k, dtype=torch.int64, device=lam.device)

    def _unit(self):
        cur, done, it = self.state, self.done, self.it
        for _ in range(CHUNK):
            active = ~done & (it < MAXIT)
            new, now = self.step(cur, it, self.lam)
            cur = tuple(torch.where(
                active.reshape(active.shape + (1,) * (o.dim() - 1)), nw, o)
                for nw, o in zip(new, cur))
            it = it + active.to(it.dtype)
            done = done | (active & now)
        for t, v in zip(self.state, cur):
            t.copy_(v)
        self.done.copy_(done)
        self.it.copy_(it)

    def solve(self) -> torch.Tensor:
        """Run every lane from ``it = 0`` to its end; the iterations."""
        self.done.zero_()
        self.it.zero_()
        while True:
            self._unit()
            if not bool(torch.any(~self.done & (self.it < MAXIT))):
                return self.it.clone()


def _tall_lanes(M, Minv, Xty, lam, rho, alpha, k):
    p = Xty.shape[0]
    Mf = M.fixed(Minv)
    zeros = torch.zeros((k, p), dtype=M.dtype, device=M.device)
    state = (zeros, zeros, zeros, zeros, zeros,
             torch.ones(k, dtype=M.dtype, device=M.device),
             torch.full((k,), BIG, dtype=M.dtype, device=M.device))
    return _Lanes(lambda st, it, lm: _fadmm_step(M, Mf, Xty, lm, rho, alpha,
                                                 st, math.sqrt(p)),
                  state, k, lam)


def tall_scan(M, Minv, Xty, ilams, rho, alpha=1.0):
    run = _tall_lanes(M, Minv, Xty, ilams[:1], rho, alpha, 1)
    x, z, y, az, ay, aa, ac = run.state
    coefs, niter = [], []
    for j in range(ilams.shape[0]):
        # Warm start: x, z, y carry over, the momentum restarts.
        az.copy_(z)
        ay.copy_(y)
        aa.fill_(1.0)
        ac.fill_(BIG)
        run.lam.copy_(ilams[j:j + 1])
        niter.append(run.solve()[0])
        coefs.append(z[0].clone())
    return torch.stack(coefs), torch.stack(niter)


def tall_batch(M, Minv, Xty, ilams, rho, alpha=1.0):
    run = _tall_lanes(M, Minv, Xty, ilams[:, None], rho, alpha,
                      ilams.shape[0])
    it = run.solve()
    return run.state[1], it


# ---------------------------------------------------------------------------
# Wide regime
# ---------------------------------------------------------------------------

def wide_setup(M: Math, Xs, ys, rho_lams):
    n = Xs.shape[0]
    lambda0 = torch.max(torch.abs(M.mm(ys[None, :], Xs)[0]))
    sprad = eigmax(M, lambda v: M.mm(Xs, M.mm(v[None, :], Xs)[0][:, None])[:, 0],
                   n)
    return lambda0, sprad, (rho_lams / sprad).pow(1.0 / 3.0)


def _admm_step(M, Xs, XsT, ys, sprad, lambda0, lam, alpha, s, it):
    """One linearized ADMM iteration with the adaptive rho ladder (rho
    frozen while ``it <= 3`` and on the converging iteration); ``Xs`` and
    its transpose ``XsT`` from ``M.fixed``."""
    x, z, y, ax, rho = s
    n, p = Xs.shape
    ssp = torch.sqrt(sprad)
    eps_pri = torch.maximum(_norm(ax), _norm(z)) * EPS + math.sqrt(n) * EPS
    eps_dua = ssp * _norm(y) * EPS + math.sqrt(p) * EPS
    r_ = rho[..., None]
    v = x - M.mm_fixed(ax + z + y / r_, Xs) / sprad
    x_new = _prox(v, lam / (r_ * sprad), alpha)
    x_new = torch.where(lam > lambda0 * (1.0 - 1e-5), torch.zeros_like(x_new),
                        x_new)
    ax_new = M.mm_fixed(x_new, XsT)
    z_new = -(ys + y + r_ * ax_new) / (1.0 + r_)
    r_dua = rho * ssp * _norm(z_new - z)
    r_pri = _norm(ax_new + z_new)
    y_new = y + r_ * (ax_new + z_new)
    done = (r_pri < eps_pri) & (r_dua < eps_dua)
    rp, rd = r_pri / eps_pri, r_dua / eps_dua
    ra = torch.where(rp > 10.0 * rd, rho * 2.0, rho)
    ra = torch.where(rd > 10.0 * rp, ra * 0.5, ra)
    ra = torch.where(r_pri < eps_pri, ra / 1.2, ra)
    ra = torch.where(r_dua < eps_dua, ra * 1.2, ra)
    rho_new = torch.where(done | (it <= 3), rho, ra)
    return (x_new, z_new, y_new, ax_new, rho_new), done


def _wide_lanes(M, Xs, ys, lambda0, sprad, rho, lam, alpha):
    n, p = Xs.shape
    k = rho.shape[0]
    Xf, XTf = M.fixed(Xs), M.fixed(Xs.mT.contiguous())
    zn = torch.zeros((k, n), dtype=M.dtype, device=M.device)
    state = (torch.zeros((k, p), dtype=M.dtype, device=M.device), zn, zn, zn,
             rho)
    return _Lanes(lambda st, it, lm: _admm_step(M, Xf, XTf, ys, sprad,
                                                lambda0, lm, alpha, st, it),
                  state, k, lam)


def wide_scan(M, Xs, ys, ilams, alpha=1.0):
    lambda0, sprad, rho0 = wide_setup(M, Xs, ys, ilams[0])
    run = _wide_lanes(M, Xs, ys, lambda0, sprad, rho0.reshape(1),
                      ilams[:1], alpha)
    coefs, niter = [], []
    for j in range(ilams.shape[0]):
        # Warm start: x, z, y, Ax and rho carry over.
        run.lam.copy_(ilams[j:j + 1])
        niter.append(run.solve()[0])
        coefs.append(run.state[0][0].clone())
    return torch.stack(coefs), torch.stack(niter)


def wide_batch(M, Xs, ys, ilams, alpha=1.0):
    lambda0, sprad, rho = wide_setup(M, Xs, ys, ilams)
    run = _wide_lanes(M, Xs, ys, lambda0, sprad, rho, ilams[:, None], alpha)
    it = run.solve()
    return run.state[0], it


# ---------------------------------------------------------------------------
# The entry points' semantics
# ---------------------------------------------------------------------------

def default_ratio(n, p):
    return 0.01 if n < p else 1e-4


def lasso_path(X, y, *, precision="float64", device="cuda", nlambda=100,
               lambda_min_ratio=None, path_mode="scan", lambdas=None,
               weights=None):
    """glmnet's gaussian path: ``{"lambdas", "beta0", "coef", "niter"}`` as
    numpy float64 (the user's scale; coef (nlambda, p))."""
    M = Math(precision, device)
    X, y = M.t(X), M.t(y)
    n, p = X.shape
    w = None if weights is None else M.t(weights)
    Xs, ys, stats = standardize(X, y, w)
    if lambdas is None:
        ratio = (default_ratio(n, p) if lambda_min_ratio is None
                 else lambda_min_ratio)
        lams = lambda_grid(M, Xs, ys, stats, int(nlambda), ratio)
    else:
        lams = torch.sort(M.t(lambdas).reshape(-1), descending=True).values
    ilams = lams * n / stats[3]
    if n > p:
        Minv, Xty, rho = tall_setup(M, Xs, ys, ilams[0])
        solve = tall_batch if path_mode == "batch" else tall_scan
        coefs, niter = solve(M, Minv, Xty, ilams, rho)
    else:
        solve = wide_batch if path_mode == "batch" else wide_scan
        coefs, niter = solve(M, Xs, ys, ilams)
    beta0, coef = recover(stats, coefs)
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()
    return {"lambdas": f64(lams), "beta0": f64(beta0), "coef": f64(coef),
            "niter": niter.cpu().numpy().astype(np.int64)}


def fold_ids(n, nfolds, seed):
    """cv.glmnet's fold assignment as the library documents it: rows dealt
    round robin over ``np.random.default_rng(seed).permutation(n)``."""
    rng = np.random.default_rng(seed)
    return np.resize(np.arange(nfolds, dtype=np.int64), n)[rng.permutation(n)]


def cv_lasso_path(X, y, *, nfolds=10, seed=0, precision="float64",
                  device="cuda", nlambda=100, lambda_min_ratio=None):
    """cv.glmnet's protocol with the batch path: the full fit sets the grid;
    fold f is the fit without fold f's rows (weight 0), scored on them by
    squared error.  ``{"lambdas", "cvm", "cvsd", "lambda_min", "fit"}``."""
    full = lasso_path(X, y, precision=precision, device=device,
                      path_mode="batch", nlambda=nlambda,
                      lambda_min_ratio=lambda_min_ratio)
    M = Math(precision, device)
    Xd = M.t(X)
    n = Xd.shape[0]
    fid = fold_ids(n, nfolds, seed)
    eta = np.empty((n, full["lambdas"].shape[0]))
    for f in range(nfolds):
        mask = (fid != f).astype(np.float64)
        res = lasso_path(Xd, y, precision=precision, device=device,
                         path_mode="batch", lambdas=full["lambdas"],
                         weights=mask)
        rows = np.flatnonzero(fid == f)
        coef = M.t(res["coef"])
        eta[rows] = (M.t(res["beta0"])[None, :]
                     + M.mm(Xd[torch.as_tensor(rows, device=M.device)],
                            coef.mT)).cpu().double().numpy()
    err = (eta - np.asarray(y, np.float64)[:, None]) ** 2
    cvm = err.mean(axis=0)
    cvsd = np.sqrt(((err - cvm) ** 2).mean(axis=0) / (n - 1))
    i = int(np.argmin(cvm))
    return {"lambdas": full["lambdas"], "cvm": cvm, "cvsd": cvsd,
            "lambda_min": float(full["lambdas"][i]), "fit": full}
