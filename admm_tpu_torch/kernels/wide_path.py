"""Wide Lasso/Elastic-Net path kernel (p >= n): wrapper and plain form.

``wide_path_batch`` replaces ``admm_tpu/ops/wide_path.py::_wide_kernel``
(``wide_path_batch_pallas``): K lanes of linearized ADMM, each with its own
adaptive-rho ladder, solved at once.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/wide_path.cu``; on a CPU tensor it runs
:func:`wide_path_batch_reference`, a direct translation of the fused loop.
Exact shapes: X (n, p), ys (n,), ilams and rhos (k,) -> ``(x (k, p),
niter (k,) int32)``.

The kernel holds 3p + 5n floats of lane state in shared memory; the
caller checks :func:`fits` before it calls.
"""
from __future__ import annotations

import torch

from ._build import check, load_library
from ._common import check_cuda_input, enet_prox, matmul64, rnorm

#: Shared memory one block may hold on sm_90, less 2 KB of scratch.
_SMEM_FLOATS = (232448 - 2048) // 4

#: Launch count: the wrapper adds one where it launches the kernel.
batch_launches = 0


def fits(n: int, p: int) -> bool:
    """Whether the wide kernel takes an (n, p) problem: x (float32 and
    float64 copies, 3p floats), z, y, Ax (float32) and the gradient's left
    factor (float64), 5n floats, must fit one block's shared memory."""
    return n >= 1 and p >= 1 and 3 * p + 5 * n <= _SMEM_FLOATS


def wide_path_batch_reference(X, ys, ilams, rhos, sprad, lambda0, eps_abs,
                              eps_rel, alpha, maxit, *,
                              rho_start_iter: int = 3):
    """Plain PyTorch form of the wide kernel: K lanes, frozen once
    converged, one host read per iteration for the all-done exit.
    Products and squared norms accumulate in float64 and round once, as
    in the kernel."""
    n, p = X.shape
    k = ilams.shape[0]
    dtype, dev = X.dtype, X.device
    sqrt_n = torch.sqrt(torch.tensor(float(n), dtype=dtype, device=dev))
    sqrt_p = torch.sqrt(torch.tensor(float(p), dtype=dtype, device=dev))
    sprad = torch.as_tensor(sprad, dtype=dtype, device=dev)
    lambda0 = torch.as_tensor(lambda0, dtype=dtype, device=dev)
    sqrt_sprad = torch.sqrt(sprad)
    lam = ilams.to(dtype).reshape(k, 1)
    rho = torch.broadcast_to(torch.as_tensor(rhos, dtype=dtype, device=dev),
                             (k,)).reshape(k, 1).clone()
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    X64 = X.to(torch.float64)
    # True division by 1.2, as in the kernel (see _common.fadmm_momentum).
    nudge = torch.tensor(1.2, dtype=dtype, device=dev)

    x = torch.zeros((k, p), dtype=dtype, device=dev)
    z = torch.zeros((k, n), dtype=dtype, device=dev)
    y, aux = torch.zeros_like(z), torch.zeros_like(z)
    done = torch.zeros((k, 1), dtype=torch.bool, device=dev)
    niter = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    zero_exit = lam > lambda0 * (1.0 - 1e-5)
    for it in range(int(maxit)):
        if bool(torch.all(done)):
            break
        eps_pri = (torch.maximum(rnorm(aux), rnorm(z)) * eps_rel
                   + sqrt_n * eps_abs)
        eps_dua = sqrt_sprad * rnorm(y) * eps_rel + sqrt_p * eps_abs
        tmp = aux + z + y / rho
        grad = matmul64(tmp, X64)
        v = x - grad / sprad
        x_new = enet_prox(v, lam / (rho * sprad), alpha)
        x_new = torch.where(zero_exit, torch.zeros_like(x_new), x_new)
        ax = matmul64(x_new, X64.mT)
        z_new = -(ys + y + rho * ax) / (1.0 + rho)
        r_dua = rho * sqrt_sprad * rnorm(z_new - z)
        r = ax + z_new
        r_pri = rnorm(r)
        y_new = y + rho * r
        now_done = (r_pri < eps_pri) & (r_dua < eps_dua)

        ratio_p = r_pri / eps_pri
        ratio_d = r_dua / eps_dua
        rho_a = torch.where(ratio_p > 10.0 * ratio_d, rho * 2.0, rho)
        rho_a = torch.where(ratio_d > 10.0 * ratio_p, rho_a * 0.5, rho_a)
        rho_a = torch.where(r_pri < eps_pri, rho_a / nudge, rho_a)
        rho_a = torch.where(r_dua < eps_dua, rho_a * nudge, rho_a)
        rho_new = rho if it <= rho_start_iter else torch.where(now_done, rho,
                                                               rho_a)

        pick = lambda new, old: torch.where(done, old, new)
        x, z, y, aux = pick(x_new, x), pick(z_new, z), pick(y_new, y), pick(ax, aux)
        rho = pick(rho_new, rho)
        niter = niter + (~done).to(torch.int32)
        done = done | now_done
    return x, niter.reshape(k)


def wide_path_batch(X, ys, ilams, rhos, sprad, lambda0, eps_abs, eps_rel,
                    alpha, maxit, *, rho_start_iter: int = 3):
    """The batched wide path (``wide_path_batch_pallas``).

    CUDA tensors launch ``wide_path_batch_kernel``; CPU tensors run
    :func:`wide_path_batch_reference`.  ``rhos`` is per lane (k,).
    Returns ``(x (k, p), niter (k,))``.
    """
    global batch_launches
    if X.device.type == "cpu":
        return wide_path_batch_reference(X, ys, ilams, rhos, sprad, lambda0,
                                         eps_abs, eps_rel, alpha, maxit,
                                         rho_start_iter=rho_start_iter)
    n, p = X.shape
    k = ilams.shape[0]
    dev = X.device
    check_cuda_input("X", X, (n, p), dev)
    check_cuda_input("ys", ys, (n,), dev)
    check_cuda_input("ilams", ilams, (k,), dev)
    check_cuda_input("rhos", rhos, (k,), dev)
    if not fits(n, p):
        raise ValueError(f"wide path kernel takes 3p + 5n <= {_SMEM_FLOATS}, "
                         f"got n={n}, p={p}")
    if k < 1:
        raise ValueError("ilams must hold at least one lambda")
    lib = load_library()
    x = torch.empty((k, p), dtype=torch.float32, device=dev)
    niter = torch.empty((k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.admm_wide_path_batch(
            X.data_ptr(), ys.data_ptr(), ilams.data_ptr(), rhos.data_ptr(),
            x.data_ptr(), niter.data_ptr(), n, p, k, float(sprad),
            float(lambda0), float(eps_abs), float(eps_rel), float(alpha),
            int(maxit), int(rho_start_iter), stream)
    check(lib, err, "admm_wide_path_batch")
    batch_launches += 1
    return x, niter


__all__ = ["fits", "wide_path_batch", "wide_path_batch_reference"]
