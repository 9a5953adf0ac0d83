"""Wide Lasso/Elastic-Net path kernels (p >= n): wrappers and plain forms.

``wide_path_batch`` replaces ``admm_tpu/ops/wide_path.py::_wide_kernel``
(``wide_path_batch_pallas``): K lanes of linearized ADMM, each with its own
adaptive-rho ladder, solved at once.  ``wide_path_scan`` is one lane
warm-started over the lambdas, what ``models/lasso.py::_solve_path_wide``
computes on the engine; it replaces no Pallas kernel (the JAX package runs
that path on its engine).  On a CUDA tensor each launches its hand-written
kernel in ``csrc/wide_path.cu``; on a CPU tensor each runs its plain form,
:func:`wide_path_batch_reference` / :func:`wide_path_scan_reference`, a
direct translation of the loop.  Exact shapes: X (n, p), ys (n,), ilams
(k,) and the batch's rhos (k,) -> ``(x (k, p), niter (k,) int32)``.

The kernel is one cooperative grid, one block per SM: the rows of X' and
of X are split over the blocks and every block works on all active lanes,
so one load of a matrix element serves every lambda
(``csrc/admm_common.cuh::lanes_product``).  One lambda (k = 1) is the same
kernel.  Lane state (x: ``k ldp`` floats; Ax, z, y and the gradient's left
factor ``Ax + z + y/rho``: ``4 k ldn`` floats, ``ld*`` the dimensions padded
to a multiple of four) lives in a zeroed float32 scratch buffer in device
memory and the blocks' partial sums of squares in ``k 5 grid`` float64s,
which this wrapper allocates with zero-padded copies of X and X'
(:func:`launch_plan`).  The caller checks :func:`fits` before it calls.

The scan kernel is one cooperative grid too, one block per SM, and one
launch a path: block b holds its rows of X and its columns of X in shared
memory (read from device memory once a call), a full copy of the lane,
and exchanges the new x, then its rows of Ax, z and y with their partial
sums of squares, through scratch in device memory: two grid syncs an
iteration (:func:`scan_launch_plan`).  The caller checks
:func:`scan_fits` before it calls.
"""
from __future__ import annotations

import torch

from ..diag import profile
from ._build import check, load_library
from ._common import (GRID_THREADS, PRODUCT_SMEM_BYTES, check_cuda_input,
                      enet_prox, lane_groups, matmul64, pad4, padded_rows,
                      rnorm, row_tile, sm_count, solve_span)

#: The dispatch bound of :func:`fits`, in floats: (232448 - 2048) / 4.
_SMEM_FLOATS = (232448 - 2048) // 4

#: Sums of squares a block writes per lane and iteration, and the
#: grid-wide syncs of one iteration (one after each product's elementwise
#: stage, the last after every block has formed its rows of the next
#: gradient's left factor with the rho the ladder has just set).
_SUMS = 5
SYNCS_PER_ITERATION = 3
#: The scan kernel's threads a block, and its grid syncs an iteration
#: (after the x-update; after the z/y update with the blocks' partials).
SCAN_THREADS = 512
SCAN_SYNCS_PER_ITERATION = 2


def fits(n: int, p: int) -> bool:
    """Whether the path sends an (n, p) problem to the wide kernel:
    ``3p + 5n <= 57600``.  This is the port's dispatch rule and no longer
    a shared-memory size (the first kernel held 3p + 5n floats of lane
    state in one block's shared memory; the present one keeps lane state
    in device memory and uses :data:`PRODUCT_SMEM_BYTES` whatever the
    shape).  Every shape under the bound has been the kernel's since;
    kernel against engine beyond it is not measured yet."""
    return n >= 1 and p >= 1 and 3 * p + 5 * n <= _SMEM_FLOATS


def launch_plan(n: int, p: int, k: int, sms: int) -> dict:
    """How one call is launched on a card of ``sms`` SMs: the grid, the
    padded leading dimensions, each block's rows of X (``n_tiles``; also
    its rows in the z and y updates) and of X' (``p_tiles``; its
    coordinates in the x-update), the lane groups (one launch each) and
    the scratch sizes of the largest."""
    ldp, ldn = pad4(p), pad4(n)
    groups = lane_groups(k)
    lanes = max(hi - lo for lo, hi in groups)
    return dict(
        grid=sms, threads=GRID_THREADS, smem_bytes=PRODUCT_SMEM_BYTES,
        ldp=ldp, ldn=ldn, lane_groups=groups,
        n_tiles=[row_tile(n, b, sms) for b in range(sms)],
        p_tiles=[row_tile(p, b, sms) for b in range(sms)],
        scratch_floats=lanes * ldp + 4 * lanes * ldn,
        partial_doubles=sms * lanes * _SUMS)


def _rho_ladder(rho, r_pri, eps_pri, r_dua, eps_dua, nudge):
    """One step of the kernels' adaptive-rho ladder
    (``csrc/wide_path.cu::rho_ladder``): x2 / :2 when one scaled residual
    dominates by 10x, then a nudge (``nudge``, 1.2 as a tensor: true
    division, as in the kernels) toward whichever residual has converged."""
    ratio_p = r_pri / eps_pri
    ratio_d = r_dua / eps_dua
    rho = torch.where(ratio_p > 10.0 * ratio_d, rho * 2.0, rho)
    rho = torch.where(ratio_d > 10.0 * ratio_p, rho * 0.5, rho)
    rho = torch.where(r_pri < eps_pri, rho / nudge, rho)
    return torch.where(r_dua < eps_dua, rho * nudge, rho)


def scan_launch_plan(n: int, p: int, sms: int) -> dict:
    """How one scan call is launched on a card of ``sms`` SMs: the grid
    (one block per SM), the padded leading dimensions, the most rows and
    columns of X a block holds (``rows_max``, ``cols_max``: block b owns
    ``row_tile(n, b, grid)`` and ``row_tile(p, b, grid)``), the dynamic
    shared memory of a block (``csrc/wide_path.cu::scan_smem_bytes``: x
    and the gradient's left factor as float64, the two slices, Ax, z and
    y, the products' segment sums and the rows' sums of squares) and the
    scratch the blocks exchange the new x (``ldp`` floats), Ax, z and y
    (``3 ldn``) and their partial sums (``5 grid`` doubles) through."""
    grid = int(sms)
    ldp, ldn = pad4(p), pad4(n)
    rows_max, cols_max = -(-n // grid), -(-p // grid)
    part = max(2 * (SCAN_THREADS // 32), rows_max, cols_max)
    smem = (8 * (ldp + ldn) + 4 * (rows_max * ldp + cols_max * ldn + 3 * ldn)
            + 8 * (part + _SUMS * rows_max))
    return dict(grid=grid, smem_bytes=smem, ldp=ldp, ldn=ldn,
                rows_max=rows_max, cols_max=cols_max,
                exchange_floats=ldp + 3 * ldn, partial_doubles=_SUMS * grid)


def scan_fits(n: int, p: int, sms: int) -> bool:
    """Whether the scan kernel takes an (n, p) problem on a card of
    ``sms`` SMs: a block's slices of X and its copy of the lane fit one
    block's shared memory (``4 * _SMEM_FLOATS`` bytes).  At n = 1000 on 132
    SMs that is p <= 2944."""
    return (n >= 1 and p >= 1 and 1 <= sms <= SCAN_THREADS
            and scan_launch_plan(n, p, sms)["smem_bytes"] <= 4 * _SMEM_FLOATS)


def wide_path_scan_reference(X, ys, ilams, rho, sprad, lambda0, eps_abs,
                             eps_rel, alpha, maxit, *,
                             rho_start_iter: int = 3):
    """Plain PyTorch form of the scan kernel: one lane warm-started over
    the lambda grid (``core.engine.warm_start``: x, z, y and rho kept, the
    iteration count reset), one host read per iteration.  Products and
    squared norms accumulate in float64 and round once, as in the
    kernel."""
    n, p = X.shape
    k = ilams.shape[0]
    dtype, dev = X.dtype, X.device
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    sqrt_n, sqrt_p = torch.sqrt(f(float(n))), torch.sqrt(f(float(p)))
    sprad, lambda0, alpha = f(sprad), f(lambda0), f(alpha)
    sqrt_sprad = torch.sqrt(sprad)
    rho = f(rho).reshape(())
    X64 = X.to(torch.float64)
    # True division by 1.2, as in the kernel (see _common.fadmm_momentum).
    nudge = f(1.2)

    x = torch.zeros((p,), dtype=dtype, device=dev)
    z = torch.zeros((n,), dtype=dtype, device=dev)
    y, aux = torch.zeros_like(z), torch.zeros_like(z)
    x_out = torch.empty((k, p), dtype=dtype, device=dev)
    niters = []
    for kk in range(k):
        lam = ilams[kk].to(dtype)
        zero_exit = bool(lam > lambda0 * (1.0 - 1e-5))
        it = 0
        while it < maxit:
            eps_pri = (torch.maximum(rnorm(aux), rnorm(z)) * eps_rel
                       + sqrt_n * eps_abs)
            eps_dua = sqrt_sprad * rnorm(y) * eps_rel + sqrt_p * eps_abs
            grad = matmul64(aux + z + y / rho, X64)
            x_new = enet_prox(x - grad / sprad, lam / (rho * sprad), alpha)
            if zero_exit:
                x_new = torch.zeros_like(x_new)
            ax = matmul64(x_new, X64.mT)
            z_new = -(ys + y + rho * ax) / (1.0 + rho)
            r_dua = rho * sqrt_sprad * rnorm(z_new - z)
            r = ax + z_new
            r_pri = rnorm(r)
            y = y + rho * r
            done = bool((r_pri < eps_pri) & (r_dua < eps_dua))
            if not done and it > rho_start_iter:
                rho = _rho_ladder(rho, r_pri, eps_pri, r_dua, eps_dua, nudge)
            x, z, aux = x_new, z_new, ax
            it += 1
            if done:
                break
        x_out[kk] = x
        niters.append(it)
    return x_out, torch.tensor(niters, dtype=torch.int32, device=dev)


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

        rho_a = _rho_ladder(rho, r_pri, eps_pri, r_dua, eps_dua, nudge)
        rho_new = rho if it <= rho_start_iter else torch.where(now_done, rho,
                                                               rho_a)

        pick = lambda new, old: torch.where(done, old, new)
        x, z, y, aux = pick(x_new, x), pick(z_new, z), pick(y_new, y), pick(ax, aux)
        rho = pick(rho_new, rho)
        niter = niter + (~done).to(torch.int32)
        done = done | now_done
    return x, niter.reshape(k)


@solve_span("wide_path_batch")
def wide_path_batch(X, ys, ilams, rhos, sprad, lambda0, eps_abs, eps_rel,
                    alpha, maxit, *, rho_start_iter: int = 3):
    """The batched wide path (``wide_path_batch_pallas``).

    CUDA tensors launch ``wide_path_batch_kernel``; CPU tensors run
    :func:`wide_path_batch_reference`.  ``rhos`` is per lane (k,).
    Returns ``(x (k, p), niter (k,))``.
    """
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
    plan = launch_plan(n, p, k, sm_count(dev))
    ldp, ldn = plan["ldp"], plan["ldn"]
    # Zero-padded copies, made once per call: rows of X and of its
    # transpose all start on 16-byte boundaries.
    X_p, XT_p = padded_rows(X), padded_rows(X.mT)
    x = torch.empty((k, p), dtype=torch.float32, device=dev)
    niter = torch.empty((k,), dtype=torch.int32, device=dev)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in plan["lane_groups"]:
            # The iterates start at 0, and the padding stays 0.
            scratch = torch.zeros((plan["scratch_floats"],),
                                  dtype=torch.float32, device=dev)
            err = lib.admm_wide_path_batch(
                X_p.data_ptr(), XT_p.data_ptr(), ys.data_ptr(),
                ilams[lo:hi].data_ptr(), rhos[lo:hi].data_ptr(),
                scratch.data_ptr(), partial.data_ptr(), x[lo:hi].data_ptr(),
                niter[lo:hi].data_ptr(), n, p, hi - lo, ldp, ldn,
                plan["grid"], float(sprad), float(lambda0), float(eps_abs),
                float(eps_rel), float(alpha), int(maxit),
                int(rho_start_iter), stream)
            check(lib, err, "admm_wide_path_batch")
            profile.count("kernel.launches.wide_path_batch")
    return x, niter


@solve_span("wide_path_scan")
def wide_path_scan(X, ys, ilams, rho, sprad, lambda0, eps_abs, eps_rel,
                   alpha, maxit, *, rho_start_iter: int = 3):
    """The warm-started wide path, one lane over the lambdas.

    CUDA tensors launch ``wide_path_scan_kernel``; CPU tensors run
    :func:`wide_path_scan_reference`.  ``rho`` is the path's starting rho
    (a scalar).  Returns ``(x (k, p), niter (k,))``.
    """
    if X.device.type == "cpu":
        return wide_path_scan_reference(X, ys, ilams, rho, sprad, lambda0,
                                        eps_abs, eps_rel, alpha, maxit,
                                        rho_start_iter=rho_start_iter)
    n, p = X.shape
    k = ilams.shape[0]
    dev = X.device
    check_cuda_input("X", X, (n, p), dev)
    check_cuda_input("ys", ys, (n,), dev)
    check_cuda_input("ilams", ilams, (k,), dev)
    sms = sm_count(dev)
    if not scan_fits(n, p, sms):
        raise ValueError(f"wide scan kernel: the slices of an (n={n}, "
                         f"p={p}) X do not fit a block on {sms} SMs")
    if k < 1:
        raise ValueError("ilams must hold at least one lambda")
    lib = load_library()
    plan = scan_launch_plan(n, p, sms)
    x = torch.empty((k, p), dtype=torch.float32, device=dev)
    niter = torch.empty((k,), dtype=torch.int32, device=dev)
    # Scratch the blocks exchange x and the rows of Ax, z and y through
    # (zero, so the padding the copies read is zero) and their partials.
    xchg = torch.zeros((plan["exchange_floats"],), dtype=torch.float32,
                       device=dev)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    ldp, ldn = plan["ldp"], plan["ldn"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.admm_wide_path_scan(
            X.data_ptr(), ys.data_ptr(), ilams.data_ptr(), xchg.data_ptr(),
            xchg[ldp:].data_ptr(), partial.data_ptr(), x.data_ptr(),
            niter.data_ptr(), n, p, k, ldp, ldn, plan["rows_max"],
            plan["cols_max"], plan["grid"], float(rho), float(sprad),
            float(lambda0), float(eps_abs), float(eps_rel), float(alpha),
            int(maxit), int(rho_start_iter), stream)
    check(lib, err, "admm_wide_path_scan")
    profile.count("kernel.launches.wide_path_scan")
    return x, niter


__all__ = ["SCAN_SYNCS_PER_ITERATION", "SYNCS_PER_ITERATION", "fits",
           "launch_plan", "scan_fits", "scan_launch_plan", "wide_path_batch",
           "wide_path_batch_reference", "wide_path_scan",
           "wide_path_scan_reference"]
