"""Tall Lasso/Elastic-Net path kernels (n > p): wrappers and plain forms.

``tall_path_batch`` replaces ``admm_tpu/ops/tall_path.py::_kernel`` (all
lambdas at once, cold start) and ``tall_path_scan`` replaces
``::_scan_kernel`` (one lane warm-started in sequence over lambda).  On a
CUDA tensor each launches its hand-written kernel in
``csrc/tall_path.cu``; on a CPU tensor each runs its plain PyTorch form,
``tall_path_batch_reference`` / ``tall_path_scan_reference``, which is a
direct translation of the fused loop.  Both take exact (unpadded) shapes:
Minv (p, p), Xty (p,), ilams (k,) -> ``(z (k, p), niter (k,) int32)``.

Both kernels are cooperative grids.  The batch kernel is one block per
SM (:func:`batch_launch_plan`): every block works on all active lanes, and
the coordinates, rows of a transposed copy of Minv with a padded leading
dimension that this wrapper makes once per call, are split over the
blocks, so one load of an element of Minv serves every lambda
(``csrc/admm_common.cuh::lanes_product``).  Lane state (eight rows of
``ldp`` floats per lane) lives in a zeroed float32 scratch buffer in device
memory and the blocks' partial sums in ``k 6 grid`` float64s; more than 128
lambdas go in groups of 128.  The scan kernel is up to one block per SM
(:func:`launch_plan`): the columns of Minv, read as rows of the same
transposed copy, are split over the grid's warps, every block holds a full
copy of the lane (``2 pad4(p) + 5p`` floats of shared memory) and the
blocks exchange z_new, y_new and their partial sums of squares through
scratch in device memory, with one grid-wide sync per iteration.  Both take
``p <= MAX_P``, the bound of the first kernels, kept as the port's rule;
the caller checks :func:`fits` before it calls.
"""
from __future__ import annotations

import torch

from ..diag import profile
from ._build import check, load_library
from ._common import (GRID_THREADS, PRODUCT_SMEM_BYTES, check_cuda_input,
                      enet_prox, fadmm_momentum, lane_groups, matmul64, pad4,
                      padded_rows, rnorm, row_tile, sm_count, solve_span,
                      sqsum)

#: Largest p the kernels take: the first batch kernel's bound (8p floats of
#: lane state in one block's 232448 - 2048 bytes of shared memory), kept.
MAX_P = (232448 - 2048) // (8 * 4)

#: Sums of squares a block writes per lane and iteration, and the
#: grid-wide syncs of one iteration of each kernel (batch: one after the
#: elementwise stage, one after the refresh that forms the next right-hand
#: side).
_SUMS = 6
SCAN_SYNCS_PER_ITERATION = 1
BATCH_SYNCS_PER_ITERATION = 2
#: Rows of ``ldp`` floats of batch lane state per lane: the right-hand
#: side, x_new, z_new, y_new, z, y, adj_z, adj_y.
_BATCH_ROWS = 8


def fits(p: int) -> bool:
    """Whether the tall kernels take a problem with ``p`` coefficients."""
    return 1 <= p <= MAX_P


def launch_plan(p: int, sms: int) -> dict:
    """How one scan call is launched on a card of ``sms`` SMs: the grid (one
    block per SM, no more than one warp per coordinate needs and no more
    than a block has threads: thread b adds block b's sums), the padded
    leading dimension of Minv', the dynamic shared memory of a block (the
    right-hand side as ``ldp`` float64s and z, y, adj_z, adj_y, X'y), each
    block's columns of ``z_out`` (``col_tiles``) and the scratch the blocks
    exchange z_new and y_new (``exchange_floats`` each: two buffers of p)
    and their partial sums through (two buffers of ``6 x grid``).  The
    lambdas are one launch whatever their number."""
    ldp = pad4(p)
    warps = GRID_THREADS // 32
    grid = max(1, min(int(sms), GRID_THREADS, -(-p // warps)))
    return dict(
        grid=grid, threads=GRID_THREADS, smem_bytes=4 * (2 * ldp + 5 * p),
        ldp=ldp,
        col_tiles=[row_tile(p, b, grid) for b in range(grid)],
        exchange_floats=2 * p, partial_doubles=2 * grid * _SUMS)


def batch_launch_plan(p: int, k: int, sms: int) -> dict:
    """How one batch call is launched on a card of ``sms`` SMs: the grid
    (one block per SM), Minv''s padded leading dimension, each block's
    coordinates (``p_tiles``: rows of Minv' in the product, and its
    coordinates in the elementwise stages), the lane groups (one launch
    each) and the scratch sizes of the largest."""
    ldp = pad4(p)
    groups = lane_groups(k)
    lanes = max(hi - lo for lo, hi in groups)
    return dict(
        grid=sms, threads=GRID_THREADS, smem_bytes=PRODUCT_SMEM_BYTES,
        ldp=ldp, lane_groups=groups,
        p_tiles=[row_tile(p, b, sms) for b in range(sms)],
        scratch_floats=_BATCH_ROWS * lanes * ldp,
        partial_doubles=sms * lanes * _SUMS)


def _sqrt_dim(p, dtype, device):
    return torch.sqrt(torch.tensor(float(p), dtype=dtype, device=device))


def tall_path_batch_reference(Minv, Xty, ilams, rho, eps_abs, eps_rel,
                              alpha, maxit, *, restart_tol: float = 0.999):
    """Plain PyTorch form of the batched kernel: K lanes of FADMM from a
    cold start, lanes frozen once converged, one host read per
    iteration for the all-done exit.  Products and squared norms
    accumulate in float64 and round once, as in the kernel."""
    p, k = Minv.shape[0], ilams.shape[0]
    dtype, dev = Minv.dtype, Minv.device
    sqrt_p = _sqrt_dim(p, dtype, dev)
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    lam = ilams.to(dtype).reshape(k, 1)
    Minv64 = Minv.to(torch.float64)

    x = torch.zeros((k, p), dtype=dtype, device=dev)
    z, y, adj_z, adj_y = (torch.zeros_like(x) for _ in range(4))
    adj_a = torch.ones((k, 1), dtype=dtype, device=dev)
    adj_c = torch.full((k, 1), 9999.0, dtype=dtype, device=dev)
    done = torch.zeros((k, 1), dtype=torch.bool, device=dev)
    niter = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    for _ in range(int(maxit)):
        if bool(torch.all(done)):
            break
        eps_pri = torch.maximum(rnorm(x), rnorm(z)) * eps_rel + sqrt_p * eps_abs
        eps_dua = rnorm(y) * eps_rel + sqrt_p * eps_abs
        rhs = Xty - adj_y + rho * adj_z
        x_new = matmul64(rhs, Minv64)
        z_new = enet_prox(x_new + adj_y / rho, lam / rho, alpha)
        r_dua = rho * rnorm(z_new - z)
        r = x_new - z_new
        r_pri = rnorm(r)
        y_new = adj_y + rho * r
        now_done = (r_pri < eps_pri) & (r_dua < eps_dua)
        adj_z_new, adj_y_new, adj_a_new, adj_c_new = fadmm_momentum(
            now_done, rho, r_pri, sqsum(z_new - adj_z), z_new, y_new, z, y, adj_z, adj_y, adj_a, adj_c, restart_tol)
        pick = lambda new, old: torch.where(done, old, new)
        x, z, y = pick(x_new, x), pick(z_new, z), pick(y_new, y)
        adj_z, adj_y = pick(adj_z_new, adj_z), pick(adj_y_new, adj_y)
        adj_a, adj_c = pick(adj_a_new, adj_a), pick(adj_c_new, adj_c)
        niter = niter + (~done).to(torch.int32)
        done = done | now_done
    return z, niter.reshape(k)


def tall_path_scan_reference(Minv, Xty, ilams, rho, eps_abs, eps_rel,
                             alpha, maxit, *, restart_tol: float = 0.999):
    """Plain PyTorch form of the scan kernel: one lane warm-started over
    the lambda grid, momentum re-synchronised at each lambda
    (``core.engine.warm_start``), one host read per iteration.  Products
    and squared norms accumulate in float64 and round once, as in the
    kernel."""
    p, k = Minv.shape[0], ilams.shape[0]
    dtype, dev = Minv.dtype, Minv.device
    sqrt_p = _sqrt_dim(p, dtype, dev)
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev)
    Minv64 = Minv.to(torch.float64)

    x = torch.zeros((p,), dtype=dtype, device=dev)
    z, y = torch.zeros_like(x), torch.zeros_like(x)
    z_out = torch.empty((k, p), dtype=dtype, device=dev)
    niters = []
    for kk in range(k):
        lam = ilams[kk].to(dtype)
        adj_z, adj_y = z, y
        adj_a = torch.ones((), dtype=dtype, device=dev)
        adj_c = torch.full((), 9999.0, dtype=dtype, device=dev)
        it = 0
        while it < maxit:
            eps_pri = (torch.maximum(rnorm(x), rnorm(z)) * eps_rel
                       + sqrt_p * eps_abs)
            eps_dua = rnorm(y) * eps_rel + sqrt_p * eps_abs
            rhs = Xty - adj_y + rho * adj_z
            x_new = matmul64(rhs, Minv64)
            z_new = enet_prox(x_new + adj_y / rho, lam / rho, alpha)
            r_dua = rho * rnorm(z_new - z)
            r = x_new - z_new
            r_pri = rnorm(r)
            y_new = adj_y + rho * r
            now_done = (r_pri < eps_pri) & (r_dua < eps_dua)
            adj_z, adj_y, adj_a, adj_c = fadmm_momentum(
                now_done, rho, r_pri, sqsum(z_new - adj_z),
                z_new, y_new, z, y, adj_z, adj_y, adj_a, adj_c, restart_tol)
            x, z, y = x_new, z_new, y_new
            it += 1
            if bool(now_done):
                break
        z_out[kk] = z
        niters.append(it)
    return z_out, torch.tensor(niters, dtype=torch.int32, device=dev)


def _check_inputs(Minv, Xty, ilams):
    p, k = Minv.shape[0], ilams.shape[0]
    dev = Minv.device
    check_cuda_input("Minv", Minv, (p, p), dev)
    check_cuda_input("Xty", Xty, (p,), dev)
    check_cuda_input("ilams", ilams, (k,), dev)
    if not fits(p):
        raise ValueError(f"tall path kernels take 1 <= p <= {MAX_P}, got {p}")
    if k < 1:
        raise ValueError("ilams must hold at least one lambda")
    return p, k, dev


@solve_span("tall_path_batch")
def tall_path_batch(Minv, Xty, ilams, rho, eps_abs, eps_rel, alpha, maxit,
                    *, restart_tol: float = 0.999):
    """All lambdas of the tall path at once (``tall_path_batch_pallas``).

    CUDA tensors launch ``tall_path_batch_kernel``; CPU tensors run
    :func:`tall_path_batch_reference`.  Returns ``(z (k, p), niter (k,))``.
    """
    if Minv.device.type == "cpu":
        return tall_path_batch_reference(Minv, Xty, ilams, rho, eps_abs,
                                         eps_rel, alpha, maxit,
                                         restart_tol=restart_tol)
    p, k, dev = _check_inputs(Minv, Xty, ilams)
    lib = load_library()
    plan = batch_launch_plan(p, k, sm_count(dev))
    # ``rhs Minv`` reads Minv's columns, and Minv is symmetric only up to
    # rounding: the product goes over the rows of a transposed copy,
    # zero-padded so that every row starts on a 16-byte boundary.
    MinvT = padded_rows(Minv.mT)
    z = torch.empty((k, p), dtype=torch.float32, device=dev)
    niter = torch.empty((k,), dtype=torch.int32, device=dev)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in plan["lane_groups"]:
            # The iterates start at 0, and the padding stays 0.
            scratch = torch.zeros((plan["scratch_floats"],),
                                  dtype=torch.float32, device=dev)
            err = lib.admm_tall_path_batch(
                MinvT.data_ptr(), Xty.data_ptr(), ilams[lo:hi].data_ptr(),
                scratch.data_ptr(), partial.data_ptr(), z[lo:hi].data_ptr(),
                niter[lo:hi].data_ptr(), p, plan["ldp"], hi - lo,
                plan["grid"], float(rho), float(eps_abs), float(eps_rel),
                float(alpha), int(maxit), float(restart_tol), stream)
            check(lib, err, "admm_tall_path_batch")
            profile.count("kernel.launches.tall_path_batch")
    return z, niter


@solve_span("tall_path_scan")
def tall_path_scan(Minv, Xty, ilams, rho, eps_abs, eps_rel, alpha, maxit,
                   *, restart_tol: float = 0.999):
    """The warm-started sequential tall path (``tall_path_scan_pallas``).

    CUDA tensors launch ``tall_path_scan_kernel``; CPU tensors run
    :func:`tall_path_scan_reference`.  Returns ``(z (k, p), niter (k,))``.
    """
    if Minv.device.type == "cpu":
        return tall_path_scan_reference(Minv, Xty, ilams, rho, eps_abs,
                                        eps_rel, alpha, maxit,
                                        restart_tol=restart_tol)
    p, k, dev = _check_inputs(Minv, Xty, ilams)
    lib = load_library()
    plan = launch_plan(p, sm_count(dev))
    # ``rhs Minv`` reads Minv's columns, and Minv is symmetric only up to
    # rounding: the kernel's row dot products go over a transposed copy,
    # zero-padded so that every row starts on a 16-byte boundary.
    MinvT = padded_rows(Minv.mT)
    z = torch.empty((k, p), dtype=torch.float32, device=dev)
    niter = torch.empty((k,), dtype=torch.int32, device=dev)
    # Scratch the blocks exchange z_new, y_new and their partial sums
    # through, double-buffered; none needs initialising.
    znew = torch.empty((plan["exchange_floats"],), dtype=torch.float32,
                       device=dev)
    ynew = torch.empty_like(znew)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.admm_tall_path_scan(
            MinvT.data_ptr(), Xty.data_ptr(), ilams.data_ptr(),
            znew.data_ptr(), ynew.data_ptr(), partial.data_ptr(),
            z.data_ptr(), niter.data_ptr(), p, plan["ldp"], k, plan["grid"],
            float(rho), float(eps_abs), float(eps_rel), float(alpha),
            int(maxit), float(restart_tol), stream)
    check(lib, err, "admm_tall_path_scan")
    profile.count("kernel.launches.tall_path_scan")
    return z, niter


__all__ = ["BATCH_SYNCS_PER_ITERATION", "MAX_P", "SCAN_SYNCS_PER_ITERATION",
           "batch_launch_plan", "fits", "launch_plan",
           "tall_path_batch", "tall_path_batch_reference", "tall_path_scan",
           "tall_path_scan_reference"]
