"""Batched Basis-Pursuit solve kernel: wrapper and plain form.

``bp_batch_solve`` replaces ``admm_tpu/ops/bp_kernel.py::_bp_batch_kernel``
(``bp_batch_solve_pallas``): m signals against one A, each lane a whole
FADMM solve with rho fixed, frozen once converged.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/bp.cu``; on a CPU tensor it
runs :func:`bp_batch_solve_reference`, a direct translation of the fused
loop.  Exact shapes: A (n, p), Winv = (AA')^-1 (n, n), AAAB (m, p) with
rows ``A' Winv b_i`` -> ``(z (m, p), niter (m,) int32)``.

The kernel is one cooperative grid, one block per SM: the rows of A, of
Winv' and of A' are split over the blocks and every block works on all
active lanes, so one load of a matrix element serves every signal
(``csrc/admm_common.cuh::lanes_product``).  A single signal (m = 1) is the
same kernel, a matrix-vector product split over the SMs; the TPU kernel's
``m >= 2`` rule is not carried over.  Lane state (z, y, adj_z, adj_y,
z_new, y_new, v, x: ``8 m ldp`` floats; t, u: ``2 m ldn`` floats, ``ld*``
the dimensions padded to a multiple of four) lives in a zeroed float32
scratch buffer in device memory and the blocks' partial sums of squares in
``grid m 6`` float64s, which this wrapper allocates with zero-padded
copies of A, A' and Winv' (:func:`launch_plan`).  The caller checks
:func:`fits` before it calls.
"""
from __future__ import annotations

import torch

from ..diag import profile
from ._build import check, load_library
from ._common import (GRID_THREADS, PRODUCT_SMEM_BYTES, check_cuda_input,
                      fadmm_momentum, lane_groups, matmul64, pad4, padded_rows,
                      rnorm, row_tile, sm_count, soft_threshold, solve_span,
                      sqsum)

#: The dispatch bound of :func:`fits`, in floats: (232448 - 2048) / 4.
_SMEM_FLOATS = (232448 - 2048) // 4

#: Sums of squares a block writes per lane and iteration, and the
#: grid-wide syncs of one iteration (one after each product, one before
#: the totals, the last before the next iteration reads every block's v).
_SUMS = 6
SYNCS_PER_ITERATION = 4


def fits(n: int, p: int) -> bool:
    """Whether the path sends an (n, p) problem to the BP kernel:
    ``8p + 4n <= 57600``.  This is the port's dispatch rule and no longer
    a shared-memory size (the first kernel held 8p + 4n floats of lane
    state in one block's shared memory; the present one keeps lane state
    in device memory and uses :data:`PRODUCT_SMEM_BYTES` whatever the
    shape).  Every shape under the bound has been the kernel's since;
    kernel against engine beyond it is not measured yet."""
    return n >= 1 and p >= 1 and 8 * p + 4 * n <= _SMEM_FLOATS


def launch_plan(n: int, p: int, m: int, sms: int) -> dict:
    """How one call is launched on a card of ``sms`` SMs: the grid, the
    padded leading dimensions, each block's rows of A and Winv
    (``n_tiles``) and of A' (``p_tiles``; also its coordinates in the
    z-update), the lane groups (one launch each) and the scratch sizes of
    the largest."""
    ldp, ldn = pad4(p), pad4(n)
    groups = lane_groups(m)
    lanes = max(hi - lo for lo, hi in groups)
    return dict(
        grid=sms, threads=GRID_THREADS, smem_bytes=PRODUCT_SMEM_BYTES,
        ldp=ldp, ldn=ldn, lane_groups=groups,
        n_tiles=[row_tile(n, b, sms) for b in range(sms)],
        p_tiles=[row_tile(p, b, sms) for b in range(sms)],
        scratch_floats=8 * lanes * ldp + 2 * lanes * ldn,
        partial_doubles=sms * lanes * _SUMS)


def bp_batch_solve_reference(A, Winv, AAAB, rho, eps_abs, eps_rel, maxit, *,
                             restart_tol: float = 0.999):
    """Plain PyTorch form of the kernel: m lanes, frozen once converged,
    one host read per iteration for the all-done exit.  Each of the three
    products and every squared norm accumulates in float64 and rounds
    once, as in the kernel."""
    p = A.shape[1]
    m = AAAB.shape[0]
    dtype, dev = A.dtype, A.device
    sqrt_p = torch.sqrt(torch.tensor(float(p), dtype=dtype, device=dev))
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    pen = 1.0 / rho
    A64 = A.to(torch.float64)
    Winv64 = Winv.to(torch.float64)

    x = torch.zeros((m, p), dtype=dtype, device=dev)
    z, y, adj_z, adj_y = (torch.zeros_like(x) for _ in range(4))
    adj_a = torch.ones((m, 1), dtype=dtype, device=dev)
    adj_c = torch.full((m, 1), 9999.0, dtype=dtype, device=dev)
    done = torch.zeros((m, 1), dtype=torch.bool, device=dev)
    niter = torch.zeros((m, 1), dtype=torch.int32, device=dev)
    for _ in range(int(maxit)):
        if bool(torch.all(done)):
            break
        eps_pri = torch.maximum(rnorm(x), rnorm(z)) * eps_rel + sqrt_p * eps_abs
        eps_dua = rnorm(y) * eps_rel + sqrt_p * eps_abs
        v = adj_z - adj_y / rho
        t = matmul64(v, A64.mT)
        u = matmul64(t, Winv64)
        x_new = v + AAAB - matmul64(u, A64)
        z_new = soft_threshold(x_new + adj_y / rho, pen)
        r_dua = rho * rnorm(z_new - z)
        r = x_new - z_new
        r_pri = rnorm(r)
        y_new = adj_y + rho * r
        now_done = (r_pri < eps_pri) & (r_dua < eps_dua)
        adj_z_new, adj_y_new, adj_a_new, adj_c_new = fadmm_momentum(
            now_done, rho, r_pri, sqsum(z_new - adj_z), z_new, y_new, z, y,
            adj_z, adj_y, adj_a, adj_c, restart_tol)
        pick = lambda new, old: torch.where(done, old, new)
        x, z, y = pick(x_new, x), pick(z_new, z), pick(y_new, y)
        adj_z, adj_y = pick(adj_z_new, adj_z), pick(adj_y_new, adj_y)
        adj_a, adj_c = pick(adj_a_new, adj_a), pick(adj_c_new, adj_c)
        niter = niter + (~done).to(torch.int32)
        done = done | now_done
    return z, niter.reshape(m)


@solve_span("bp_batch_solve")
def bp_batch_solve(A, Winv, AAAB, rho, eps_abs, eps_rel, maxit, *,
                   restart_tol: float = 0.999):
    """m Basis-Pursuit solves against one A (``bp_batch_solve_pallas``).

    CUDA tensors launch ``bp_batch_kernel``; CPU tensors run
    :func:`bp_batch_solve_reference`.  Returns ``(z (m, p), niter (m,))``.
    """
    if A.device.type == "cpu":
        return bp_batch_solve_reference(A, Winv, AAAB, rho, eps_abs, eps_rel,
                                        maxit, restart_tol=restart_tol)
    n, p = A.shape
    m = AAAB.shape[0]
    dev = A.device
    check_cuda_input("A", A, (n, p), dev)
    check_cuda_input("Winv", Winv, (n, n), dev)
    check_cuda_input("AAAB", AAAB, (m, p), dev)
    if not fits(n, p):
        raise ValueError(f"BP kernel takes 8p + 4n <= {_SMEM_FLOATS}, "
                         f"got n={n}, p={p}")
    if m < 1:
        raise ValueError("AAAB must hold at least one signal")
    lib = load_library()
    plan = launch_plan(n, p, m, sm_count(dev))
    ldp, ldn = plan["ldp"], plan["ldn"]
    # Zero-padded copies, made once per call: rows of A, of its transpose
    # and of Winv's transpose all start on 16-byte boundaries.  Winv is
    # symmetric only up to rounding, and ``t Winv`` reads its columns.
    A_p, AT_p = padded_rows(A), padded_rows(A.mT)
    WinvT_p = padded_rows(Winv.mT)
    z = torch.empty((m, p), dtype=torch.float32, device=dev)
    niter = torch.empty((m,), dtype=torch.int32, device=dev)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in plan["lane_groups"]:
            # The iterates start at 0, and the padding stays 0.
            scratch = torch.zeros((plan["scratch_floats"],),
                                  dtype=torch.float32, device=dev)
            err = lib.admm_bp_batch_solve(
                A_p.data_ptr(), AT_p.data_ptr(), WinvT_p.data_ptr(),
                AAAB[lo:hi].data_ptr(), scratch.data_ptr(),
                partial.data_ptr(), z[lo:hi].data_ptr(),
                niter[lo:hi].data_ptr(), n, p, hi - lo, ldp, ldn,
                plan["grid"], float(rho), float(eps_abs), float(eps_rel),
                int(maxit), float(restart_tol), stream)
            check(lib, err, "admm_bp_batch_solve")
            profile.count("kernel.launches.bp_batch_solve")
    return z, niter


__all__ = ["SYNCS_PER_ITERATION", "bp_batch_solve",
           "bp_batch_solve_reference", "fits", "launch_plan"]
