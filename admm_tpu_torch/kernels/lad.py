"""LAD (median regression) solve kernel: wrapper and plain form.

``lad_solve`` replaces ``admm_tpu/ops/lad_kernel.py::_lad_pallas_kernel``
(``lad_solve_pallas``): one whole FADMM solve, rho fixed, against the
dense hat matrix ``H = Xa (Xa'Xa)^-1 Xa'``.  On a CUDA tensor it launches
the hand-written kernel in ``csrc/lad.cu``; on a CPU tensor it runs
:func:`lad_solve_reference`, a direct translation of the fused loop.
Exact shapes: H (n, n), ys (n,) -> ``(adj_y (n,), adj_z (n,), niter)``,
the terminal extrapolation state, from which the caller recovers the
coefficients (reference: src/ADMMLAD.h:220-225).

H is symmetric, and kernel and plain form alike take the x-update's
product as row dot products, ``H v``, which read H along its contiguous
axis (the JAX kernel writes ``v H``).  The kernel is one cooperative grid,
one block per SM (:func:`launch_plan`): block b owns a contiguous range of
H's rows, which a producer warp streams through a ring of stages in shared
memory with bulk async copies, and every block holds about 5n floats of
state (z, y, ys and the float64 right factor), so it takes
``n <= MAX_N``; the caller checks :func:`fits` before it calls.  Rows whose
length is not a multiple of four floats are padded in a copy this wrapper
makes.  ``||ys||`` reaches the kernel as a device tensor and ``rho`` as a
host number: nothing is read back from the card before the launch.
"""
from __future__ import annotations

import torch

from ..diag import profile
from ._build import check, load_library
from ._common import (check_cuda_input, fadmm_momentum, matmul64, pad4,
                      padded_rows, rnorm, row_tile, sm_count, soft_threshold,
                      solve_span, sqsum)

#: Largest n the kernel takes (the bound of the first kernel, 6n floats in
#: 232448 - 2048 bytes of shared memory, kept): at n = MAX_N the state
#: leaves room for a ring of eight 3.8 KB stages.
MAX_N = (232448 - 2048) // (6 * 4)

#: Threads of a block: eight consumer warps and the producer warp.
THREADS = 288
#: Dynamic shared memory a block may ask for (``admm::kMaxDynamicSmem``).
_SMEM_BYTES = 232448 - 2048
#: Most floats one stage of the ring holds (8 KB), and most stages.  The
#: stages are a multiple of the eight consumer warps: slot s is read by
#: warp s % 8.
_SEG_MAX = 2048
MAX_STAGES = 64
_CONSUMER_WARPS = 8
_SUMS = 6
SYNCS_PER_ITERATION = 1


def fits(n: int) -> bool:
    """Whether the LAD kernel takes a problem with ``n`` observations."""
    return 1 <= n <= MAX_N


def launch_plan(n: int, sms: int) -> dict:
    """How one solve is launched on a card of ``sms`` SMs (mirrored by
    ``csrc/lad.cu``): the grid (one block per SM, no more blocks than rows,
    at most 256: thread b adds block b's sums), H's padded leading
    dimension ``ld``, each block's rows (``row_tiles``), the state of a
    block (v as ``ld`` float64s, the float64 sum of each of its rows'
    segments, z, y, ys and its rows of adj_z, adj_y), the ring in what is
    left: each row cut into ``segments_per_row`` stages of at most ``seg``
    floats (8 KB, fewer where eight stages would not fit otherwise),
    ``stages`` of them, a multiple of eight; and the scratch the
    blocks exchange z_new, y_new (``exchange_floats`` each) and their
    partial sums through, double-buffered."""
    ld = pad4(n)
    grid = max(1, min(int(sms), 256, int(n)))
    rows_max = -(-n // grid)
    nseg = -(-ld // _SEG_MAX)
    while True:
        seg = pad4(-(-ld // nseg))
        state = (8 * ld + 8 * rows_max * -(-ld // seg)
                 + 4 * (3 * pad4(n) + 2 * pad4(rows_max)))
        room = _SMEM_BYTES - state
        stages = min(MAX_STAGES, room // (4 * seg)) if room > 0 else 0
        stages -= stages % _CONSUMER_WARPS
        if stages >= _CONSUMER_WARPS:
            break
        if seg <= 4:
            raise ValueError(f"LAD kernel: no room for a ring at n={n} on "
                             f"{sms} SMs")
        nseg += 1
    return dict(
        grid=grid, threads=THREADS, ld=ld, seg=seg,
        segments_per_row=-(-ld // seg), stages=stages,
        ring_bytes=4 * seg * stages, smem_bytes=state + 4 * seg * stages,
        row_tiles=[row_tile(n, b, grid) for b in range(grid)],
        exchange_floats=2 * n, partial_doubles=2 * _SUMS * grid)


def lad_solve_reference(H, ys, rho, eps_abs, eps_rel, ynorm, maxit, *,
                        restart_tol: float = 0.999):
    """Plain PyTorch form of the kernel: one lane of FADMM from a cold
    start, one host read per iteration.  The product and the squared
    norms accumulate in float64 and round once, as in the kernel."""
    n = H.shape[0]
    dtype, dev = H.dtype, H.device
    sqrt_n = torch.sqrt(torch.tensor(float(n), dtype=dtype, device=dev))
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    ynorm = torch.as_tensor(ynorm, dtype=dtype, device=dev)
    pen = 1.0 / rho
    H64 = H.to(torch.float64)

    x = torch.zeros((n,), dtype=dtype, device=dev)
    z, y, adj_z, adj_y = (torch.zeros_like(x) for _ in range(4))
    adj_a = torch.ones((), dtype=dtype, device=dev)
    adj_c = torch.full((), 9999.0, dtype=dtype, device=dev)
    it = 0
    while it < maxit:
        eps_pri = (torch.maximum(torch.maximum(rnorm(x), rnorm(z)), ynorm)
                   * eps_rel + sqrt_n * eps_abs)
        eps_dua = rnorm(y) * eps_rel + sqrt_n * eps_abs
        x_new = matmul64(ys - adj_y / rho + adj_z, H64.mT)
        d = x_new - ys
        z_new = soft_threshold(d + adj_y / rho, pen)
        r_dua = rho * rnorm(z_new - z)
        r = d - z_new
        r_pri = rnorm(r)
        y_new = adj_y + rho * r
        now_done = (r_pri < eps_pri) & (r_dua < eps_dua)
        adj_z, adj_y, adj_a, adj_c = fadmm_momentum(
            now_done, rho, r_pri, sqsum(z_new - adj_z), z_new, y_new, z, y,
            adj_z, adj_y, adj_a, adj_c, restart_tol)
        x, z, y = x_new, z_new, y_new
        it += 1
        if bool(now_done):
            break
    return adj_y, adj_z, torch.tensor(it, dtype=torch.int32, device=dev)


@solve_span("lad_solve")
def lad_solve(H, ys, rho, eps_abs, eps_rel, ynorm, maxit, *,
              restart_tol: float = 0.999):
    """One LAD FADMM solve against the hat matrix (``lad_solve_pallas``).

    CUDA tensors launch ``lad_solve_kernel``; CPU tensors run
    :func:`lad_solve_reference`.  ``ynorm`` is ``||ys||``, which enters
    the primal tolerance.  Returns ``(adj_y (n,), adj_z (n,), niter)``,
    ``niter`` a 0-d int32 tensor.
    """
    if H.device.type == "cpu":
        return lad_solve_reference(H, ys, rho, eps_abs, eps_rel, ynorm,
                                   maxit, restart_tol=restart_tol)
    n = H.shape[0]
    dev = H.device
    check_cuda_input("H", H, (n, n), dev)
    check_cuda_input("ys", ys, (n,), dev)
    if not fits(n):
        raise ValueError(f"LAD kernel takes 1 <= n <= {MAX_N}, got {n}")
    lib = load_library()
    plan = launch_plan(n, sm_count(dev))
    # Rows on 16-byte boundaries (a copy only when n is not a multiple of
    # four), and ||ys|| on the card whatever form it came in.
    Hp = padded_rows(H)
    if isinstance(ynorm, torch.Tensor):
        yn = ynorm.detach().to(device=dev, dtype=torch.float32).reshape(1)
    else:
        yn = torch.full((1,), float(ynorm), dtype=torch.float32, device=dev)
    adj_y = torch.empty((n,), dtype=torch.float32, device=dev)
    adj_z = torch.empty((n,), dtype=torch.float32, device=dev)
    niter = torch.empty((1,), dtype=torch.int32, device=dev)
    # Scratch the blocks exchange z_new, y_new and their partial sums
    # through, double-buffered on the iteration's parity; none needs
    # initialising.
    znew = torch.empty((plan["exchange_floats"],), dtype=torch.float32,
                       device=dev)
    ynew = torch.empty_like(znew)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.admm_lad_solve(
            Hp.data_ptr(), ys.data_ptr(), yn.data_ptr(), znew.data_ptr(),
            ynew.data_ptr(), partial.data_ptr(), adj_y.data_ptr(),
            adj_z.data_ptr(), niter.data_ptr(), n, plan["ld"], plan["grid"],
            plan["seg"], plan["stages"], float(rho), float(eps_abs),
            float(eps_rel), int(maxit), float(restart_tol), stream)
    check(lib, err, "admm_lad_solve")
    profile.count("kernel.launches.lad_solve")
    return adj_y, adj_z, niter.reshape(())


__all__ = ["MAX_N", "SYNCS_PER_ITERATION", "fits", "lad_solve",
           "lad_solve_reference", "launch_plan"]
