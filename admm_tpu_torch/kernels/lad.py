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
axis (the JAX kernel writes ``v H``).  The kernel splits H's rows over a
cooperative grid; every block holds 6n floats of state in shared memory
(four float32 rows and one float64 row), so it takes ``n <= MAX_N``; the
caller checks :func:`fits` before it calls.
"""
from __future__ import annotations

import torch

from ._build import check, load_library
from ._common import (check_cuda_input, fadmm_momentum, matmul64, rnorm,
                      soft_threshold, sqsum)

#: Largest n whose 6n floats of state fit one block's shared memory
#: (232448 bytes on sm_90, less 2 KB for the reduction scratch).
MAX_N = (232448 - 2048) // (6 * 4)

#: Launch count: the wrapper adds one where it launches the kernel.
solve_launches = 0


def fits(n: int) -> bool:
    """Whether the LAD kernel takes a problem with ``n`` observations."""
    return 1 <= n <= MAX_N


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


def lad_solve(H, ys, rho, eps_abs, eps_rel, ynorm, maxit, *,
              restart_tol: float = 0.999):
    """One LAD FADMM solve against the hat matrix (``lad_solve_pallas``).

    CUDA tensors launch ``lad_solve_kernel``; CPU tensors run
    :func:`lad_solve_reference`.  ``ynorm`` is ``||ys||``, which enters
    the primal tolerance.  Returns ``(adj_y (n,), adj_z (n,), niter)``,
    ``niter`` a 0-d int32 tensor.
    """
    global solve_launches
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
    adj_y = torch.empty((n,), dtype=torch.float32, device=dev)
    adj_z = torch.empty((n,), dtype=torch.float32, device=dev)
    niter = torch.empty((1,), dtype=torch.int32, device=dev)
    # Scratch the blocks exchange z_new, y_new and their partial sums
    # through, double-buffered on the iteration's parity.
    znew = torch.empty((2, n), dtype=torch.float32, device=dev)
    ynew = torch.empty((2, n), dtype=torch.float32, device=dev)
    partial = torch.empty((2, lib.admm_lad_max_grid(), 6),
                          dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.admm_lad_solve(
            H.data_ptr(), ys.data_ptr(), znew.data_ptr(), ynew.data_ptr(),
            partial.data_ptr(), adj_y.data_ptr(), adj_z.data_ptr(),
            niter.data_ptr(), n, float(rho), float(eps_abs), float(eps_rel),
            float(ynorm), int(maxit), float(restart_tol), stream)
    check(lib, err, "admm_lad_solve")
    solve_launches += 1
    return adj_y, adj_z, niter.reshape(())


__all__ = ["MAX_N", "fits", "lad_solve", "lad_solve_reference"]
