"""Fixed-majorizer GLM path kernel (binomial, huber): wrapper and plain form.

``glm_batch_path`` replaces ``admm_tpu/ops/glm_kernel.py::_glm_kernel``
(``glm_batch_path_pallas``): K lambda lanes of plain ADMM on ``b - z = 0``
from a cold start, the x-update ``newton_steps`` majorize-minimize steps
against one shared inverse ``Minv = (bound Xa'Xa/n + rho I)^-1``, the
z-update a masked elastic-net prox (intercept unpenalized).  On a CUDA
tensor it launches the hand-written kernel in ``csrc/glm.cu``; on a CPU
tensor it runs :func:`glm_batch_path_reference`, a direct translation of
the fused loop.  Exact shapes: Xa (n, q) with the ones column, Minv (q, q),
ys (n,), pen_mask (q,), lams (k,) -> ``(z (k, q), niter (k,) int32)``.

Minv is symmetric, and kernel and plain form alike take the step's product
as row dot products, ``Minv grad`` (the JAX kernel writes ``grad Minv``).

The kernel is one cooperative grid, one block per SM: the rows of Xa, of
its transpose and of Minv are split over the blocks and every block works
on all active lanes, so one load of a matrix element serves every lane
(``csrc/admm_common.cuh::lanes_product``).  Lane state (x, z, y, grad:
``4 k ldq`` floats; G: ``k ldn`` floats, ``ld*`` the dimensions padded to a
multiple of four) lives in a zeroed float32 scratch buffer in device memory
and the blocks' partial sums of squares in ``grid k 5`` float64s, which
this wrapper allocates with zero-padded copies of Xa, Xa' and Minv
(:func:`launch_plan`).  The caller checks :func:`fits` before it calls.
"""
from __future__ import annotations

import torch

from ..diag import profile
from ._build import check, load_library
from ._common import (GRID_THREADS, PRODUCT_SMEM_BYTES, binomial_grad_eta,
                      check_cuda_input, huber_grad_eta, lane_groups,
                      masked_enet_prox, matmul64, pad4, padded_rows, rnorm,
                      row_tile, sm_count, solve_span)

#: The dispatch bound of :func:`fits`, in floats: (232448 - 2048) / 4.
_SMEM_FLOATS = (232448 - 2048) // 4

#: Sums of squares a block writes per lane and iteration.
_SUMS = 5

#: The families the kernel serves, by the integer the C entry takes.
FAMILIES = {"binomial": 0, "huber": 1}


def fits(n: int, q: int) -> bool:
    """Whether the path sends an (n, q) design to the GLM kernel:
    ``7q + 2n <= 57600``.  This is the port's dispatch rule and no longer
    a shared-memory size (the first kernel held 7q + 2n floats of lane
    state in one block's shared memory; the present one keeps lane state
    in device memory and uses :data:`PRODUCT_SMEM_BYTES` whatever the
    shape).  Every shape under the bound has been the kernel's since;
    kernel against engine beyond it is not measured yet."""
    return n >= 1 and q >= 1 and 7 * q + 2 * n <= _SMEM_FLOATS


def launch_plan(n: int, q: int, k: int, sms: int) -> dict:
    """How one call is launched on a card of ``sms`` SMs: the grid, the
    padded leading dimensions, each block's rows of Xa (``n_tiles``) and
    of Xa' and Minv (``q_tiles``; also its coordinates in the prox), the
    lane groups (one launch each) and the scratch sizes of the largest."""
    ldq, ldn = pad4(q), pad4(n)
    groups = lane_groups(k)
    lanes = max(hi - lo for lo, hi in groups)
    return dict(
        grid=sms, threads=GRID_THREADS, smem_bytes=PRODUCT_SMEM_BYTES,
        ldq=ldq, ldn=ldn, lane_groups=groups,
        n_tiles=[row_tile(n, b, sms) for b in range(sms)],
        q_tiles=[row_tile(q, b, sms) for b in range(sms)],
        scratch_floats=4 * lanes * ldq + lanes * ldn,
        partial_doubles=sms * lanes * _SUMS)


def syncs_per_iteration(newton_steps: int) -> int:
    """Grid-wide syncs of one iteration: one after each of the three
    products of a Newton step, the last step's merged with the prox, and
    one before the totals."""
    return 3 * int(newton_steps) + 1


def _family_code(family: str) -> int:
    if family not in FAMILIES:
        raise ValueError(f"the GLM kernel serves {sorted(FAMILIES)}, "
                         f"got family={family!r}")
    return FAMILIES[family]


def glm_batch_path_reference(Xa, Minv, ys, pen_mask, lams, rho, eps_abs,
                             eps_rel, alpha, maxit, *, family: str,
                             huber_m: float = 0.0, newton_steps: int = 2):
    """Plain PyTorch form of the GLM kernel: K lanes, frozen once
    converged, one host read per iteration for the all-done exit.
    Products and squared norms accumulate in float64 and round once, as
    in the kernel."""
    _family_code(family)
    n, q = Xa.shape
    k = lams.shape[0]
    dtype, dev = Xa.dtype, Xa.device
    scalar = lambda s: torch.as_tensor(s, dtype=dtype, device=dev)
    # 0-d tensors, not Python floats: see _common.fadmm_momentum.
    rho, alpha, n_t = scalar(rho), scalar(alpha), scalar(float(n))
    sqrt_q = torch.sqrt(scalar(float(q)))
    lam_over_rho = lams.to(dtype).reshape(k, 1) / rho
    Xa64, Minv64 = Xa.to(torch.float64), Minv.to(torch.float64)

    x = torch.zeros((k, q), dtype=dtype, device=dev)
    z, y = torch.zeros_like(x), torch.zeros_like(x)
    done = torch.zeros((k, 1), dtype=torch.bool, device=dev)
    niter = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    for _ in range(int(maxit)):
        if bool(torch.all(done)):
            break
        eps_pri = (torch.maximum(rnorm(x), rnorm(z)) * eps_rel
                   + sqrt_q * eps_abs)
        eps_dua = rnorm(y) * eps_rel + sqrt_q * eps_abs
        v = z - y / rho
        B = x
        for _ in range(int(newton_steps)):
            U = matmul64(B, Xa64.mT)
            G = (binomial_grad_eta(U, ys) if family == "binomial"
                 else huber_grad_eta(U, ys, huber_m))
            grad = matmul64(G, Xa64) / n_t + rho * (B - v)
            B = B - matmul64(grad, Minv64.mT)
        z_new = masked_enet_prox(B + y / rho, lam_over_rho, pen_mask, alpha)
        r_dua = rho * rnorm(z_new - z)
        r = B - z_new
        r_pri = rnorm(r)
        y_new = y + rho * r
        now_done = (r_pri < eps_pri) & (r_dua < eps_dua)

        pick = lambda new, old: torch.where(done, old, new)
        x, z, y = pick(B, x), pick(z_new, z), pick(y_new, y)
        niter = niter + (~done).to(torch.int32)
        done = done | now_done
    return z, niter.reshape(k)


@solve_span("glm_batch_path")
def glm_batch_path(Xa, Minv, ys, pen_mask, lams, rho, eps_abs, eps_rel,
                   alpha, maxit, *, family: str, huber_m: float = 0.0,
                   newton_steps: int = 2):
    """The batched fixed-majorizer GLM path (``glm_batch_path_pallas``).

    CUDA tensors launch ``glm_batch_path_kernel``; CPU tensors run
    :func:`glm_batch_path_reference`.  ``family`` is "binomial" or
    "huber" (``huber_m`` its M).  Returns ``(z (k, q), niter (k,))``.
    """
    if Xa.device.type == "cpu":
        return glm_batch_path_reference(Xa, Minv, ys, pen_mask, lams, rho,
                                        eps_abs, eps_rel, alpha, maxit,
                                        family=family, huber_m=huber_m,
                                        newton_steps=newton_steps)
    n, q = Xa.shape
    k = lams.shape[0]
    dev = Xa.device
    check_cuda_input("Xa", Xa, (n, q), dev)
    check_cuda_input("Minv", Minv, (q, q), dev)
    check_cuda_input("ys", ys, (n,), dev)
    check_cuda_input("pen_mask", pen_mask, (q,), dev)
    check_cuda_input("lams", lams, (k,), dev)
    code = _family_code(family)
    if not fits(n, q):
        raise ValueError(f"GLM kernel takes 7q + 2n <= {_SMEM_FLOATS}, "
                         f"got n={n}, q={q}")
    if k < 1:
        raise ValueError("lams must hold at least one lambda")
    if int(newton_steps) < 1:
        raise ValueError("newton_steps must be a positive integer")
    lib = load_library()
    plan = launch_plan(n, q, k, sm_count(dev))
    ldq, ldn = plan["ldq"], plan["ldn"]
    # Zero-padded copies, made once per call: rows of Xa, of its transpose
    # and of Minv all start on 16-byte boundaries.
    Xa_p, XaT_p, Minv_p = padded_rows(Xa), padded_rows(Xa.mT), padded_rows(Minv)
    z = torch.empty((k, q), dtype=torch.float32, device=dev)
    niter = torch.empty((k,), dtype=torch.int32, device=dev)
    partial = torch.empty((plan["partial_doubles"],), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in plan["lane_groups"]:
            # The iterates start at 0, and the padding stays 0.
            scratch = torch.zeros((plan["scratch_floats"],),
                                  dtype=torch.float32, device=dev)
            err = lib.admm_glm_batch_path(
                Xa_p.data_ptr(), XaT_p.data_ptr(), Minv_p.data_ptr(),
                ys.data_ptr(), pen_mask.data_ptr(), lams[lo:hi].data_ptr(),
                scratch.data_ptr(), partial.data_ptr(), z[lo:hi].data_ptr(),
                niter[lo:hi].data_ptr(), n, q, hi - lo, ldq, ldn,
                plan["grid"], float(rho), float(eps_abs), float(eps_rel),
                float(alpha), int(maxit), code, float(huber_m),
                int(newton_steps), stream)
            check(lib, err, "admm_glm_batch_path")
            profile.count("kernel.launches.glm_batch_path")
    return z, niter


__all__ = ["FAMILIES", "fits", "glm_batch_path", "glm_batch_path_reference",
           "launch_plan", "syncs_per_iteration"]
