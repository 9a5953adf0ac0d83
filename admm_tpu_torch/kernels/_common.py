"""Plain PyTorch forms of the pieces every path kernel shares.

Counterparts of ``admm_tpu/ops/_common.py``: ``soft_threshold`` and
``enet_prox`` (the ones of ``core/prox.py``) and ``fadmm_momentum``, and
what the GLM kernel adds: the masked elastic-net prox and the gradients
of its two families.  Each is written once more as a ``__device__``
function in ``csrc/admm_common.cuh``.  They serve the kernels' plain forms (the CPU
path and the on-card comparisons) and broadcast over a lane column, so
they work for one lane (scalars + (p,) rows) and for K lanes ((K, 1)
columns + (K, p) blocks) alike.
"""
from __future__ import annotations

import functools

import torch

from ..core.prox import enet_prox, soft_threshold  # noqa: F401  (re-export)
from ..diag import profile


def fadmm_momentum(now_done, rho, r_pri, extra_sq, z_new, y_new, z_old,
                   y_old, adj_z, adj_y, adj_a, adj_c, restart_tol):
    """One FADMM momentum/restart step (reference: src/FADMMBase.h:240-256).

    ``now_done`` is boolean; on the converging iteration the adj_* values
    are held (the reference breaks out of its loop before accelerating).
    Returns ``(adj_z_new, adj_y_new, adj_a_new, adj_c_new)``.
    """
    # A 0-d tensor, not a Python float: on CUDA, division by a host scalar
    # becomes multiplication by its reciprocal, which rounds differently
    # from the kernels' true division.
    restart_tol = torch.as_tensor(restart_tol, dtype=adj_c.dtype,
                                  device=adj_c.device)
    c_new = rho * r_pri * r_pri + rho * extra_sq
    accel = c_new < restart_tol * adj_c
    a_acc = 0.5 + 0.5 * torch.sqrt(1.0 + 4.0 * adj_a * adj_a)
    ratio = (adj_a - 1.0) / a_acc
    adj_z_new = torch.where(
        now_done, adj_z,
        torch.where(accel, (1.0 + ratio) * z_new - ratio * z_old, z_old))
    adj_y_new = torch.where(
        now_done, adj_y,
        torch.where(accel, (1.0 + ratio) * y_new - ratio * y_old, y_old))
    adj_a_new = torch.where(accel, a_acc, torch.ones_like(a_acc))
    adj_a_new = torch.where(now_done, adj_a, adj_a_new)
    adj_c_new = torch.where(accel, c_new, adj_c / restart_tol)
    adj_c_new = torch.where(now_done, adj_c, adj_c_new)
    return adj_z_new, adj_y_new, adj_a_new, adj_c_new


def masked_enet_prox(v, lam_over_rho, mask, alpha):
    """Elastic-net prox with a per-coordinate penalty ``lam/rho * mask``
    (mask 0 on the unpenalized intercept):
    ``soft_threshold(v, alpha pen) / (1 + pen (1 - alpha))``."""
    return enet_prox(v, lam_over_rho * mask, alpha)


def binomial_grad_eta(eta, y):
    """dloss/deta of the logistic loss: ``sigmoid(eta) - y``."""
    return torch.sigmoid(eta) - y


def huber_grad_eta(eta, y, M):
    """dloss/deta of the Huber loss in r = y - eta: ``-clip(r, -M, M)``."""
    return -torch.clamp(y - eta, -M, M)


def sqsum(v):
    """Sum of squares over the last axis (kept for a row block), summed
    in float64 and rounded once, as the kernels sum it."""
    return torch.sum(v * v, dim=-1, keepdim=v.dim() > 1,
                     dtype=torch.float64).to(v.dtype)


def rnorm(v):
    """Euclidean norm over the last axis, from :func:`sqsum`."""
    return torch.sqrt(sqsum(v))


def matmul64(a, b64):
    """``a @ b64`` accumulated in float64 and rounded once to ``a``'s
    dtype, as the kernels' products are; ``b64`` is already float64."""
    return (a.to(torch.float64) @ b64).to(a.dtype)


def check_cuda_input(name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``: what a kernel takes, and nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# The launch plan of the cooperative-grid kernels (GLM, BP, wide batch, tall
# scan): plain Python, mirrored by ``csrc/admm_common.cuh`` (``row_tile``,
# ``kMaxLanes``, ``kGemm*``), so that the CPU tests reach it.
# ---------------------------------------------------------------------------

#: Lanes one launch takes (``admm::kMaxLanes``); more lanes are launched in
#: groups of this many.
LANES_PER_LAUNCH = 128

#: Threads of a block, and the dynamic shared memory the product routine
#: uses: (64 rows + 128 lanes) x 33 double2 (``admm::kGemmSmemBytes``).
GRID_THREADS = 256
PRODUCT_SMEM_BYTES = (64 + LANES_PER_LAUNCH) * (64 // 2 + 1) * 16


def pad4(d: int) -> int:
    """The leading dimension of a row of ``d`` floats: the next multiple
    of four, so that every row starts on a 16-byte boundary."""
    return (int(d) + 3) // 4 * 4


def row_tile(rows: int, b: int, nb: int):
    """Rows ``[lo, hi)`` of ``rows`` that block ``b`` of ``nb`` owns: sizes
    differ by at most one, every row has exactly one owner."""
    return rows * b // nb, rows * (b + 1) // nb


def lane_groups(k: int):
    """``(lo, hi)`` of each launch's lanes."""
    return [(lo, min(lo + LANES_PER_LAUNCH, k))
            for lo in range(0, k, LANES_PER_LAUNCH)]


def padded_rows(M: torch.Tensor) -> torch.Tensor:
    """``M`` with its rows zero-padded to :func:`pad4` floats (``M`` itself,
    made contiguous, when they already are)."""
    rows, cols = M.shape
    ld = pad4(cols)
    if ld == cols:
        return M.contiguous()
    out = torch.zeros((rows, ld), dtype=M.dtype, device=M.device)
    out[:, :cols] = M
    return out


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: the cooperative grid
    is one block on each."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def solve_span(kernel: str):
    """Decorate a kernel's wrapper: each call is a ``solve`` span with
    ``kernel=<kernel>`` (:mod:`admm_tpu_torch.diag.profile`), and the
    iteration counts it returns, its last result, go to the counter
    ``solve.iterations``.  The wrapper counts its own launches, as
    ``kernel.launches.<kernel>``."""
    def wrap(fn):
        @functools.wraps(fn)
        def solve(*args, **kwargs):
            with profile.span("solve", kernel=kernel):
                out = fn(*args, **kwargs)
            profile.count("solve.iterations", out[-1])
            return out
        return solve
    return wrap
