"""Largest-eigenvalue estimate by power iteration (counterpart of
``admm_tpu/linalg/power_iter.py``).

The reference asks Spectra for one eigenpair of X'X or XX' at 10%
tolerance (reference: src/ADMMLassoTall.h:196-201,
src/ADMMLassoWide.h:202-207).  Fifty power steps and a Rayleigh quotient
are far tighter than that.

The start vector: the JAX package draws it from ``PRNGKey(0)``, which
torch cannot reproduce.  Here it comes from an explicit
``torch.Generator`` (by default a CPU generator seeded 0, so the CPU and
the card start from the same vector), or is passed in as ``v0``.  From a
different start the Rayleigh quotient agrees to about 1e-5 relative after
50 steps; pass the JAX package's vector as ``v0`` to agree to rounding.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def power_iteration(matvec: Callable[[torch.Tensor], torch.Tensor],
                    dim: int, *, iters: int = 50,
                    dtype: torch.dtype = torch.float32,
                    device=None,
                    generator: Optional[torch.Generator] = None,
                    v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Estimate the largest eigenvalue of a symmetric PSD operator."""
    if v0 is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        v0 = torch.randn(dim, generator=generator,
                         dtype=dtype, device=generator.device)
    v = torch.as_tensor(v0, dtype=dtype).to(device)
    if v.shape != (dim,):
        raise ValueError(f"v0 must have shape ({dim},), got {tuple(v.shape)}")
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp(torch.sqrt(torch.sum(w * w)), min=1e-30)
    w = matvec(v)
    # Rayleigh quotient of the (near-)converged vector.
    return torch.dot(v, w) / torch.clamp(torch.dot(v, v), min=1e-30)


def spectral_radius_gram(X: torch.Tensor, *, iters: int = 50,
                         generator: Optional[torch.Generator] = None,
                         v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Largest eigenvalue of X'X (== of XX'), matrix-free, on the smaller
    side (reference: src/ADMMMatOp.h:8-41)."""
    n, p = X.shape
    if n >= p:
        mv = lambda v: X.mT @ (X @ v)
        dim = p
    else:
        mv = lambda v: X @ (X.mT @ v)
        dim = n
    return power_iteration(mv, dim, iters=iters, dtype=X.dtype,
                           device=X.device, generator=generator, v0=v0)


def spectral_radius_sym(S: torch.Tensor, *, iters: int = 50,
                        generator: Optional[torch.Generator] = None,
                        v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Largest eigenvalue of an explicit symmetric PSD matrix S."""
    return power_iteration(lambda v: S @ v, S.shape[0], iters=iters,
                           dtype=S.dtype, device=S.device,
                           generator=generator, v0=v0)
