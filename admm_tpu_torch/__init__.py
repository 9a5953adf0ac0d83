"""admm_tpu_torch — the PyTorch/CUDA port of ``admm_tpu``.

A second package beside the JAX one, for one NVIDIA H100.  Its first
slice is the Lasso/Elastic-Net lambda path: standardization, the lambda
grid, the tall (n > p) and wide (p >= n) solvers in "scan" and "batch"
path modes, and recovery.  The three Pallas TPU kernels on that path are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use::

    import admm_tpu_torch
    fit = admm_tpu_torch.admm_lasso(x, y).fit()          # on "cuda"
    fit = admm_tpu_torch.admm_lasso(x, y, device="cpu").fit()
    fit.beta          # sparse (p+1) x nlambda, intercepts in row 0

Public names and call signatures are the JAX package's; ``device`` says
where numpy inputs go.
"""
from __future__ import annotations

from .api import ADMMEnet, ADMMLasso, ADMMLassoFit, admm_enet, admm_lasso
from .data.standardize import StdStats
from .models.lasso import (PathResult, adaptive_lasso_path, enet_path,
                           lasso_path)

__version__ = "0.1.0"

__all__ = [
    "admm_lasso", "admm_enet", "ADMMLasso", "ADMMEnet", "ADMMLassoFit",
    "lasso_path", "enet_path", "adaptive_lasso_path", "PathResult",
    "StdStats", "__version__",
]
