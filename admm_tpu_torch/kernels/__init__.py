"""Hand-written CUDA kernels of the solvers, with their plain forms.

Counterpart of ``admm_tpu/ops``: each Pallas TPU kernel that is ported has
a CUDA C++ kernel for Hopper (``csrc/*.cu``, built by :mod:`._build` at
first use) and a wrapper that launches it for CUDA tensors and runs the
plain PyTorch form for CPU tensors.  Importing this package builds nothing.

The seven kernels, by the name their launch count goes under
(:data:`KERNELS`):

* ``tall_path_batch`` (:mod:`.tall_path`): tall Lasso/Enet path, all
  lambdas at once;
* ``tall_path_scan`` (:mod:`.tall_path`): the same, one lane warm-started
  over lambda;
* ``wide_path_batch`` (:mod:`.wide_path`): wide Lasso/Enet path, all
  lambdas at once, per-lane adaptive rho;
* ``wide_path_scan`` (:mod:`.wide_path`): the same, one lane warm-started
  over lambda;
* ``lad_solve`` (:mod:`.lad`): one LAD solve against the hat matrix;
* ``bp_batch_solve`` (:mod:`.bp`): m Basis-Pursuit signals against one A;
* ``glm_batch_path`` (:mod:`.glm`): fixed-majorizer GLM path (binomial,
  huber), all lambdas at once.
"""
from __future__ import annotations

from ..diag import profile
from . import bp, glm, lad, tall_path, wide_path

#: The kernels, by the name their launch count goes under: the counter
#: ``kernel.launches.<name>`` of :mod:`admm_tpu_torch.diag.profile`.
KERNELS = ("tall_path_batch", "tall_path_scan", "wide_path_batch",
           "wide_path_scan", "lad_solve", "bp_batch_solve", "glm_batch_path")


def launch_counts() -> dict:
    """How many times each kernel has been launched in this process."""
    counts = profile.counts("kernel.launches.")
    return {name: counts.get(f"kernel.launches.{name}", 0)
            for name in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    profile.reset_counts("kernel.launches.")


__all__ = ["bp", "glm", "lad", "launch_counts", "reset_launch_counts",
           "tall_path", "wide_path"]
