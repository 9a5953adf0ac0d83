"""Hand-written CUDA kernels of the solvers, with their plain forms.

Counterpart of ``admm_tpu/ops``: each Pallas TPU kernel that is ported has
a CUDA C++ kernel for Hopper (``csrc/*.cu``, built by :mod:`._build` at
first use) and a wrapper that launches it for CUDA tensors and runs the
plain PyTorch form for CPU tensors.  Importing this package builds nothing.

The six kernels, by the name their launch count goes under:

* ``tall_path_batch`` (:mod:`.tall_path`): tall Lasso/Enet path, all
  lambdas at once;
* ``tall_path_scan`` (:mod:`.tall_path`): the same, one lane warm-started
  over lambda;
* ``wide_path_batch`` (:mod:`.wide_path`): wide Lasso/Enet path, all
  lambdas at once, per-lane adaptive rho;
* ``lad_solve`` (:mod:`.lad`): one LAD solve against the hat matrix;
* ``bp_batch_solve`` (:mod:`.bp`): m Basis-Pursuit signals against one A;
* ``glm_batch_path`` (:mod:`.glm`): fixed-majorizer GLM path (binomial,
  huber), all lambdas at once.
"""
from __future__ import annotations

from . import bp, glm, lad, tall_path, wide_path

#: (module, counter name) of every kernel's launch count.
_COUNTERS = {
    "tall_path_batch": (tall_path, "batch_launches"),
    "tall_path_scan": (tall_path, "scan_launches"),
    "wide_path_batch": (wide_path, "batch_launches"),
    "lad_solve": (lad, "solve_launches"),
    "bp_batch_solve": (bp, "batch_launches"),
    "glm_batch_path": (glm, "batch_launches"),
}


def launch_counts() -> dict:
    """How many times each kernel has been launched in this process."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


__all__ = ["bp", "glm", "lad", "launch_counts", "reset_launch_counts",
           "tall_path", "wide_path"]
