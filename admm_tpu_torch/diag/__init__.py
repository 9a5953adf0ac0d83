"""Diagnostics (counterpart of ``admm_tpu/diag``): per-iteration residual
traces (``diag/trace.py``), checkpoint / resume of path solves
(``diag/checkpoint.py``) and the profiler (``diag/profile.py``).

As in the JAX package, ``diag.trace`` is the residual-trace module; the
profiler's context manager is ``diag.profile.trace``."""
from .trace import Trace, format_trace, traced_solve
from .checkpoint import (checkpointed_constrained_lasso_path,
                         checkpointed_cox_path, checkpointed_dantzig_path,
                         checkpointed_gen_lasso_path, checkpointed_glasso_path,
                         checkpointed_glm_path, checkpointed_group_lasso_path,
                         checkpointed_lasso_path,
                         checkpointed_multinomial_path,
                         checkpointed_multitask_lasso_path,
                         checkpointed_parallel_lasso_path,
                         checkpointed_quantile_lasso_path,
                         checkpointed_relaxed_lasso_path,
                         checkpointed_rpca_path, checkpointed_slope_path,
                         checkpointed_sqrt_lasso_path, checkpointed_svm_path,
                         load_pytree, save_pytree)
from .profile import annotate, device_memory_profile
