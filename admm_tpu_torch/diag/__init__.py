"""Diagnostics (counterpart of ``admm_tpu/diag``): per-iteration residual
traces (``diag/trace.py``), checkpoint / resume of path solves
(``diag/checkpoint.py``) and the profiler, with the program's spans and
counters (``diag/profile.py``).

As in the JAX package, ``diag.trace`` is the residual-trace module; the
profiler's context manager is ``diag.profile.trace``.

``diag/profile.py`` imports nothing of the package, so the engines and
kernels can count and mark spans through it; the other two modules
import the models and load when one of their names is first used."""
import importlib

from .profile import annotate, device_memory_profile

_TRACE = ("Trace", "format_trace", "traced_solve")
_CHECKPOINT = (
    "checkpointed_constrained_lasso_path", "checkpointed_cox_path",
    "checkpointed_dantzig_path", "checkpointed_gen_lasso_path",
    "checkpointed_glasso_path", "checkpointed_glm_path",
    "checkpointed_group_lasso_path", "checkpointed_lasso_path",
    "checkpointed_multinomial_path", "checkpointed_multitask_lasso_path",
    "checkpointed_parallel_lasso_path", "checkpointed_quantile_lasso_path",
    "checkpointed_relaxed_lasso_path", "checkpointed_rpca_path",
    "checkpointed_slope_path", "checkpointed_sqrt_lasso_path",
    "checkpointed_svm_path", "load_pytree", "save_pytree")
_MODULE_OF = {**dict.fromkeys(_TRACE, "trace"),
              **dict.fromkeys(_CHECKPOINT, "checkpoint"),
              "trace": "trace", "checkpoint": "checkpoint"}


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{mod}", __name__)
    return module if name == mod else getattr(module, name)


def __dir__():
    return sorted({*globals(), *_MODULE_OF})


__all__ = ["annotate", "device_memory_profile", *_TRACE, *_CHECKPOINT]
