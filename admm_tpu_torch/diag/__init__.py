"""Diagnostics (counterpart of ``admm_tpu/diag``): per-iteration residual
traces."""
from .trace import Trace, format_trace, traced_solve
