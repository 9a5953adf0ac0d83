"""Per-iteration convergence tracing (counterpart of
``admm_tpu/diag/trace.py``).

The reference has residual-trace table printers wired into both engines
but commented out of the solve loops (reference: src/ADMMBase.h:111-146,
dead call sites :196,204,213).  Here tracing is first-class:
:func:`traced_solve` runs a fixed number of engine-body steps and records
(eps_primal, resid_primal, eps_dual, resid_dual, rho) for every one of
them, holding the state fixed once it is done; the model drivers'
``trace_len`` option records the same rows inside the early-exiting loop
(``core.engine.make_traced_solve``), and :func:`trace_from_buffer` and
:func:`format_trace` read and print either.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.engine import ADMMState, _keep, _trace_row


class Trace(NamedTuple):
    eps_primal: Any
    resid_primal: Any
    eps_dual: Any
    resid_dual: Any
    rho: Any
    niter: Any


def traced_solve(body_fn, state: ADMMState, num_iters: int):
    """Run ``num_iters`` engine-body steps, recording residuals.

    ``body_fn(state) -> state`` is the single-iteration body of either
    engine (``solve.body`` with the tolerances bound).  Iterations after
    convergence hold the state fixed.  Returns ``(final state, Trace)``
    with (num_iters,) tensors and ``niter`` the final ``it``.
    """
    recs = []
    st = state
    for _ in range(num_iters):
        st = _keep(~st.done, st, body_fn(st))
        recs.append(_trace_row(st))
    rec = torch.stack(recs)
    return st, Trace(eps_primal=rec[:, 0], resid_primal=rec[:, 1],
                     eps_dual=rec[:, 2], resid_dual=rec[:, 3], rho=rec[:, 4],
                     niter=st.it)


def trace_from_buffer(buf, niter=None) -> Trace:
    """A :class:`Trace` from a ``(trace_len, 5)`` buffer of (eps_pri,
    r_pri, eps_dua, r_dua, rho) rows, as the ``trace_len`` option of the
    model drivers returns (a tensor or an array).  Rows past convergence
    are NaN; ``niter`` defaults to the number of recorded rows."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    buf = np.asarray(buf)
    if niter is None:
        niter = int(np.sum(~np.isnan(buf[:, 0])))
    return Trace(eps_primal=buf[:, 0], resid_primal=buf[:, 1],
                 eps_dual=buf[:, 2], resid_dual=buf[:, 3], rho=buf[:, 4],
                 niter=niter)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def format_trace(trace: Trace, title: str = "ADMM iterations") -> str:
    """Render a trace as the reference's debug table
    (reference: src/ADMMBase.h:111-146)."""
    width = 80
    lines = ["=" * width, title.center(width), "-" * width,
             f"{'iter':<7}{'eps_primal':<13}{'resid_primal':<13}"
             f"{'eps_dual':<13}{'resid_dual':<13}{'rho':<13}",
             "-" * width]
    n = int(_np(trace.niter))
    ep, rp = _np(trace.eps_primal), _np(trace.resid_primal)
    ed, rd = _np(trace.eps_dual), _np(trace.resid_dual)
    rho = _np(trace.rho)
    for i in range(min(n, ep.shape[0])):
        lines.append(f"{i:<7}{ep[i]:<13.4g}{rp[i]:<13.4g}"
                     f"{ed[i]:<13.4g}{rd[i]:<13.4g}{rho[i]:<13.4g}")
    lines.append("=" * width)
    return "\n".join(lines)
