"""Carry solver state and data statistics between the JAX package and
the port.

The system has no weights: what crosses between ``admm_tpu`` and
``admm_tpu_torch`` is solver state (``ADMMState``), standardization
statistics (``StdStats``) and results (``PathResult``, ``LADResult``,
``BPResult``, ``QuantilePathResult``, ``SVMResult``, ``MTPathResult``,
``MNPathResult``, ``CoxPathResult``, ``GlassoResult``, ``RPCAResult``,
``RPCAPathResult``), the consensus solvers' resume state ``(x, y, z,
rho)`` (a plain tuple in both packages), plus plain
arrays such as a ridge inverse, X'y, rho, sprad or a lambda grid.  The
two packages' types are ``NamedTuple``s with the same names and fields;
numpy arrays are the medium.  This module never imports JAX: the
reference type to convert back into is passed in by the caller.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .core.engine import ADMMState
from .data.standardize import StdStats
from .models.bp import BPResult
from .models.lad import LADResult
from .models.lasso import PathResult

_PORT_TYPES = {cls.__name__: cls for cls in (ADMMState, StdStats, PathResult,
                                             LADResult, BPResult)}
# Fields that hold host metadata, not arrays: carried across unchanged.
_HOST_FIELDS = ("classes",)


def _port_types():
    """The port's types by name; the model modules that import this one
    are added at first use."""
    if "SVMResult" not in _PORT_TYPES:
        from .models.cox import CoxPathResult
        from .models.glasso import GlassoResult
        from .models.multinomial import MNPathResult
        from .models.multitask import MTPathResult
        from .models.quantile import QuantilePathResult
        from .models.rpca import RPCAPathResult, RPCAResult
        from .models.svm import SVMResult

        _PORT_TYPES.update({cls.__name__: cls for cls in (
            QuantilePathResult, SVMResult, MTPathResult, MNPathResult,
            CoxPathResult, GlassoResult, RPCAResult, RPCAPathResult)})
    return _PORT_TYPES


def to_torch(a, *, device=None, dtype: Optional[torch.dtype] = None):
    """Any array (a JAX array, numpy, a scalar) as a tensor; None stays
    None.  The values are copied through numpy, bit for bit unless
    ``dtype`` casts them."""
    if a is None:
        return None
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t) -> Any:
    """A tensor (any device) as a numpy array; None stays None."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _is_consensus_state(obj) -> bool:
    """The consensus solvers' resume state, a plain ``(x, y, z, rho)``."""
    return type(obj) is tuple and len(obj) == 4


def from_reference(obj, *, device=None, dtype: Optional[torch.dtype] = None):
    """A JAX-package ``ADMMState``, ``StdStats`` or result tuple as the
    port's type of the same name, or the consensus state ``(x, y, z,
    rho)`` (a plain tuple) as a tuple of tensors.  ``dtype`` casts
    floating fields only."""
    def conv(field, v):
        if field in _HOST_FIELDS:
            return v
        t = to_torch(v, device=device)
        if t is not None and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    if _is_consensus_state(obj):
        return tuple(conv(None, v) for v in obj)
    name = type(obj).__name__
    types = _port_types()
    if name not in types:
        raise TypeError(f"no port type for {name}")
    cls = types[name]
    if tuple(obj._fields) != tuple(cls._fields):
        raise TypeError(f"{name} fields differ: {obj._fields} vs {cls._fields}")
    return cls(*(conv(f, v) for f, v in zip(obj._fields, obj)))


def to_reference(obj, cls):
    """A port ``ADMMState``, ``StdStats`` or result tuple as ``cls``,
    the JAX package's type of the same name, with numpy fields (which the
    JAX functions accept as arrays); the consensus state ``(x, y, z,
    rho)`` with ``cls=tuple`` as a tuple of numpy arrays."""
    if cls is tuple and _is_consensus_state(obj):
        return tuple(to_numpy(v) for v in obj)
    if type(obj).__name__ != cls.__name__ or tuple(obj._fields) != tuple(
            cls._fields):
        raise TypeError(f"cannot convert {type(obj).__name__} to "
                        f"{cls.__name__}")
    return cls(*(v if f in _HOST_FIELDS else to_numpy(v)
                 for f, v in zip(obj._fields, obj)))


__all__ = ["from_reference", "to_numpy", "to_reference", "to_torch"]
