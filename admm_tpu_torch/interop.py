"""Carry solver state and data statistics between the JAX package and
the port.

The system has no weights: what crosses between ``admm_tpu`` and
``admm_tpu_torch`` is solver state (``ADMMState``), standardization
statistics (``StdStats``) and results (``PathResult``, ``LADResult``,
``BPResult``), plus plain
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


def from_reference(obj, *, device=None, dtype: Optional[torch.dtype] = None):
    """A JAX-package ``ADMMState``, ``StdStats`` or result tuple as the
    port's type of the same name.  ``dtype`` casts floating fields only."""
    name = type(obj).__name__
    if name not in _PORT_TYPES:
        raise TypeError(f"no port type for {name}")
    cls = _PORT_TYPES[name]
    if tuple(obj._fields) != tuple(cls._fields):
        raise TypeError(f"{name} fields differ: {obj._fields} vs {cls._fields}")

    def conv(v):
        t = to_torch(v, device=device)
        if t is not None and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    return cls(*(conv(v) for v in obj))


def to_reference(obj, cls):
    """A port ``ADMMState``, ``StdStats`` or result tuple as ``cls``,
    the JAX package's type of the same name, with numpy fields (which the
    JAX functions accept as arrays)."""
    if type(obj).__name__ != cls.__name__ or tuple(obj._fields) != tuple(
            cls._fields):
        raise TypeError(f"cannot convert {type(obj).__name__} to "
                        f"{cls.__name__}")
    return cls(*(to_numpy(v) for v in obj))


__all__ = ["from_reference", "to_numpy", "to_reference", "to_torch"]
