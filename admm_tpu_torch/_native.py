"""ctypes loader for the native host routines of ``native/admm_host.cpp``
(counterpart of ``admm_tpu/_native.py``, whose package needs JAX).

The shared library is built from the repository's source, read in place,
with g++ at first use, into ``admm_tpu_torch/_build/``.  Every entry point
has a NumPy/SciPy fallback for a host without a compiler.  This is host
code: the sparse ``beta`` packing of the builders' fits
(:func:`pack_beta_csc`, ``api.py::_sparse_beta``) and a host
standardizer; nothing here touches a device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).resolve().parent.parent / "native" / "admm_host.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_SO = _BUILD_DIR / "libadmm_host.so"
# admm_native_version() of the source this loader binds; a cached .so
# that reports another version is rebuilt, not used.
_EXPECTED_VERSION = 2


def _build() -> Optional[ctypes.CDLL]:
    """Compile into a temporary file and rename it over ``_SO``, so a
    process that loads the library never sees a half-written one.  No
    ``-march=native``: the library stays loadable on any x86-64 host a
    checkout's ``_build/`` is copied to."""
    if not _SRC.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", str(_SRC), "-o",
           tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _load_so()


def _load_so() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    dptr, i64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64
    lib.admm_standardize_cols.argtypes = [dptr, i64, i64, ctypes.c_int,
                                          dptr, dptr]
    lib.admm_standardize_cols.restype = None
    lib.admm_standardize_vec.argtypes = [dptr, i64, ctypes.c_int, dptr, dptr]
    lib.admm_standardize_vec.restype = None
    lib.admm_pack_beta_csc.argtypes = [
        dptr, i64, i64, ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), dptr]
    lib.admm_pack_beta_csc.restype = ctypes.c_int64
    lib.admm_native_version.argtypes = []
    lib.admm_native_version.restype = ctypes.c_int
    if lib.admm_native_version() != _EXPECTED_VERSION:
        return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on the first call; None where it cannot
    be built or loaded (the callers then take their NumPy path)."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            _LIB = (_load_so() if _SO.exists() else None) or _build()
        return _LIB


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def pack_beta_csc(beta0, coef):
    """Intercepts and an (nlambda, p) path as the reference's sparse
    (p+1) x nlambda CSC ``beta`` (intercept in row 0, reference:
    src/Lasso.cpp:22-30), exact zeros left out: the native packer, SciPy
    without it or for a path with a non-finite entry."""
    from scipy import sparse

    beta0 = np.ascontiguousarray(np.atleast_1d(np.asarray(beta0, np.float64)))
    coef = np.ascontiguousarray(np.atleast_2d(np.asarray(coef, np.float64)))
    nlam, p = coef.shape
    if beta0.shape != (nlam,):
        raise ValueError("beta0 must have one entry per row of coef")
    dense = np.ascontiguousarray(
        np.concatenate([beta0[:, None], coef], axis=1))      # (nlam, p+1)
    lib = get_lib()
    # The native packer keeps |v| > 0, which drops a NaN; SciPy keeps it,
    # so a diverged fit stays visibly non-finite in either case.
    if lib is None or not np.isfinite(dense).all():
        return sparse.csc_matrix(dense.T)
    cap = nlam * (p + 1)
    indptr = np.empty(nlam + 1, np.int64)
    indices = np.empty(cap, np.int32)
    data = np.empty(cap, np.float64)
    nnz = lib.admm_pack_beta_csc(
        _dptr(dense), nlam, p + 1, ctypes.c_double(0.0),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _dptr(data))
    return sparse.csc_matrix((data[:nnz], indices[:nnz], indptr),
                             shape=(p + 1, nlam))


def standardize_host(X: np.ndarray, y: np.ndarray, flag: int):
    """Standardize ``X`` and ``y`` in place on the host: ``flag`` bit 1
    centers, bit 0 scales (1/n standard deviations, the relative
    zero-variance guard of ``data/standardize.py``).  The native path
    takes a column-major float64 ``X``; anything else takes NumPy.
    Returns ``(mean_x, scale_x, mean_y, scale_y)``."""
    n, p = X.shape
    lib = get_lib()
    if (lib is not None and X.flags.f_contiguous and X.dtype == np.float64
            and y.flags.c_contiguous and y.dtype == np.float64
            and y.shape == (n,)):
        mean_x = np.empty(p, np.float64)
        scale_x = np.empty(p, np.float64)
        my, sy = ctypes.c_double(), ctypes.c_double()
        lib.admm_standardize_cols(_dptr(X), n, p, flag, _dptr(mean_x),
                                  _dptr(scale_x))
        lib.admm_standardize_vec(_dptr(y), n, flag, ctypes.byref(my),
                                 ctypes.byref(sy))
        return mean_x, scale_x, my.value, sy.value
    center, scale = bool(flag & 2), bool(flag & 1)
    mx = X.mean(0)
    sd = np.sqrt(np.mean((X - mx) ** 2, axis=0))
    floor_x = 8.0 * np.finfo(np.float64).eps * np.abs(mx)
    mean_x = mx if center else np.zeros(p)
    scale_x = np.where(sd > floor_x, sd, 1.0) if scale else np.ones(p)
    X -= mean_x
    X /= scale_x
    my = y.mean() if center else 0.0
    sdy_c = float(np.sqrt(np.mean((y - y.mean()) ** 2)))
    floor_y = 8.0 * np.finfo(np.float64).eps * abs(float(y.mean()))
    sdy = (sdy_c if sdy_c > floor_y else 1.0) if flag else 1.0
    y -= my
    y /= sdy
    return mean_x, scale_x, float(my), sdy
