"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every ``.cu`` file under ``csrc/`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
which is loaded with ``ctypes`` (``--threads 0``: the sources compile
side by side).  A content hash of the sources names the
library, so an edited source is rebuilt and an unchanged one is reused.
No PyTorch headers are involved, which keeps the build to seconds.

There is no fallback: a missing ``nvcc`` or a failed build raises, with
the compiler's output.  ``--use_fast_math`` is deliberately absent: it
swaps ``sqrtf`` and division for approximations, and the Boyd stopping
test compares residuals at 1e-5.  ``-fmad=false`` keeps each elementwise
``a * b + c`` rounded twice, as the plain PyTorch forms round it, so a
kernel and its plain form agree to the bit (explicit ``fma`` calls in the
products are unaffected).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--threads", "0"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

#: What the last build of this process printed (ptxas register and
#: shared-memory use per kernel) and how long it took; None when the
#: library was found already built.
build_log: Optional[str] = None
build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: (name, argtypes).  Each returns cudaGetLastError().
_ENTRIES = {
    "admm_tall_path_batch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _F, _F, _F, _F, _I, _F, _P],
    "admm_tall_path_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _F, _F, _F, _F, _I, _F, _P],
    "admm_wide_path_batch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P],
    "admm_wide_path_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I,
                            _P],
    "admm_lad_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _F, _F, _F, _I, _F, _P],
    "admm_bp_batch_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _F, _F, _F, _I, _F, _P],
    "admm_glm_batch_path": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _F, _I,
                            _P],
    "admm_cuda_error_string": [_I],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME): the CUDA path kernels cannot be built")


def _compile(so: Path) -> None:
    global build_log, build_seconds
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr}{res.stdout}")
    os.replace(tmp, so)   # atomic: concurrent builders never see a half file
    build_seconds = time.perf_counter() - t0
    build_log = res.stderr + res.stdout


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = BUILD_DIR / f"libadmm_path_kernels_{_source_hash()}.so"
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_char_p
                              if name == "admm_cuda_error_string" else _I)
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error at launch."""
    if err != 0:
        msg = lib.admm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
