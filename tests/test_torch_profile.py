"""The port's profiler (``admm_tpu_torch.diag.profile``) and its native
host packer (``admm_tpu_torch._native``, built from ``native/admm_host.cpp``
in place), on the CPU.

``trace`` on the CPU writes a non-empty Chrome trace holding the
``annotate`` label; ``device_memory_profile`` needs a CUDA device and
raises on the CPU.  The packer is held to SciPy's CSC to the bit and the
host standardizer to the JAX package's (``tests/test_native.py``), on the
native path where g++ builds it and on the NumPy fallback.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import admm_tpu_torch as t
from admm_tpu import _native as jnative
from admm_tpu.data.standardize import standardize as jstandardize
from admm_tpu_torch import _native
from admm_tpu_torch.api import _sparse_beta
from admm_tpu_torch.diag import annotate, device_memory_profile
from admm_tpu_torch.diag.profile import trace

torch.set_num_threads(1)


def _events(logdir):
    files = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_captures_a_solve(tmp_path):
    X = np.random.default_rng(0).normal(size=(80, 10))
    y = X @ np.ones(10)
    with trace(str(tmp_path / "prof"), device="cpu"):
        with annotate("tiny-path"):
            res = t.lasso_path(X, y, nlambda=3, device="cpu")
            res.coef.numpy()
    names = {e.get("name") for e in _events(str(tmp_path / "prof"))}
    assert "tiny-path" in names
    assert any(n and n.startswith("aten::") for n in names)


def test_trace_refuses_a_perfetto_link(tmp_path):
    with pytest.raises(NotImplementedError, match="perfetto"):
        with trace(str(tmp_path), create_perfetto_link=True, device="cpu"):
            pass


def test_device_memory_profile_needs_a_cuda_device(tmp_path):
    p = str(tmp_path / "mem.pickle")
    with pytest.raises(ValueError, match="CUDA device"):
        device_memory_profile(p, device="cpu")
    assert not os.path.exists(p)


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Each case on the native library and on the NumPy fallback."""
    if request.param == "native":
        if _native.get_lib() is None:
            pytest.skip("no g++ to build native/admm_host.cpp")
    else:
        monkeypatch.setattr(_native, "get_lib", lambda: None)
    return request.param


def test_native_builds_from_the_repository_source():
    lib = _native.get_lib()
    if lib is None:
        pytest.skip("no g++ to build native/admm_host.cpp")
    assert lib.admm_native_version() == _native._EXPECTED_VERSION
    assert _native._SRC == jnative._SRC      # the one source, read in place


def test_pack_beta_csc_matches_scipy(native_mode):
    rng = np.random.default_rng(0)
    nlam, p = 12, 30
    coef = rng.normal(size=(nlam, p)) * (rng.uniform(size=(nlam, p)) < 0.3)
    coef[3] = 0.0                          # an empty path point
    beta0 = rng.normal(size=nlam)
    beta0[5] = 0.0                         # a zero intercept is dropped too
    got = _native.pack_beta_csc(beta0, coef)
    want = sparse.csc_matrix(np.concatenate([beta0[:, None], coef], 1).T)
    assert got.shape == (p + 1, nlam) and got.has_sorted_indices
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_pack_beta_csc_keeps_non_finite_entries(native_mode):
    """A diverged fit's NaN (and inf) coefficients stay in ``beta`` on
    both paths, as SciPy packs them."""
    coef = np.array([[0.0, np.nan, 1.0], [np.inf, 0.0, -2.0]])
    beta0 = np.array([np.nan, 0.5])
    got = _native.pack_beta_csc(beta0, coef)
    want = sparse.csc_matrix(np.concatenate([beta0[:, None], coef], 1).T)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    assert np.isnan(got.data).sum() == 2


def test_pack_beta_csc_single_lambda(native_mode):
    got = _native.pack_beta_csc(np.array([1.5]), np.array([[0.0, 2.0, 0.0]]))
    assert got.shape == (4, 1)
    np.testing.assert_array_equal(got.toarray().ravel(), [1.5, 0, 2.0, 0])


def test_sparse_beta_packs_a_fit_as_the_jax_package(native_mode):
    """The builders' ``beta`` of a float32 path equals the JAX packer's
    on the same numbers."""
    X = np.random.default_rng(5).normal(size=(60, 8))
    res = t.lasso_path(X, X[:, 0] - X[:, 3], nlambda=6, device="cpu")
    got = _sparse_beta(res.beta0, res.coef)
    want = jnative.pack_beta_csc(res.beta0.numpy(), res.coef.numpy())
    assert (got != want).nnz == 0 and got.shape == want.shape


@pytest.mark.parametrize("flag", [0, 1, 2, 3])
def test_standardize_host_matches_jax_standardize(native_mode, flag):
    rng = np.random.default_rng(1)
    X = np.asfortranarray(rng.normal(2.0, 3.0, (50, 7)))
    y = np.ascontiguousarray(1.5 + X @ rng.uniform(size=7)
                             + rng.normal(size=50))
    Xj, yj, st = jstandardize(jnp.asarray(X), jnp.asarray(y),
                              standardize_x=bool(flag & 1),
                              intercept=bool(flag & 2))
    Xh, yh = X.copy(order="F"), y.copy()
    mean_x, scale_x, my, sy = _native.standardize_host(Xh, yh, flag)
    for got, want in ((Xh, Xj), (yh, yj), (mean_x, st.mean_x),
                      (scale_x, st.scale_x), (my, st.mean_y),
                      (sy, st.scale_y)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-10)
