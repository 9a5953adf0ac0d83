"""Shared pieces of the port's parity tests (``tests/test_torch_*.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture
def jax_start_vector(monkeypatch):
    """Power iteration in the port from the JAX package's start vector
    (``jax.random.normal(PRNGKey(0))``), so ``sprad``, and every step
    that scales with it (the wide regime's 1/sprad whatever rho is, the
    Dantzig step), agrees with the JAX package's to rounding."""
    from admm_tpu_torch.linalg import power_iter

    real = power_iter.power_iteration

    def patched(matvec, dim, *, dtype=torch.float32, v0=None, **kw):
        if v0 is None:
            v0 = torch.as_tensor(np.array(jax.random.normal(
                jax.random.PRNGKey(0), (dim,),
                dtype=jnp.float64 if dtype == torch.float64
                else jnp.float32)))
        return real(matvec, dim, dtype=dtype, v0=v0, **kw)
    monkeypatch.setattr(power_iter, "power_iteration", patched)


def assert_path_close(got, ref, atol, *, fields=("coef", "beta0"),
                      niter=True, grid="lambdas"):
    """A port result against the JAX package's: each of ``fields`` within
    ``atol`` (plus rtol 1e-5 at float32's bar, 1e-7 below it), the grid to
    rtol 1e-6, and ``niter`` within 1 per path point when ``niter``."""
    rtol = 1e-5 if atol >= 1e-5 else 1e-7
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=atol,
                                   rtol=rtol, err_msg=f)
    np.testing.assert_allclose(getattr(got, grid).numpy(),
                               np.asarray(getattr(ref, grid)), rtol=1e-6)
    if niter:
        gap = np.abs(got.niter.numpy().astype(int) - np.asarray(ref.niter))
        assert gap.max() <= 1, f"niter gap {gap.max()}"


def assert_cv_close(got, ref, *, rtol=1e-4):
    """CV curves within ``rtol``; ``lambda_min``/``lambda_1se`` at the same
    grid index (the two packages' grids differ by an ulp)."""
    np.testing.assert_allclose(got.cvm, np.asarray(ref.cvm), rtol=rtol)
    np.testing.assert_allclose(got.cvsd, np.asarray(ref.cvsd), rtol=rtol)
    for key in ("lambda_min", "lambda_1se"):
        i = int(np.argmin(np.abs(got.lambdas - getattr(got, key))))
        j = int(np.argmin(np.abs(np.asarray(ref.lambdas)
                                 - getattr(ref, key))))
        assert i == j, key


def crash_and_resume(driver, tmp_path, *args, fields=("coef", "niter"),
                     refuse=None, **kw):
    """A checkpointed driver stopped after one chunk, then resumed, against
    the same call run uninterrupted: the file exists after the crash and
    is gone after the resume, and each of ``fields`` is equal to the bit.
    ``refuse=(args, kw)``: a call on the crashed run's file with these
    arguments in place of the run's (another problem or option) must be
    refused before the resume.  Returns the uninterrupted result."""
    import os

    ck = str(tmp_path / "crash.npz")
    assert driver(*args, checkpoint=ck, _stop_after_chunks=1, **kw) is None
    assert os.path.exists(ck)
    if refuse is not None:
        with pytest.raises(ValueError, match="different"):
            driver(*refuse[0], checkpoint=ck, **{**kw, **refuse[1]})
    res = driver(*args, checkpoint=ck, **kw)
    assert not os.path.exists(ck)
    full = driver(*args, checkpoint=str(tmp_path / "whole.npz"), **kw)
    for f in fields:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      getattr(full, f).numpy(), err_msg=f)
    return full
