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
