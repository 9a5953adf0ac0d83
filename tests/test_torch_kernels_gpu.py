"""The CUDA path kernels against their plain PyTorch forms, on the card.

Needs a CUDA device and ``nvcc``; without a device every test skips.  On
the card, run without the JAX-side ``conftest.py`` (this file imports no
JAX)::

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Shapes are those of the CPU kernel tests (tall n = 200, p = 40, k = 10;
wide n = 60, p = 150, k = 9 with the first lambda above lambda0), and so
are the bars: coefficients within 1e-5, niter within 1 per lane for the
batched kernels, scan niter totals within max(3, 10%).  The kernels and
their plain forms accumulate in float64 and round in the same places, so
in practice they agree to the bit.
"""
import numpy as np
import pytest
import torch

from admm_tpu_torch import kernels
from admm_tpu_torch.data.standardize import standardize
from admm_tpu_torch.kernels import tall_path, wide_path
from admm_tpu_torch.models.lasso import _tall_setup, _wide_setup

torch.set_num_threads(1)

MAXIT = 2000


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _std(X, y, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return standardize(torch.as_tensor(X, **f32), torch.as_tensor(y, **f32),
                       standardize_x=True, intercept=True)[:2]


@pytest.fixture(scope="module")
def tall_args(dev):
    rng = np.random.default_rng(3)
    n, p, k = 200, 40, 10
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.4)
    Xs, ys = _std(X, 1.0 + X @ b + 0.3 * rng.normal(size=n), dev)
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0, lam0 * 1e-3, k),
                         dtype=torch.float32, device=dev)
    Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], -1.0)
    return Minv.contiguous(), Xty.contiguous(), ilams, rho


@pytest.fixture(scope="module")
def wide_args(dev):
    rng = np.random.default_rng(11)
    n, p, k = 60, 150, 9
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:12] = rng.normal(size=12)
    Xs, ys = _std(X, X @ b + 0.2 * rng.normal(size=n), dev)
    lam0 = float(torch.max(torch.abs(Xs.mT @ ys)))
    ilams = torch.tensor(np.geomspace(lam0 * 1.1, lam0 * 1e-2, k),
                         dtype=torch.float32, device=dev)
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams, -1.0, 1.0, False)
    return Xs.contiguous(), ys.contiguous(), ilams, rho.contiguous(), sprad, \
        lambda0


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_batch_kernel_matches_plain(tall_args, alpha):
    args = (*tall_args, 1e-5, 1e-5, alpha, MAXIT)
    before = kernels.launch_counts()["tall_path_batch"]
    z, niter = tall_path.tall_path_batch(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tall_path_batch"] == before + 1
    z_ref, n_ref = tall_path.tall_path_batch_reference(*args)
    assert z.is_cuda and z.shape == z_ref.shape and niter.dtype == torch.int32
    assert float((z - z_ref).abs().max()) <= 1e-5
    assert int((niter - n_ref).abs().max()) <= 1


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_tall_scan_kernel_matches_plain(tall_args, alpha):
    args = (*tall_args, 1e-5, 1e-5, alpha, MAXIT)
    z, niter = tall_path.tall_path_scan(*args)
    torch.cuda.synchronize()
    z_ref, n_ref = tall_path.tall_path_scan_reference(*args)
    assert float((z - z_ref).abs().max()) <= 1e-5
    total = int(n_ref.sum())
    assert abs(int(niter.sum()) - total) <= max(3, int(0.1 * total))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_wide_batch_kernel_matches_plain(wide_args, alpha):
    args = (*wide_args, 1e-5, 1e-5, alpha, MAXIT)
    x, niter = wide_path.wide_path_batch(*args)
    torch.cuda.synchronize()
    x_ref, n_ref = wide_path.wide_path_batch_reference(*args)
    assert float((x - x_ref).abs().max()) <= 1e-5
    assert int((niter - n_ref).abs().max()) <= 1
    assert float(x[0].abs().max()) == 0.0


def test_kernels_reject_what_they_do_not_take(tall_args, wide_args):
    Minv, Xty, ilams, rho = tall_args
    rest = (rho, 1e-5, 1e-5, 1.0, 10)
    for fn in (tall_path.tall_path_batch, tall_path.tall_path_scan):
        with pytest.raises(TypeError, match="float32"):
            fn(Minv.double(), Xty.double(), ilams.double(), *rest)
        with pytest.raises(ValueError, match="is on cpu"):
            fn(Minv, Xty.cpu(), ilams, *rest)
        with pytest.raises(ValueError, match="contiguous"):
            fn(Minv.t(), Xty, ilams, *rest)
        with pytest.raises(ValueError, match="shape"):
            fn(Minv, Xty[:-1], ilams, *rest)
    Xs, ys, wl, wr, sprad, lambda0 = wide_args
    tail = (sprad, lambda0, 1e-5, 1e-5, 1.0, 10)
    with pytest.raises(TypeError, match="float32"):
        wide_path.wide_path_batch(Xs, ys.double(), wl, wr, *tail)
    with pytest.raises(ValueError, match="is on cpu"):
        wide_path.wide_path_batch(Xs, ys, wl.cpu(), wr, *tail)
    with pytest.raises(ValueError, match="contiguous"):
        wide_path.wide_path_batch(Xs.t().contiguous().t(), ys, wl, wr, *tail)
