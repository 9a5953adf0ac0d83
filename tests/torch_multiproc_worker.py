"""Worker of ``tests/test_torch_multiprocess.py`` (not a pytest module).

Usage: ``python torch_multiproc_worker.py <rank> <world> <port> <out>``

Joins a gloo process group over ``tcp://127.0.0.1:<port>``, builds the
mesh of one position per rank on the CPU, and runs the consensus Lasso
(W = 4 over the D ranks), ``lasso_path(data_mesh=...)`` tall (batch and
scan) and wide, and ``cv_lasso_path(fold_mesh=...)`` with 4 folds.  It
records what reached this rank (the row blocks of X, the folds it
solved), checks the results against the same calls without a mesh in
this process, and writes the results to ``<out>``; it imports no JAX.
"""
import os
import sys


def main() -> None:
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    import torch.distributed as dist

    import admm_tpu_torch as t
    from admm_tpu_torch.models import lasso
    from admm_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = make_mesh()
    assert (mesh.size, mesh.local, mesh.nproc) == (world, (rank,), world)

    rng = np.random.default_rng(7)
    X = rng.normal(size=(203, 12)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + 0.5 * rng.normal(size=203)).astype(np.float32)
    Xw = rng.normal(size=(48, 80)).astype(np.float32)
    yw = (Xw[:, :3] @ np.ones(3) + 0.1 * rng.normal(size=48)).astype(
        np.float32)
    cpu = dict(device="cpu")

    # What reaches the solvers: this rank's row blocks, its fold solves.
    blocks, folds = [], []
    real_setup, real_user = lasso._tall_setup, lasso._path_user

    def spy_setup(Xs, *a):
        blocks.append([tuple(b.shape) for b in Xs.blocks]
                      if hasattr(Xs, "blocks") else [tuple(Xs.shape)])
        return real_setup(Xs, *a)

    def spy_user(*a, **kw):
        folds.append(1)
        return real_user(*a, **kw)

    lasso._tall_setup = spy_setup
    lasso._path_user = spy_user

    res = {}
    cons = t.parallel_lasso_path(X, y, nworkers=4, mesh=mesh, nlambda=5,
                                 **cpu)
    ref = t.parallel_lasso_path(X, y, nworkers=4, nlambda=5, **cpu)
    assert np.array_equal(cons.coef.numpy(), ref.coef.numpy())
    assert np.array_equal(cons.niter.numpy(), ref.niter.numpy())
    res["consensus"] = cons.coef.numpy()

    for mode in ("batch", "scan"):
        blocks.clear()
        sh = t.lasso_path(X, y, nlambda=5, path_mode=mode, data_mesh=mesh,
                          **cpu)
        assert blocks == [[(len(r), 12) for r in np.array_split(
            np.arange(203), world)][rank:rank + 1]], blocks
        lasso._tall_setup = real_setup
        one = t.lasso_path(X, y, nlambda=5, path_mode=mode, **cpu)
        lasso._tall_setup = spy_setup
        assert np.abs(sh.coef.numpy() - one.coef.numpy()).max() < 1e-4
        assert np.abs(sh.niter.numpy() - one.niter.numpy()).max() <= 3
        res[f"tall_{mode}"] = sh.coef.numpy()
    wide = t.lasso_path(Xw, yw, nlambda=5, path_mode="batch",
                        data_mesh=mesh, **cpu)
    one = t.lasso_path(Xw, yw, nlambda=5, path_mode="batch", **cpu)
    assert np.abs(wide.coef.numpy() - one.coef.numpy()).max() < 1e-4
    res["wide"] = wide.coef.numpy()

    folds.clear()
    cv = t.cv_lasso_path(X, y, nfolds=4, nlambda=5, fold_mesh=mesh, **cpu)
    own = len(folds)
    lasso._path_user = real_user
    one = t.cv_lasso_path(X, y, nfolds=4, nlambda=5, **cpu)
    assert own == 4 // world, own
    assert np.array_equal(cv.cvm, one.cvm)
    res["cvm"] = cv.cvm
    np.savez(out, **res)
    dist.destroy_process_group()
    print("TORCH_MULTIPROC_OK", rank, flush=True)


if __name__ == "__main__":
    main()
