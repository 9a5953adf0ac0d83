"""``csrc/wide_path.cu::wide_path_scan_kernel``: one lane warm-started over
the lambdas, linearized ADMM.  An iteration is two products with the (n,
p) matrix, X'v and X x: 4np operations (``peaks.path_iteration_flops``).
Bytes: X, y and the lambdas read once, the (k, p) path and k iteration
counts written once.

The target is ``models/lasso.py::_solve_path_wide``, the wide scan path
(its arguments hold X and the lambdas, its result the iterations each
lambda took), which every checkout has: where the path runs on the engine
(a checkout before the kernel, float64, factors, boxes, traces) its work
meets no kernel time and the share reads nothing in a cell that never
launches the kernel."""

TARGET = ("admm_tpu_torch.models.lasso", "_solve_path_wide")
DEVICE_NAME = "wide_path_scan_kernel"


def record(args, result) -> dict:
    X, _, ilams = args[:3]
    n, p = X.shape
    return {"n": int(n), "p": int(p), "k": int(ilams.shape[0]),
            "niter": result[1]}


def work(rec: dict, lane_iterations: int):
    n, p, k = rec["n"], rec["p"], rec["k"]
    return (lane_iterations * 4.0 * n * p,
            4.0 * (n * p + n + k + k * p + k))
