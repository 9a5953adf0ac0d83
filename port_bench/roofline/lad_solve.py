"""``csrc/lad.cu::lad_solve_kernel``: one LAD solve, counted as the
problem's work so that any route of the projection reads against the
same bound.  An iteration projects onto Range(X), at the cheaper of the
dense hat matrix (a product with H, n x n) and the factored form
X ((X'X)^-1 (X' v)): 2 min(n^2, 2np + p^2) operations.  Bytes: X and y
read once, the terminal state (adj_y, adj_z) and the iteration count
written once.

The target is ``models/lad.py::_lad_fit``, whose arguments hold X (n and
p; an intercept's column, a keyword, is not counted) and whose result
holds the iterations; the kernel's wrapper sees only H.  A call that
takes the engine (float64, another quantile) adds work to no kernel
time, so a cell mixing the two routes would read high."""

TARGET = ("admm_tpu_torch.models.lad", "_lad_fit")
DEVICE_NAME = "lad_solve_kernel"


def iteration_flops(n: int, p: int) -> float:
    return 2.0 * min(n * n, 2 * n * p + p * p)


def record(args, result) -> dict:
    n, p = args[0].shape
    return {"n": int(n), "p": int(p), "niter": result.niter}


def work(rec: dict, lane_iterations: int):
    n, p = rec["n"], rec["p"]
    return (lane_iterations * iteration_flops(n, p),
            4.0 * (n * p + n + 2 * n + 1))
