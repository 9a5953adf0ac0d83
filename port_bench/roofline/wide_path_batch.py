"""``csrc/wide_path.cu::wide_path_batch_kernel``: every lambda at once,
linearized ADMM.  A lane-iteration is two products with the (n, p)
matrix, X'v and X x: 4np operations.  Bytes: X, y, the lambdas and the
lanes' starting rho read once, the (k, p) path and k iteration counts
written once."""

TARGET = ("admm_tpu_torch.kernels.wide_path", "wide_path_batch")
DEVICE_NAME = "wide_path_batch_kernel"


def record(args, result) -> dict:
    X, _, ilams = args[:3]
    n, p = X.shape
    return {"n": int(n), "p": int(p), "k": int(ilams.shape[0]),
            "niter": result[1]}


def work(rec: dict, lane_iterations: int):
    n, p, k = rec["n"], rec["p"], rec["k"]
    return (lane_iterations * 4.0 * n * p,
            4.0 * (n * p + n + 2 * k + k * p + k))
