"""``csrc/tall_path.cu::tall_path_scan_kernel``: one lane warm-started over
the lambdas.  An iteration is one product with the (p, p) ridge inverse:
2p^2 operations.  Bytes: Minv, X'y and the lambdas read once, the (k, p)
path and k iteration counts written once."""

TARGET = ("admm_tpu_torch.kernels.tall_path", "tall_path_scan")
DEVICE_NAME = "tall_path_scan_kernel"


def record(args, result) -> dict:
    Minv, _, ilams = args[:3]
    return {"p": int(Minv.shape[0]), "k": int(ilams.shape[0]),
            "niter": result[1]}


def work(rec: dict, lane_iterations: int):
    p, k = rec["p"], rec["k"]
    return (lane_iterations * 2.0 * p * p,
            4.0 * (p * p + p + k + k * p + k))
