"""The port's meshes across processes: two CPU processes joined by gloo
(``tests/torch_multiproc_worker.py``, which imports no JAX), one mesh
position each.

Consensus W = 4 over D = 2, ``lasso_path(data_mesh=...)`` tall (batch and
scan) and wide, and ``cv_lasso_path(fold_mesh=...)`` with 4 folds: every
rank gets the same result, each equals the single-process port (the
consensus and the CV to the bit; the sharded paths within atol 1e-4 and
niter 3), each rank's solver saw only its own row block, and each rank
solved only its own 2 folds (asserted in the worker).
"""
import os
import socket
import subprocess
import sys

import numpy as np


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_meshes(tmp_path):
    script = os.path.join(os.path.dirname(__file__),
                          "torch_multiproc_worker.py")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), "2", port, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=240)
            logs.append(log.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
        assert "TORCH_MULTIPROC_OK" in log, log
    a, b = (np.load(o) for o in outs)
    assert sorted(a.files) == ["consensus", "cvm", "tall_batch",
                               "tall_scan", "wide"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
