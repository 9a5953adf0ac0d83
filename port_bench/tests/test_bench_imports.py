"""No JAX: the check compares whole top-level names, and a run's
modules hold none of them."""
import subprocess
import sys

from conftest import ROOT
from port_bench.checks import forbidden_modules


def test_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "admm_tpu", "admm_tpu.models.lasso", "admm_tpu_torch",
            "admm_tpu_torch.models.lasso", "jaxtyping", "flaxen",
            "port_bench.run"]
    assert forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "admm_tpu",
         "admm_tpu.models.lasso"])


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.argv = ['x']; "
            "import port_bench.run, "
            "port_bench.reference.lasso, admm_tpu_torch; "
            "from port_bench.checks import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "lasso_flagship.path", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout == ""
