"""The command's refusals: no result without a CUDA device, and none from a
process that loaded JAX or the JAX package (bhr_tpu), whose names are
compared whole."""

import subprocess
import sys
from pathlib import Path

from bench_torch import harness

REPO = Path(__file__).resolve().parents[2]


def test_jax_and_the_jax_package_are_found_by_their_whole_names():
    assert harness.jax_loaded({"torch": 0, "bhr_tpu_torch.utils": 0, "bench_torch": 0}) == []
    found = {"jax.numpy": 0, "jaxlib": 0, "flax.linen": 0, "bhr_tpu.ops": 0, "jaxtyping": 0}
    assert harness.jax_loaded(found) == ["bhr_tpu", "flax", "jax", "jaxlib"]


def test_no_result_without_a_cuda_device():
    out = subprocess.run([sys.executable, "bench_torch/run.py", "--workload", "sch1080.orbit_fast",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
