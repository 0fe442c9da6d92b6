"""Run one cell of the benchmark of the raytracer's PyTorch and CUDA port.

    python3 bench_torch/run.py --workload sch1080.orbit_fast --seed 7 --seconds 10 --trace 0

From the root of a checkout. Prints one JSON object as the last line of
standard output (`correct`, `attempted`, `failed`, `metrics`, `device`; with
--trace 1 also `breakdown`; `checks` last) and each number compared beside
its limit as the last lines of standard error. Exits 3, printing no
result, without as many CUDA devices as the cell asks for, and 4 where JAX
or the JAX package (bhr_tpu) is loaded in the process once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths (the
    # port builds its own kernels into build/bhr_tpu_torch/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(REPO / "build" / sub)
    sys.path.insert(0, str(REPO))
    import torch

    from bench_torch.harness import jax_loaded, load_cell, run_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = jax_loaded()
    if found:
        print(f"{args.workload}: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
