"""Time whole multires frames of one or more checkouts on the card.

    python3 bhr_tpu_torch/tools/time_multires.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo. The script runs itself once per ROOT in
a process of its own, which imports that checkout's bhr_tpu_torch (and
builds its kernels), and prints one JSON line per ROOT: for Euler on the
default camera and BASELINE config 4 (rk4, adaptive dt, the disk, camera
[15,5,0]), both math tiers, the star field and the procedural 2048x4096
texture, and divisors 2 and 3, at 1920x1080x500, the ms of
`render_frame_multires` by CUDA events (the median of REPEATS runs of
FRAMES frames) and the ms the host takes to issue one; with the card's name
and power limit. Where the checkout has `render_multires_band`, it also
times the strided low pass alone over the image's low rows and over those
rows plus the 6 a band of all rows adds (2 above the image, 4 below), the
rows a whole frame traces as that band.

Compare two commits within one call, in the order parent, change, change,
parent.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

W, H, STEPS = 1920, 1080, 500
DIVISORS = (2, 3)
REPEATS, FRAMES = 11, 3
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def _ms(torch, fn, n: int) -> float:
    runs = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def _issue_ms(torch, fn) -> float:
    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(runs)


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.ops import multires
    from bhr_tpu_torch.ops import trace_kernel as tk

    if not torch.cuda.is_available():
        raise SystemExit("time_multires.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    scene = bt.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    tex = bt.load_skybox(None)
    cells = []
    for name, kw, cam in (("euler", {}, bt.Camera.default()),
                          ("config 4", dict(integrator="rk4", adaptive=True, disk=True),
                           bt.Camera.new(*SIDE))):
        for fast in (True, False):
            for sky in (None, tex):
                r = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", skybox=sky, **kw)
                for d in DIVISORS:
                    def frame():
                        r.render_frame_multires(cam, scene, divisor=d)
                    frame()  # warm-up
                    cell = dict(case=name, tier="fast" if fast else "exact",
                                sky="texture" if sky is not None else "stars", divisor=d,
                                frame_ms=_ms(torch, frame, FRAMES),
                                issue_ms=_issue_ms(torch, frame))
                    if hasattr(multires, "render_multires_band"):
                        low = (-(-H // d), -(-W // d))

                        def strided(rows, row0):
                            tk.trace_image(cam, scene, r.config, fast_math=fast, device="cuda",
                                           stride=d, local_shape=(rows, low[1]), row0=row0)
                        cell["low_pass_ms"] = _ms(torch, lambda: strided(low[0], 0), FRAMES)
                        cell["low_pass_band_ms"] = _ms(
                            torch, lambda: strided(low[0] + 6, -2 * d), FRAMES)
                    cells.append(cell)
    return dict(root=root, card=smi.strip(), torch=torch.__version__, cells=cells)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    main()
