"""The readings that the limits of `correct` are set from, on the card.

    python3 bench_torch/calibrate.py CELL [CELL ...] --seeds 12 --control-seeds 3 --out F

For each cell, in one process: the program's frames, through the same
entry as the window (OrbitAnimator.render_frames(1, start_frame=k,
packed=True)), at the frames a run with each seed compares (its sampled
frames, and one far into the orbit in place of a window's last), held
against the plain reference (the lower readings); the control, the plain
reference computed in the precision below the configuration's put in the
program's place, on the first control-seeds seeds (the upper readings);
and the faults a frame renderer can have, planted in the program's frames
of those seeds: the frame of another camera (a step that leaves its state
unchanged: every frame the window's first), half of the rows left out,
and a band of rows altered by two levels where the frame is produced. One
JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch.harness import build_program, load_cell, numbers, reference_module, seeded  # noqa: E402
from bench_torch.reference.common import orbit_camera  # noqa: E402

FAR = 1000  # frames into the window: the compared frame standing for a window's last


def faults(frame: torch.Tensor, first: torch.Tensor) -> dict:
    """The planted faults of a packed (H, W) frame; `first` is the frame of
    the window's first camera."""
    h = frame.shape[0]
    half = frame.clone()
    half[h // 2:] = 0
    band = frame.clone()
    rows = band[: max(1, h // 16)]
    px = rows.contiguous().view(torch.uint8).view(*rows.shape, 4)
    px[..., :3] = torch.clamp(px[..., :3].to(torch.int16) + 2, 0, 255).to(torch.uint8)
    return {"stale": first, "half_rows": half, "band_altered": band}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=2_000_000_000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    with open(args.out, "a") as fh:
        def emit(rec):
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            print(json.dumps(rec), flush=True)

        for name in args.cells:
            cell = load_cell(name)
            ref = reference_module(cell)
            for i in range(args.seeds):
                seed = args.seed0 + 7919 * i
                s = seeded(cell, seed)
                k0 = s["phase"]
                _, render = build_program(cell, s["star_seed"], device)
                ks = [k0 + j for j in s["sample"]] + [k0 + FAR]
                first = render(k0)[0]
                for k in ks:
                    t0 = time.perf_counter()
                    got = render(k)[0]
                    cam = orbit_camera(k, cell.config["camera"])
                    want, steps = ref.render(cell, cam, seed=s["star_seed"], device=device)
                    t_ref = time.perf_counter() - t0
                    emit({"cell": name, "kind": "program", "seed": seed, "frame": k,
                          "ray_steps": None if steps is None else int(steps.sum()),
                          "ref_s": t_ref, **numbers(got, want)})
                    if i < args.control_seeds:
                        t0 = time.perf_counter()
                        low, _ = ref.render(cell, cam, seed=s["star_seed"], device=device,
                                            control=True)
                        emit({"cell": name, "kind": "control", "seed": seed, "frame": k,
                              "control_s": time.perf_counter() - t0, **numbers(low, want)})
                        for fault, bad in faults(got, first).items():
                            if fault == "stale" and k == k0:
                                continue
                            emit({"cell": name, "kind": fault, "seed": seed, "frame": k,
                                  **numbers(bad, want)})
                    del got, want
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
