"""Time the neural surrogate's kernel of one or more checkouts on the card.

    python3 bhr_tpu_torch/tools/time_neural.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo. The script runs itself once per ROOT in
a process of its own, which imports that checkout's bhr_tpu_torch (and
builds its csrc/neural_mlp.cu), and prints one JSON line per ROOT: nvcc's
-Xptxas -v lines for neural_render_kernel (registers, spills, shared memory
of each instantiation), the card's name and power limit, and for N1 and N2
at both kernel tiers at 1920x1080 (the committed nets; N2 highest on the
fp32-trained Kerr net, spin 0.9, camera [15,5,0]) the frame kernel's ms (the
median of REPEATS runs of 3 launches, by CUDA events), the share of the
bit-equal pixels against the plain version, and the cuBLAS MLP chain's ms
(models/neural.mlp_apply at the tier, on random features); at the highest
tier also the direction planes (N3) and a band of 270 rows (N4) of the
same net; and nvidia-smi's SM clock and power draw, read while 0.6 s of
frames run.

Compare two commits within one call, in the order parent, change, change,
parent.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

W, H, BAND = 1920, 1080, 270
REPEATS = 5
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
# (name, model, asset, tier, spin, side camera)
CASES = (("n1", "schwarzschild", "neural_schwarzschild.npz", "default", 0.0, False),
         ("n2", "kerr", "neural_kerr.npz", "default", 0.9, True),
         ("n1_fp32", "schwarzschild", "neural_schwarzschild.npz", "highest", 0.0, False),
         ("n2_fp32", "kerr", "neural_kerr_default.npz", "highest", 0.9, True))


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


def _clocks_under_load(torch, fn, n: int) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, read while n
    launches of fn, issued beforehand, keep the card busy."""
    for _ in range(n):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return out.strip()


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.models import neural as tn
    from bhr_tpu_torch.models import neural_kerr as tnk
    from bhr_tpu_torch.ops import neural_kernel as nk
    from bhr_tpu_torch.utils import build

    if not torch.cuda.is_available():
        raise SystemExit("time_neural.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    info = build.build("neural_mlp", build.NEURAL_MLP_SOURCES)
    ptxas, tag = [], None
    for line in info.log.splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            tag = line.split("'")[1] if "'" in line else line.split()[-1]
        elif tag and "neural_render_kernel" in tag and ("Used" in line or "spill" in line):
            ptxas.append(f"{tag}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cells = []
    for name, model, asset, tier, spin, side in CASES:
        params = (tnk if model == "kerr" else tn).load_params(tn.ASSETS_DIR / asset)[0].to("cuda")
        cam = bt.Camera.new(*SIDE) if side else bt.Camera.default()
        scene = bt.SceneParams(screen_width=W, screen_height=H, spin=spin)
        out = torch.empty((H, W), dtype=torch.int32, device="cuda")

        def frame():
            nk.neural_render_packed(params, cam, scene, precision=tier, device="cuda", out=out)

        frame()  # warm-up: the build and the weights' operands
        plain = nk.neural_render_packed_reference(params, cam, scene, precision=tier,
                                                  device="cuda")
        feats = torch.randn((W * H, params[0][0].shape[0]), generator=gen, device="cuda")
        tn.mlp_apply(params, feats, precision=tier)  # warm-up
        cell = dict(case=name, tier=tier, hidden=list(params.widths),
                    ms=_ms(torch, frame, 3),
                    bit_same=(out == plain).float().mean().item(),
                    chain_ms=_ms(torch, lambda: tn.mlp_apply(params, feats, precision=tier), 1))
        cell["clocks_under_load"] = _clocks_under_load(torch, frame, int(600 / cell["ms"]) + 1)
        if tier == "highest":
            dirs = nk.neural_trace_dirs(params, cam, scene, precision=tier, device="cuda")
            cell["dirs_ms"] = _ms(torch, lambda: nk.neural_trace_dirs(
                params, cam, scene, precision=tier, device="cuda", out=dirs), 3)
            band = torch.empty((BAND, W), dtype=torch.int32, device="cuda")
            cell["band_ms"] = _ms(torch, lambda: nk.neural_render_packed(
                params, cam, scene, precision=tier, device="cuda", out=band, row0=BAND,
                local_shape=(BAND, W)), 3)
            cell["band_same_as_frame"] = (band == out[BAND:2 * BAND]).float().mean().item()
            cell["band_chain_ms"] = _ms(torch, lambda: tn.mlp_apply(
                params, feats[:W * BAND], precision=tier), 1)
        cells.append(cell)
        del feats, plain
    return dict(root=root, card=smi.strip(), torch=torch.__version__, ptxas=ptxas,
                cells=cells)


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
