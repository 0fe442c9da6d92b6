"""Smoke run of bhr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the monolithic render kernel (bhr_tpu_torch/csrc/render_mono.cu)
from this checkout with nvcc, holds it against its plain PyTorch version,
drives the main path at 1920x1080x500 through BlackHoleRenderer.render_frame
and OrbitAnimator.render_frames in both math tiers, times kernel and plain
version with CUDA events, and saves a PNG. Each phase prints one line; any
failed check raises, so the script exits non-zero and prints no result.
The line before the last is a JSON record of the kernel; the last line is
{"ok": true, "device": {...}}.

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile

import torch

W, H, STEPS = 1920, 1080, 500
SMALL = (160, 96, 200)
N_FRAMES = 8
REPEATS = 5  # timed runs of N_FRAMES kernel frames; the median is reported
# Bars of the kernel against its plain version. A frame carries no ray
# status, so its black pixels (captured rays, and sky too dark to reach one
# level) stand for the captured mask.
EXACT_SAME_MIN = 0.999  # bit-equal packed words (tests/test_pallas_parity.py:484-491)
FAST_MIN = 0.995  # black masks agree, and every channel is within 1 level
BLACK_FRAC_ATOL = 0.01  # |black fraction of kernel - of plain version|


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def compare(kernel_packed: torch.Tensor, plain_packed: torch.Tensor, fast: bool) -> dict:
    """Hold a kernel frame against its plain version; raise if a bar fails."""
    from bhr_tpu_torch.ops.sampling import unpack_frame

    k = unpack_frame(kernel_packed).int()
    p = unpack_frame(plain_packed).int()
    if not bool((k[..., 3] == 255).all()):
        raise AssertionError("kernel frame has alpha != 255")
    diff = (k[..., :3] - p[..., :3]).abs().amax(-1)
    k_black = (k[..., :3] == 0).all(-1)
    p_black = (p[..., :3] == 0).all(-1)
    stats = {
        "bit_same": (kernel_packed == plain_packed).float().mean().item(),
        "black_agree": (k_black == p_black).float().mean().item(),
        "within_1": (diff <= 1).float().mean().item(),
        "max_abs_err": int(diff.max().item()),
        "black_frac": k_black.float().mean().item(),
        "plain_black_frac": p_black.float().mean().item(),
    }
    if fast:
        ok = stats["black_agree"] >= FAST_MIN and stats["within_1"] >= FAST_MIN
    else:
        ok = stats["bit_same"] >= EXACT_SAME_MIN
    if not ok or abs(stats["black_frac"] - stats["plain_black_frac"]) > BLACK_FRAC_ATOL:
        raise AssertionError(f"kernel disagrees with its plain version: {stats}")
    return stats


def bar(fast: bool) -> str:
    if fast:
        return f"black_agree, within_1 >= {FAST_MIN}"
    return f"bit_same >= {EXACT_SAME_MIN}"


def ptxas_summary(log: str) -> str:
    """'<tier>: <registers and spills>' per kernel from nvcc -Xptxas -v."""
    out, tier = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            tier = "fast" if "ILb1E" in line else "exact" if "ILb0E" in line else line.split()[-3]
        elif tier and ("Used" in line or "spill" in line):
            out.append(f"{tier}: {line.replace('ptxas info    :', '').strip()}")
    return " | ".join(out) or "already built"


def cuda_ms(fn, n_frames: int, repeats: int = 1) -> float:
    """ms per frame of fn() (which renders n_frames) by CUDA events: the
    median over `repeats` runs."""
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n_frames)
    return statistics.median(runs)


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.ops import trace_kernel
    from bhr_tpu_torch.ops.trace_kernel import render_packed, render_packed_reference
    from bhr_tpu_torch.utils import build

    # 2. build
    info = build.build("render_mono")
    phase("build", f"{info.path.name} in {info.seconds:.1f} s; ptxas: {ptxas_summary(info.log)}")
    build.load_render_mono()

    # 3. kernel against its plain version, small
    sw, sh, ss = SMALL
    scene = bt.SceneParams(screen_width=sw, screen_height=sh, max_steps=ss)
    cams = {"default": bt.Camera.default(), "side": bt.Camera.new([15, 5, 0], [0, 0, 0], [0, 1, 0])}
    for cam_name, cam in cams.items():
        for fast in (True, False):
            kf = render_packed(cam, scene, fast_math=fast, device="cuda")
            torch.cuda.synchronize()
            pf = render_packed_reference(cam, scene, fast_math=fast, device="cuda")
            torch.cuda.synchronize()
            s = compare(kf, pf, fast)
            phase("small", f"{sw}x{sh}x{ss} {cam_name} {'fast' if fast else 'exact'} "
                  f"({bar(fast)}): " + json.dumps(s))

    # 4. main path at full size, both tiers
    full_scene = bt.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    records = {}
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda")
        trace_kernel.LAUNCHES = 0
        frame = renderer.render_frame(bt.Camera.default(), full_scene)
        torch.cuda.synchronize()
        launches = trace_kernel.LAUNCHES
        if launches != 1:
            raise AssertionError(f"render_frame launched the kernel {launches} times, not 1")
        if frame.shape != (H, W, 4) or frame.dtype != torch.uint8:
            raise AssertionError(f"frame is {frame.dtype} {tuple(frame.shape)}")
        packed = frame.view(torch.int32).view(H, W)
        plain = render_packed_reference(bt.Camera.default(), full_scene, fast_math=fast,
                                        device="cuda")
        s = compare(packed, plain, fast)
        phase("render_frame", f"{W}x{H}x{STEPS} {tier} ({bar(fast)}): launches={launches} "
              + json.dumps(s))
        records[tier] = {"renderer": renderer, "launches": launches, "stats": s}

    # 5. animation: kernel and plain version, ms/frame by CUDA events, and
    # every animation frame held against its plain version
    for tier, rec in records.items():
        fast = tier == "fast"
        anim = bt.OrbitAnimator(rec["renderer"])
        trace_kernel.LAUNCHES = 0
        frames = anim.render_frames(N_FRAMES, packed=True)  # warm-up
        anim_ms = cuda_ms(lambda: anim.render_frames(N_FRAMES, packed=True), N_FRAMES, REPEATS)
        launches = trace_kernel.LAUNCHES
        if frames.shape != (N_FRAMES, H, W) or launches != (1 + REPEATS) * N_FRAMES:
            raise AssertionError(f"animation gave {tuple(frames.shape)} in {launches} launches")
        cams = [bt.orbit_camera(t) for t in anim.frame_times(N_FRAMES)]
        scratch = torch.empty_like(frames[0])
        plain = []

        def kernel_frames():  # back to back, so host work hides behind the kernel
            for cam in cams:
                render_packed(cam, full_scene, fast_math=fast, device="cuda", out=scratch)

        def plain_frames():
            plain.clear()
            plain.extend(render_packed_reference(cam, full_scene, fast_math=fast, device="cuda")
                         for cam in cams)

        ms = cuda_ms(kernel_frames, N_FRAMES, REPEATS)
        render_packed_reference(cams[0], full_scene, fast_math=fast, device="cuda")  # warm-up
        plain_ms = cuda_ms(plain_frames, N_FRAMES)
        errs = [compare(frames[k], plain[k], fast)["max_abs_err"] for k in range(N_FRAMES)]
        rec.update(launches=rec["launches"] + launches, ms=ms, plain_ms=plain_ms,
                   max_abs_err=max(rec["stats"]["max_abs_err"], *errs))
        phase("animation", f"{N_FRAMES} frames {W}x{H}x{STEPS} {tier}: render_frames "
              f"{anim_ms:.3f} ms/frame, kernel {ms:.3f} ms/launch (medians of {REPEATS}), "
              f"plain {plain_ms:.3f} ms/frame, launches={launches}, frames agree with the "
              f"plain version ({bar(fast)}; max_abs_err {max(errs)}) on {smi}")

    # 6. output
    renderer = records["exact"]["renderer"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.png")
        renderer.save_image(path)
        back = bt.io.image.read_png(path)
    if not (back == renderer.get_image_data()).all():
        raise AssertionError("PNG read back differs from the frame")
    phase("output", f"saved and read back a {back.shape} PNG")

    kernels = [
        {
            "name": f"render_mono<{tier}>",
            "route": "cuda",
            "source": "bhr_tpu_torch/csrc/render_mono.cu",
            "replaces": "bhr_tpu/ops/pallas_trace.py:1280",
            "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
        }
        for tier, rec in records.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
