"""Smoke run of bhr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two kernels from this checkout with nvcc, one nvcc per
source started together (bhr_tpu_torch/csrc/render_mono.cu, the
monolithic trace + shade kernel, and csrc/trace_planes.cu, the staged
trace kernel), holds every kernel variant against its plain PyTorch
version on the card, and drives the renderer's paths at 1920x1080x500:
  * the main path, Euler on the Schwarzschild metric through
    BlackHoleRenderer.render_frame and OrbitAnimator.render_frames, both
    math tiers (one render_mono launch per frame);
  * BASELINE config 4 (rk4, adaptive dt, accretion disk, camera [15,5,0]):
    the fast tier one render_mono launch, the exact tier one trace_planes
    launch and the plain PyTorch epilogue, frame by frame and as a 4-frame
    animation with no host sync;
  * the debug step heatmap (one trace_planes launch and the epilogue);
  * a small matrix at 160x96x200: every integrator x {fixed, adaptive dt}
    x {schwarzschild, flat} x tier x {monolithic, srgb-tonemapped staged}.
Each path is driven with the launch counts set to 0 just before it and
read just after. Every frame is held against its plain version on the same
inputs: exact tier packed words bit-equal on >= 99.9% of pixels, fast tier
channels within 1 level on >= 99.5%, and in both tiers the kernel's ray
status agrees with the plain version's on >= 99.5% of pixels and every
ray the plain version captures is black in the kernel's frame on >= 99.5%
of them. Each phase prints one line; any failed check raises, so the
script exits non-zero and prints no result. The line before the last is a
JSON record of every kernel variant; the last line is
{"ok": true, "device": {...}}.

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
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
BASELINE_FRAMES = 4
# Bars of a kernel against its plain version.
EXACT_SAME_MIN = 0.999  # bit-equal packed words (tests/test_pallas_parity.py:484-491)
FAST_MIN = 0.995  # every channel within 1 level
STATUS_MIN = 0.995  # ray status agrees; captured rays are black in the frame
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # scripts/golden_diff.py:128
STATUS_CAPTURED = 2  # bhr_tpu_torch.ops.trace.STATUS_CAPTURED


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def compare(kernel_packed: torch.Tensor, plain_packed: torch.Tensor, fast: bool,
            kernel_status: torch.Tensor, plain_status: torch.Tensor, *,
            heatmap: bool = False) -> dict:
    """Hold a kernel frame against its plain version; raise if a bar fails.

    Capture is held on the ray status: the kernel's status plane (same
    configuration and tier) agrees with the plain version's on >=
    STATUS_MIN of pixels, and the rays the plain version captures are
    black in the kernel's frame on >= STATUS_MIN of them -- except in a
    step heatmap (`heatmap`), which colours every ray by its step count.
    Black pixels that are dark sky count for nothing; `black_frac` is
    printed only.
    """
    k = kernel_packed.contiguous().view(torch.uint8).view(*kernel_packed.shape, 4).int()
    p = plain_packed.contiguous().view(torch.uint8).view(*plain_packed.shape, 4).int()
    if not bool((k[..., 3] == 255).all()):
        raise AssertionError("kernel frame has alpha != 255")
    diff = (k[..., :3] - p[..., :3]).abs().amax(-1)
    k_black = (k[..., :3] == 0).all(-1)
    captured = plain_status == STATUS_CAPTURED
    stats = {
        "bit_same": (kernel_packed == plain_packed).float().mean().item(),
        "within_1": (diff <= 1).float().mean().item(),
        "max_abs_err": int(diff.max().item()),
        "status_agree": (kernel_status == plain_status).float().mean().item(),
        "captured_black": (k_black[captured].float().mean().item()
                           if bool(captured.any()) else 1.0),
        "captured_frac": captured.float().mean().item(),
        "black_frac": k_black.float().mean().item(),
    }
    ok = stats["bit_same"] >= EXACT_SAME_MIN if not fast else stats["within_1"] >= FAST_MIN
    ok = ok and stats["status_agree"] >= STATUS_MIN
    ok = ok and (heatmap or stats["captured_black"] >= STATUS_MIN)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {stats}")
    return stats


def bar(fast: bool) -> str:
    frame = f"within_1 >= {FAST_MIN}" if fast else f"bit_same >= {EXACT_SAME_MIN}"
    return f"{frame}; status_agree, captured_black >= {STATUS_MIN}"


def ptxas_summary(log: str) -> str:
    """'<kernel>: <registers and spills>' per instantiation, from nvcc
    -Xptxas -v (template arguments: tier ILb1 fast / ILb0 exact, then the
    integrator Li0 euler / Li1 rk4 / Li2 leapfrog)."""
    names = {"ILb1ELi0": "fast,euler", "ILb1ELi1": "fast,rk4", "ILb1ELi2": "fast,leapfrog",
             "ILb0ELi0": "exact,euler", "ILb0ELi1": "exact,rk4", "ILb0ELi2": "exact,leapfrog"}
    out, tag = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            tag = next((v for k, v in names.items() if k in line), line.split()[-3])
        elif tag and ("Used" in line or "spill" in line):
            out.append(f"{tag}: {line.replace('ptxas info    :', '').strip()}")
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


class Variants:
    """Per-variant record for the `kernels` line: main-path launches,
    the largest level difference against the plain version, and the
    times at 1920x1080x500."""

    def __init__(self):
        self.rec = {}

    def key(self, kernel: str, fast: bool, integrator: str) -> str:
        return f"{kernel}<{'fast' if fast else 'exact'},{integrator}>"

    def get(self, kernel, fast, integrator) -> dict:
        return self.rec.setdefault(self.key(kernel, fast, integrator),
                                   {"launches": 0, "max_abs_err": 0, "ms": None,
                                    "plain_ms": None, "config": None})

    def launched(self, kernel, fast, integrator, n):
        self.get(kernel, fast, integrator)["launches"] += n

    def err(self, kernel, fast, integrator, e):
        r = self.get(kernel, fast, integrator)
        r["max_abs_err"] = max(r["max_abs_err"], e)


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
    from bhr_tpu_torch.ops import trace_kernel as tk
    from bhr_tpu_torch.renderer import shade_image
    from bhr_tpu_torch.utils import build

    # 2. build: one nvcc per source, started together
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {name: pool.submit(build.build, name, sources) for name, sources in
                (("render_mono", build.RENDER_MONO_SOURCES),
                 ("trace_planes", build.TRACE_PLANES_SOURCES))}
        for name, job in jobs.items():
            info = job.result()
            phase("build", f"{info.path.name} in {info.seconds:.1f} s; ptxas: "
                  f"{ptxas_summary(info.log)}")
    build.load_render_mono()
    build.load_trace_planes()

    var = Variants()
    side = bt.Camera.new(*SIDE)

    def reset():
        tk.LAUNCHES = 0
        tk.TRACE_LAUNCHES = 0

    def plain_staged(cam, scene, config, fast, renderer, tonemap="passthrough"):
        """The staged frame's plain version: plain trace, same epilogue."""
        res = tk.trace_image_reference(cam, scene, config, fast_math=fast, device="cuda")
        frame = shade_image(res, cam, scene, renderer.disk_params(scene), renderer._lut,
                            tonemap=tonemap, seed=renderer.skybox_seed, packed=True)
        return frame, res

    def check_mono(cam, scene, config, fast, frame):
        """A monolithic frame against its plain version, with the kernel's
        status from a comparison launch of the planes kernel."""
        plain_res = tk.trace_image_reference(cam, scene, config, fast_math=fast, device="cuda")
        plain = tk.shade_packed_reference(plain_res, cam, scene, config, fast_math=fast)
        k_status = tk.trace_image(cam, scene, config, fast_math=fast, device="cuda").status
        s = compare(frame, plain, fast, k_status, plain_res.status)
        var.err("render_mono", fast, config.integrator, s["max_abs_err"])
        s["disk_frac"] = (plain_res.status == 3).float().mean().item()
        s["ray_steps"] = int(plain_res.steps.sum().item())
        return s

    # 3. every variant against its plain version, small: the two cameras of
    # the main path, then the matrix of integrators, dt, models, tiers and paths
    sw, sh, ss = SMALL
    scene = bt.SceneParams(screen_width=sw, screen_height=sh, max_steps=ss)
    for cam_name, cam in {"default": bt.Camera.default(), "side": side}.items():
        for fast in (True, False):
            kf = tk.render_packed(cam, scene, fast_math=fast, device="cuda")
            torch.cuda.synchronize()
            s = check_mono(cam, scene, bt.TraceConfig(), fast, kf)
            phase("small", f"{sw}x{sh}x{ss} {cam_name} {'fast' if fast else 'exact'} "
                  f"({bar(fast)}): " + json.dumps(s))
    n_cases, worst = 0, {}
    for integ in ("euler", "rk4", "leapfrog"):
        for adaptive in (False, True):
            for model in ("schwarzschild", "flat"):
                for fast in (True, False):
                    for tonemap in ("passthrough", "srgb"):
                        r = bt.BlackHoleRenderer(sw, sh, integ, model=model, adaptive=adaptive,
                                                 fast_math=fast, tonemap=tonemap, device="cuda")
                        reset()
                        frame = r.render_frame(side, scene)
                        torch.cuda.synchronize()
                        launched = (tk.LAUNCHES, tk.TRACE_LAUNCHES)
                        packed = frame.view(torch.int32).view(sh, sw)
                        if tonemap == "passthrough":
                            if launched != (1, 0):
                                raise AssertionError(f"monolithic frame launched {launched}")
                            var.launched("render_mono", fast, integ, 1)
                            s = check_mono(side, scene, r.config, fast, packed)
                        else:
                            if launched != (0, 1):
                                raise AssertionError(f"staged frame launched {launched}")
                            var.launched("trace_planes", fast, integ, 1)
                            plain, plain_res = plain_staged(side, scene, r.config, fast, r,
                                                            "srgb")
                            k_res = tk.trace_image(side, scene, r.config, fast_math=fast,
                                                   device="cuda")
                            s = compare(packed, plain, fast, k_res.status, plain_res.status)
                            var.err("trace_planes", fast, integ, s["max_abs_err"])
                        n_cases += 1
                        for key in ("bit_same", "within_1", "status_agree", "captured_black"):
                            worst[key] = min(worst.get(key, 1.0), s[key])
                        worst["max_abs_err"] = max(worst.get("max_abs_err", 0),
                                                   s["max_abs_err"])
    phase("matrix", f"{n_cases} cases at {sw}x{sh}x{ss} (3 integrators x fixed/adaptive x "
          f"schwarzschild/flat x fast/exact x monolithic/srgb staged), each 1 launch of its "
          f"kernel and held to its tier's bar; worst over the cases: " + json.dumps(worst))

    # 4. main path at full size, both tiers
    full_scene = bt.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    records = {}
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda")
        reset()
        frame = renderer.render_frame(bt.Camera.default(), full_scene)
        torch.cuda.synchronize()
        launches = (tk.LAUNCHES, tk.TRACE_LAUNCHES)
        if launches != (1, 0):
            raise AssertionError(f"render_frame launched {launches}, not one render_mono")
        var.launched("render_mono", fast, "euler", 1)
        if frame.shape != (H, W, 4) or frame.dtype != torch.uint8:
            raise AssertionError(f"frame is {frame.dtype} {tuple(frame.shape)}")
        s = check_mono(bt.Camera.default(), full_scene, renderer.config, fast,
                       frame.view(torch.int32).view(H, W))
        phase("render_frame", f"{W}x{H}x{STEPS} euler {tier} ({bar(fast)}): launches=1 "
              + json.dumps(s))
        records[tier] = {"renderer": renderer}

    # 5. main-path animation: kernel and plain version, ms/frame by CUDA
    # events, and every animation frame held against its plain version
    for tier, rec in records.items():
        fast = tier == "fast"
        anim = bt.OrbitAnimator(rec["renderer"])
        reset()
        frames = anim.render_frames(N_FRAMES, packed=True)  # warm-up
        anim_ms = cuda_ms(lambda: anim.render_frames(N_FRAMES, packed=True), N_FRAMES, REPEATS)
        launches = tk.LAUNCHES
        if frames.shape != (N_FRAMES, H, W) or launches != (1 + REPEATS) * N_FRAMES \
                or tk.TRACE_LAUNCHES:
            raise AssertionError(f"animation gave {tuple(frames.shape)} in {launches} launches")
        var.launched("render_mono", fast, "euler", launches)
        cams = [bt.orbit_camera(t) for t in anim.frame_times(N_FRAMES)]
        scratch = torch.empty_like(frames[0])

        def kernel_frames():  # back to back, so host work hides behind the kernel
            for cam in cams:
                tk.render_packed(cam, full_scene, fast_math=fast, device="cuda", out=scratch)

        ms = cuda_ms(kernel_frames, N_FRAMES, REPEATS)
        plain_res, plain = [None] * N_FRAMES, [None] * N_FRAMES

        def plain_frames():  # render_packed_reference, keeping the trace for the status
            for k, cam in enumerate(cams):
                plain_res[k] = tk.trace_image_reference(cam, full_scene, fast_math=fast,
                                                        device="cuda")
                plain[k] = tk.shade_packed_reference(plain_res[k], cam, full_scene,
                                                     bt.TraceConfig(), fast_math=fast)

        plain_ms = cuda_ms(plain_frames, N_FRAMES)
        errs = []
        for k, cam in enumerate(cams):
            k_status = tk.trace_image(cam, full_scene, fast_math=fast, device="cuda").status
            errs.append(compare(frames[k], plain[k], fast, k_status,
                                plain_res[k].status)["max_abs_err"])
        var.err("render_mono", fast, "euler", max(errs))
        r = var.get("render_mono", fast, "euler")
        r.update(ms=ms, plain_ms=plain_ms,
                 config="euler, fixed dt, Camera.default() orbit, no disk (the main path)")
        phase("animation", f"{N_FRAMES} frames {W}x{H}x{STEPS} {tier}: render_frames "
              f"{anim_ms:.3f} ms/frame, kernel {ms:.3f} ms/launch (medians of {REPEATS}), "
              f"plain {plain_ms:.3f} ms/frame, launches={launches}, frames agree with "
              f"the plain version ({bar(fast)}; max_abs_err {max(errs)}) on {smi}")

    # 6. (a) BASELINE config 4: rk4, adaptive dt, the disk, camera [15,5,0]
    cfg4 = dict(integrator="rk4", adaptive=True, disk=True)
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        kernel = "render_mono" if fast else "trace_planes"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda", **cfg4)
        reset()
        frame = renderer.render_frame(side, full_scene)
        torch.cuda.synchronize()
        launches = (tk.LAUNCHES, tk.TRACE_LAUNCHES)
        if launches != ((1, 0) if fast else (0, 1)):
            raise AssertionError(f"BASELINE 4 {tier} launched {launches}, not one {kernel}")
        var.launched(kernel, fast, "rk4", 1)
        packed = frame.view(torch.int32).view(H, W)
        if fast:
            s = check_mono(side, full_scene, renderer.config, True, packed)
        else:
            plain, plain_res = plain_staged(side, full_scene, renderer.config, False, renderer)
            k_res = tk.trace_image(side, full_scene, renderer.config, device="cuda")
            s = compare(packed, plain, False, k_res.status, plain_res.status)
            var.err(kernel, False, "rk4", s["max_abs_err"])
            s["disk_frac"] = (plain_res.status == 3).float().mean().item()
            s["ray_steps"] = int(plain_res.steps.sum().item())
            s["epilogue_ms"] = cuda_ms(
                lambda: shade_image(k_res, side, full_scene, renderer.disk_params(full_scene),
                                    renderer._lut, tonemap="passthrough", packed=True),
                1, REPEATS)
        anim = bt.OrbitAnimator(renderer)
        reset()
        anim.render_frames(BASELINE_FRAMES, packed=True)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the loop raises
        anim.render_frames(BASELINE_FRAMES, packed=True)
        torch.cuda.set_sync_debug_mode("default")
        end.record()
        torch.cuda.synchronize()
        anim_ms = start.elapsed_time(end) / BASELINE_FRAMES
        n = tk.LAUNCHES if fast else tk.TRACE_LAUNCHES
        if n != 2 * BASELINE_FRAMES or (tk.TRACE_LAUNCHES if fast else tk.LAUNCHES):
            raise AssertionError(f"BASELINE 4 animation launched {tk.LAUNCHES}, "
                                 f"{tk.TRACE_LAUNCHES}")
        var.launched(kernel, fast, "rk4", n)
        phase("baseline4", f"{W}x{H}x{STEPS} rk4 adaptive disk {tier}: render_frame 1 {kernel} "
              f"launch ({bar(fast)}): {json.dumps(s)}; "
              f"OrbitAnimator {BASELINE_FRAMES} frames {anim_ms:.3f} ms/frame with no host sync "
              f"(CUDA events, sync debug mode 'error') on {smi}")

    # 7. (b) the debug step heatmap, both tiers: the steps plane against the
    # plain version's
    debug_scene = full_scene.replace(debug_mode=1)
    for fast in (True, False):
        tier = "fast" if fast else "exact"
        renderer = bt.BlackHoleRenderer(W, H, fast_math=fast, device="cuda")
        reset()
        frame = renderer.render_frame(bt.Camera.default(), debug_scene)
        torch.cuda.synchronize()
        if (tk.LAUNCHES, tk.TRACE_LAUNCHES) != (0, 1):
            raise AssertionError(f"debug frame launched {tk.LAUNCHES}, {tk.TRACE_LAUNCHES}")
        var.launched("trace_planes", fast, "euler", 1)
        k_res = tk.trace_image(bt.Camera.default(), debug_scene, fast_math=fast, device="cuda")
        plain, plain_res = plain_staged(bt.Camera.default(), debug_scene, renderer.config,
                                        fast, renderer)
        steps_same = (k_res.steps == plain_res.steps).float().mean().item()
        if steps_same < STATUS_MIN:
            raise AssertionError(f"steps plane agrees on {steps_same}")
        s = compare(frame.view(torch.int32).view(H, W), plain, fast, k_res.status,
                    plain_res.status, heatmap=True)
        var.err("trace_planes", fast, "euler", s["max_abs_err"])
        phase("debug", f"{W}x{H}x{STEPS} debug_mode=1 {tier}: 1 trace_planes launch; steps "
              f"plane equal to the plain version's on {steps_same:.6f} (bar {STATUS_MIN}); "
              f"frame ({bar(fast)}, but for captured_black: the heatmap colours every ray): "
              f"{json.dumps(s)}")

    # 8. times of every variant at full size: kernel launches back to back
    # (median of REPEATS runs of 3) beside one run of its plain version
    timing = {
        ("render_mono", "rk4"): (side, dict(integrator="rk4", adaptive=True, disk=True)),
        ("render_mono", "leapfrog"): (side, dict(integrator="leapfrog", adaptive=True,
                                                 disk=True)),
        ("trace_planes", "euler"): (bt.Camera.default(), dict()),
        ("trace_planes", "rk4"): (side, dict(integrator="rk4", adaptive=True, disk=True)),
        ("trace_planes", "leapfrog"): (side, dict(integrator="leapfrog", adaptive=True,
                                                  disk=True)),
    }
    for (kernel, integ), (cam, kw) in timing.items():
        for fast in (True, False):
            if kernel == "render_mono" and not fast:
                kw = {**kw, "disk": False}  # the exact tier's disk is staged
            config = bt.TraceConfig(**kw)
            if kernel == "render_mono":
                out = torch.empty((H, W), dtype=torch.int32, device="cuda")

                def launch():
                    tk.render_packed(cam, full_scene, config, fast_math=fast, device="cuda",
                                     out=out)

                def plain():
                    tk.render_packed_reference(cam, full_scene, config, fast_math=fast,
                                               device="cuda")
            else:
                planes = tk.empty_trace_result(H, W, "cuda")

                def launch():
                    tk.trace_image(cam, full_scene, config, fast_math=fast, device="cuda",
                                   out=planes)

                def plain():
                    tk.trace_image_reference(cam, full_scene, config, fast_math=fast,
                                             device="cuda")
            launch()  # warm-up
            ms = cuda_ms(lambda: [launch() for _ in range(3)], 3, REPEATS)
            plain_ms = cuda_ms(plain, 1)
            r = var.get(kernel, fast, integ)
            r.update(ms=ms, plain_ms=plain_ms,
                     config=f"{integ}, {'adaptive' if config.adaptive else 'fixed'} dt, "
                            f"{'disk' if config.disk else 'no disk'}, "
                            f"camera {cam.position.tolist()}")
            phase("timing", f"{var.key(kernel, fast, integ)} at {W}x{H}x{STEPS} "
                  f"({r['config']}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms on {smi}")

    # 9. output
    renderer = records["exact"]["renderer"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.png")
        renderer.save_image(path)
        back = bt.io.image.read_png(path)
    if not (back == renderer.get_image_data()).all():
        raise AssertionError("PNG read back differs from the frame")
    phase("output", f"saved and read back a {back.shape} PNG")

    replaces = {"render_mono": "bhr_tpu/ops/pallas_trace.py:1280",
                "trace_planes": "bhr_tpu/ops/pallas_trace.py:1151 and :1335"}
    kernels = []
    for key, r in sorted(var.rec.items()):
        name = key.split("<")[0]
        if r["launches"] == 0:
            raise AssertionError(f"{key} was launched no time on the paths driven")
        kernels.append({"name": key, "route": "cuda",
                        "source": f"bhr_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces[name],
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "config": r["config"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
