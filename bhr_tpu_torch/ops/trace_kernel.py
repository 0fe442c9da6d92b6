"""The monolithic trace + shade kernel and its plain PyTorch version
(PyTorch port of the monolithic path of bhr_tpu/ops/pallas_trace.py).

`render_packed` is the wrapper of the CUDA kernel csrc/render_mono.cu,
which replaces bhr_tpu's `kernel_monolithic` for Euler on the
Schwarzschild metric, in both math tiers. For a CPU device the wrapper
runs `render_packed_reference`, the plain version; for a CUDA device it
launches the kernel or raises -- it never falls back.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera, generate_rays
from ..core.scene import CAPTURE_FACTOR, SceneParams
from .geodesic import model_capture_radius
from .shading import shade_planes_packed
from .starfield import procedural_background, seed_term
from .trace import TraceConfig, trace_rays

# Kernel launches so far in this process: incremented by `render_packed`
# right after each successful launch of the CUDA kernel, and nowhere else.
LAUNCHES = 0

# params vector layout (fp32[32]), as bhr_tpu/ops/pallas_trace.py:181-201
_P_CAM = 0  # 0:3 camera position
_P_FWD = 3  # 3:6 forward
_P_RIGHT = 6  # 6:9 right
_P_UP = 9  # 9:12 up
_P_BH = 12  # 12:15 black hole position
_P_RS = 15
_P_FOVF = 16  # tan(fov / 2)
_P_SPIN = 17
_P_DT = 18
_P_ESC = 19  # escape radius
_P_CAP = 20  # capture radius
_P_RISCO = 21
_P_ROUTER = 22
_P_WF = 23  # float(width) -- FULL image width (for ray-gen UVs)
_P_HF = 24  # float(height) -- FULL image height
_P_ASPECT = 25
_P_ROW0 = 26  # first global pixel row of this band (0 for a whole frame)
_P_COL0 = 27  # first global pixel column of this band
_P_STRIDE = 28  # pixel stride for subsampled ray-gen
_P_TISCO = 29  # disk inner-edge temperature (bhr_tpu/models/disk.py T_ISCO)
_P_SIZE = 32

_DISK_T_ISCO = 10000.0  # bhr_tpu/models/disk.py T_ISCO, Kelvin


def monolithic_eligible(config: TraceConfig, scene: SceneParams, *, skybox, disk_params,
                        tonemap) -> bool:
    """True when the monolithic kernel can produce this frame: the port's
    slice, semi-implicit Euler on the Schwarzschild metric with the
    analytic star field, passthrough tonemap and no debug view, in either
    math tier."""
    return (
        skybox is None
        and disk_params is None
        and not config.disk
        and not config.adaptive
        and config.integrator == "euler"
        and config.model == "schwarzschild"
        and scene.debug_mode == 0
        and tonemap == "passthrough"
    )


def build_params(camera: Camera, scene: SceneParams, config: TraceConfig, row0=0, col0=0,
                 stride=1) -> torch.Tensor:
    """Pack camera, scene and config into the fp32[32] parameter vector,
    on the host.

    `row0`/`col0` offset the ray-gen for row/column bands of a frame; UVs
    always reference the full image dimensions from `scene`.
    """
    f32 = torch.float32

    def host(x):
        return torch.as_tensor(x, dtype=f32).cpu()

    rs = host(scene.schwarzschild_radius)
    spin = host(scene.spin)
    if config.model == "schwarzschild":
        capture_r = rs * CAPTURE_FACTOR  # wgsl:62 literal
    else:
        capture_r = host(model_capture_radius(config.model, rs, spin))
    w = torch.tensor(float(scene.screen_width), dtype=f32)
    h = torch.tensor(float(scene.screen_height), dtype=f32)
    vals = [
        *host(camera.position), *host(camera.forward), *host(camera.right), *host(camera.up),
        *host(scene.black_hole_position),
        rs,
        torch.tan(host(scene.fov) * 0.5),
        spin,
        host(config.dt),
        host(config.escape_radius),
        capture_r,
        host(config.disk_r_isco_factor) * rs,
        host(config.disk_r_outer_factor) * rs,
        w,
        h,
        w / h,
        host(row0),
        host(col0),
        host(stride),
        host(_DISK_T_ISCO),
    ]
    vals += [host(0.0)] * (_P_SIZE - len(vals))
    return torch.stack([v.reshape(()) for v in vals])


def _check_frame_config(config, scene) -> None:
    if not monolithic_eligible(config, scene, skybox=None, disk_params=None,
                               tonemap="passthrough"):
        raise NotImplementedError(
            f"the monolithic kernel renders Euler/Schwarzschild frames without "
            f"debug view; got {config} with debug_mode={scene.debug_mode} "
            "(ROADMAP queue A, items 6-9)"
        )


def render_packed_reference(camera: Camera, scene: SceneParams,
                            config: TraceConfig = TraceConfig(), *, seed: int = 2020,
                            fast_math: bool = True, device) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: generate_rays,
    trace_rays, then shade_planes_packed with the analytic star field.
    Returns the packed int32 (H, W) frame.

    With `fast_math=True` it computes the fast tier's arithmetic (r^2-space
    termination, the folded Euler update with its clamp, round-half-up
    quantization) in exact operations, so the fast kernel differs from it
    only by its approximate rsqrt and reciprocal.
    """
    _check_frame_config(config, scene)
    device = torch.device(device)
    origins, dirs = generate_rays(
        camera, scene.screen_width, scene.screen_height, scene.fov, device=device
    )
    result = trace_rays(
        origins, dirs, scene.black_hole_position, scene.schwarzschild_radius, scene.spin,
        scene.max_steps, config, fast_math=fast_math,
    )

    def background(dx, dy, dz):
        return procedural_background(dx, dy, dz, seed=seed)

    return shade_planes_packed(result, background, scene.max_steps, half_up=fast_math)


def render_packed(camera: Camera, scene: SceneParams, config: TraceConfig = TraceConfig(),
                  *, seed: int = 2020, fast_math: bool = True, device,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Monolithic path: trace + shade in one kernel -> packed int32 (H, W).

    On a CPU device this is `render_packed_reference`. On a CUDA device it
    launches csrc/render_mono.cu on the current stream, without a host
    sync, and raises when CUDA is not available or the launch fails.
    `out`, if given, is a contiguous int32 (H, W) tensor on `device` that
    receives the frame (the animation path renders into slices of one
    preallocated tensor).
    """
    global LAUNCHES
    _check_frame_config(config, scene)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"render_packed(device={str(device)!r}) needs a CUDA device, and none "
                "is available; pass device='cpu' for the plain PyTorch version"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"render_packed runs on cpu or cuda devices, not {device}")
    shape = (scene.screen_height, scene.screen_width)
    if out is not None and (
        tuple(out.shape) != shape or out.dtype != torch.int32 or out.device != device
        or not out.is_contiguous()
    ):
        raise ValueError(
            f"out must be a contiguous int32 {shape} tensor on {device}; got "
            f"{out.dtype} {tuple(out.shape)} on {out.device}"
        )
    if device.type == "cpu":
        frame = render_packed_reference(
            camera, scene, config, seed=seed, fast_math=fast_math, device=device
        )
        return frame if out is None else out.copy_(frame)
    from ..utils.build import KernelParams, load_render_mono

    lib = load_render_mono()
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=device)
    params = KernelParams()
    params.v[:] = build_params(camera, scene, config).tolist()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.bhr_render_mono(
        params, seed_term(seed), int(bool(fast_math)), shape[0], shape[1],
        int(scene.max_steps), device.index, out.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"render_mono launch failed: CUDA error {rc} "
            f"({lib.bhr_error_string(rc).decode()})"
        )
    LAUNCHES += 1
    return out
