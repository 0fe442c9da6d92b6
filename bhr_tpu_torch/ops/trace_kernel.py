"""The CUDA kernels' wrappers and their plain PyTorch versions (PyTorch
port of the monolithic and staged paths of bhr_tpu/ops/pallas_trace.py).

* `render_packed` wraps csrc/render_mono.cu, which replaces bhr_tpu's
  `kernel_monolithic` (trace + shade into one packed word per pixel),
  beside its plain version `render_packed_reference`;
* `trace_image` wraps csrc/trace_planes.cu, which replaces
  `kernel_stateless` and the step-counting `kernel` (trace into a
  TraceResult of planes), beside its plain version `trace_image_reference`.

Both kernels cover the euler, rk4 and leapfrog integrators, fixed or
adaptive dt, the Schwarzschild, exact Kerr (Kerr-Schild), Lense-Thirring
Kerr and flat metrics and the accretion disk, in the fast and the exact
math tier, and each takes a band of rows (`row0`, `local_shape`; the mesh
of parallel/mesh.py). `trace_image` also takes K4's strided and masked
ray-gen (`stride`, `col0`; `mask`), which the multires renderer
(ops/multires.py) is built on, and plugin physics (model "custom", K5's
generic body): trace_planes.cu built once per plugin with the plugin's
acceleration recorded into CUDA source (utils/plugin.py). A wrapper runs
its plain version for a CPU device; for a CUDA device it launches the
kernel or raises -- it never falls back.
"""

from __future__ import annotations

import array
import functools

import torch

from ..core.camera import Camera, generate_rays
from ..core.math import dot, sqrt_rn
from ..core.scene import CAPTURE_FACTOR, SceneParams
from ..models.disk import T_ISCO, kernel_lut_np, shade_disk_planes
from ..utils import tracing
from ..utils.plugin import cuda_source
from .geodesic import INTEGRATORS, MODELS, model_capture_radius
from .sampling import pack_rgba8_planes
from .starfield import procedural_background, seed_term
from .trace import (
    STATUS_CAPTURED,
    STATUS_DISK,
    STATUS_ESCAPED,
    TraceConfig,
    TraceResult,
    check_traceable,
    trace_rays,
)

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
_P_TISCO = 29  # disk inner-edge temperature (models/disk.py T_ISCO)
_P_SIZE = 32

# TraceFlags of csrc/trace_ray.cuh
_FLAG_FLAT = 1
_FLAG_ADAPTIVE = 2
_FLAG_DISK = 4
_FLAG_LT = 8  # kerr_lt: the Lense-Thirring drag
_FLAG_KS = 16  # kerr: the Kerr-Schild Hamiltonian loop
# BASELINE config 4's exact frame: rk4 with adaptive dt and the disk
_EXACT_RK4_DISK = _FLAG_ADAPTIVE | _FLAG_DISK
# BASELINE config 5's exact frame: Euler, the Kerr-Schild loop and the disk
_EXACT_KS_DISK = _FLAG_KS | _FLAG_DISK


def monolithic_eligible(config: TraceConfig, scene: SceneParams, *, fast_math: bool, skybox,
                        disk_params, tonemap) -> bool:
    """True when the monolithic kernel can produce this frame
    (bhr_tpu/ops/pallas_trace.py:79-113): the analytic star field,
    passthrough tonemap and no debug view, for every integrator, adaptive
    or not. The disk is shaded in-kernel in the fast tier only; an
    exact-tier disk frame takes the staged path, and so does every exact
    kerr_lt frame (bhr_tpu sends it to its scratch kernel K5); plugin
    physics never goes monolithic."""
    disk_ok = (not config.disk and disk_params is None) or (config.disk and fast_math)
    return (
        skybox is None
        and disk_ok
        and config.integrator in INTEGRATORS
        and config.model in MODELS
        and (fast_math or config.model != "kerr_lt")
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
    elif config.model == "custom":
        capture_r = rs * host(config.custom_capture_factor)  # pallas_trace.py:1684-1685
    elif config.model == "kerr":
        with tracing.span("host.params.ks"):  # 1.05 r_+, a dozen host tensor ops
            capture_r = host(model_capture_radius(config.model, rs, spin))
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
        host(T_ISCO),
    ]
    vals += [host(0.0)] * (_P_SIZE - len(vals))
    return torch.stack([v.reshape(()) for v in vals])


def trace_flags(config: TraceConfig) -> int:
    """The TraceFlags mask of a configuration (csrc/trace_ray.cuh)."""
    return ((_FLAG_FLAT if config.model == "flat" else 0)
            | (_FLAG_ADAPTIVE if config.adaptive else 0)
            | (_FLAG_DISK if config.disk else 0)
            | (_FLAG_LT if config.model == "kerr_lt" else 0)
            | (_FLAG_KS if config.model == "kerr" else 0))


def planes_flags_fixed(integrator: str, flags: int, fast_math: bool) -> bool:
    """Does a trace_planes launch with these arguments run an instantiation
    whose flags are fixed at compile time (csrc/trace_planes.cu `launch`)?
    An Euler launch with no flag set does, in either tier, and so do an
    exact rk4 launch with exactly adaptive dt and the disk and an exact
    Euler launch with exactly the Kerr-Schild loop and the disk (whole,
    strided or masked, a plugin's build too)."""
    return (integrator == "euler" and flags == 0) or not fast_math and (
        (integrator == "rk4" and flags == _EXACT_RK4_DISK)
        or (integrator == "euler" and flags == _EXACT_KS_DISK))


def _check_mono_config(config: TraceConfig, scene: SceneParams, fast_math: bool) -> None:
    check_traceable(config)
    if not monolithic_eligible(config, scene, fast_math=fast_math, skybox=None,
                               disk_params=None, tonemap="passthrough"):
        raise ValueError(
            f"the monolithic kernel renders no debug view and no plugin physics, and shades "
            f"the disk and traces kerr_lt in the fast tier only; got {config} with debug_mode="
            f"{scene.debug_mode}, fast_math={fast_math}: render it through trace_image and the "
            "staged epilogue "
            "(renderer.render_image routes it there)"
        )


def _kernel_device(device, name: str) -> torch.device:
    """The validated device of a wrapper call: cpu, or cuda with an index."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}(device={str(device)!r}) needs a CUDA device, and none is "
                "available; pass device='cpu' for the plain PyTorch version"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda devices, not {device}")
    return device


def _check_out(t: torch.Tensor, shape, dtype, device, what: str) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous {dtype} {tuple(shape)} tensor on {device}; got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({lib.bhr_error_string(rc).decode()})")


# The parameter block less its camera (floats _P_BH and on) by the value of
# what build_params reads for them: a pure function's memo, so any caller may
# share it. A frame's launch reuses it (a new _FramePlan every call would
# hold nothing).
_CONST_BLOCKS: dict = {}
_MAX_CONST_BLOCKS = 64


def _camera_floats(camera: Camera) -> list[float]:
    """The 12 camera floats of the block, position, forward, right and up,
    read from the camera's fp32[3] tensors (on the host: 4 reads)."""
    vals = []
    for x in (camera.position, camera.forward, camera.right, camera.up):
        x = torch.as_tensor(x, dtype=torch.float32).cpu()
        if x.shape != (3,):
            raise ValueError(f"a launch takes a camera of fp32[3] fields, got {tuple(x.shape)}")
        vals += x.tolist()
    return vals


def _const_key(scene: SceneParams, config: TraceConfig, row0, col0, stride) -> tuple:
    """Every value build_params reads beside the camera, the floats by their
    bits (so that -0.0 is not 0.0)."""
    vals = [*torch.as_tensor(scene.black_hole_position, dtype=torch.float32).reshape(-1).tolist(),
            *(float(x) for x in (scene.schwarzschild_radius, scene.fov, scene.spin,
                                 scene.screen_width, scene.screen_height, config.dt,
                                 config.escape_radius, config.custom_capture_factor,
                                 config.disk_r_isco_factor, config.disk_r_outer_factor, row0,
                                 col0, stride))]
    return config.model, array.array("d", vals).tobytes()


def _kernel_params(camera, scene, config, row0=0, col0=0, stride=1):
    """The kernel's parameter block: the camera's 12 floats and the rest,
    computed by build_params once for a scene, config and band and reused
    after (COUNTS "host.params.built" / "host.params.reused"); bit for bit
    build_params(camera, scene, config, row0, col0, stride)."""
    from ..utils.build import KernelParams

    with tracing.span("host.params"):
        key = _const_key(scene, config, row0, col0, stride)
        const = _CONST_BLOCKS.get(key)
        if const is None:
            const = build_params(camera, scene, config, row0, col0, stride).tolist()[_P_BH:]
            if len(_CONST_BLOCKS) >= _MAX_CONST_BLOCKS:
                _CONST_BLOCKS.clear()
            _CONST_BLOCKS[key] = const
            tracing.COUNTS["host.params.built"] += 1
        else:
            tracing.COUNTS["host.params.reused"] += 1
        params = KernelParams()
        params.v[:] = _camera_floats(camera) + const
        return params


# ---- the monolithic kernel ----------------------------------------------------


def render_packed_reference(camera: Camera, scene: SceneParams,
                            config: TraceConfig = TraceConfig(), *, seed: int = 2020,
                            fast_math: bool = True, device, row0: int = 0,
                            local_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """The monolithic kernel's plain PyTorch version, on any device:
    `trace_image_reference`, then `shade_packed_reference`. Returns the
    packed int32 (H, W) frame, or the band `row0` / `local_shape` as
    `render_packed` takes them.

    With `fast_math=True` it computes the fast tier's arithmetic in exact
    operations (see trace_rays) and quantizes round-half-up, so the fast
    kernel differs from it only by its approximate rsqrt and reciprocal.
    """
    _check_mono_config(config, scene, fast_math)
    result = trace_image_reference(camera, scene, config, fast_math=fast_math, device=device,
                                   row0=row0, local_shape=local_shape)
    return shade_packed_reference(result, camera, scene, config, seed=seed, fast_math=fast_math)


def shade_packed_reference(result: TraceResult, camera: Camera, scene: SceneParams,
                           config: TraceConfig, *, seed: int = 2020,
                           fast_math: bool = True) -> torch.Tensor:
    """The monolithic kernel's shading, plain, on the planes' device: the
    star field, captured rays black, and in the fast tier the disk's
    emission (models/disk.shade_disk_planes with the kernel's 128-entry
    table); round-half-up quantization in the fast tier, half-to-even in
    the exact."""
    vel = result.final_vel
    device = vel.device
    r, g, b = procedural_background(vel[..., 0], vel[..., 1], vel[..., 2], seed=seed)
    if config.disk:
        p = build_params(camera, scene, config).to(device)
        bh = p[_P_BH:_P_BH + 3]
        to_cam = p[_P_CAM:_P_CAM + 3] - bh
        obs_r = sqrt_rn(to_cam[0] * to_cam[0] + to_cam[1] * to_cam[1] + to_cam[2] * to_cam[2])
        hit = result.final_pos - bh
        lut = torch.from_numpy(kernel_lut_np()).to(device)
        disk_rgb = shade_disk_planes(hit[..., 0], hit[..., 2], vel, p[_P_RS], p[_P_RISCO],
                                     p[_P_ROUTER], p[_P_TISCO], obs_r, lut)
        is_disk = result.status == STATUS_DISK
        r, g, b = (torch.where(is_disk, d, c) for d, c in zip(disk_rgb, (r, g, b)))
    captured = result.status == STATUS_CAPTURED
    zero = torch.zeros((), dtype=torch.float32, device=device)
    r, g, b = (torch.where(captured, zero, c) for c in (r, g, b))
    return pack_rgba8_planes(r, g, b, half_up=fast_math)


@functools.cache
def _set_disk_lut(device_index: int) -> None:
    """Copy the fast kernel's blackbody table into the device's constant
    memory, once per device."""
    from ..utils.build import load_render_mono

    lib = load_render_mono()
    with tracing.span("setup.disk_lut"):
        lut = kernel_lut_np()
        _raise_on_error(lib, lib.bhr_set_disk_lut(device_index, lut.ctypes.data, lut.size),
                        "bhr_set_disk_lut")


def render_packed(camera: Camera, scene: SceneParams, config: TraceConfig = TraceConfig(),
                  *, seed: int = 2020, fast_math: bool = True, device,
                  out: torch.Tensor | None = None, row0: int = 0,
                  local_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Monolithic path: trace + shade in one kernel -> packed int32 (H, W).

    `row0` with `local_shape` (band_h, W) renders the band of rows [row0,
    row0 + band_h) of the frame (bhr_tpu's pallas_render_packed(row0=,
    local_shape=), the mesh's band): ray-gen refers to the scene's full
    width and height, so a band is bit for bit the same rows of the whole
    frame; rows past the frame's height are traced like any other.

    On a CPU device this is `render_packed_reference`. On a CUDA device it
    launches csrc/render_mono.cu on the current stream, without a host
    sync, and raises when CUDA is not available or the launch fails; the
    launch counts in tracing.COUNTS["launch.render_mono"], an exact Kerr
    (Kerr-Schild) one in ["launch.render_mono.ks"] too, and one of those
    in the fast tier in ["launch.render_mono.ks.fast"] as well. `out`, if
    given, is a contiguous int32 (H, W) tensor on `device` that
    receives the frame or band (the animation path renders into slices of
    one preallocated tensor).
    """
    with tracing.span("kernel.render_mono"):
        _check_mono_config(config, scene, fast_math)
        device = _kernel_device(device, "render_packed")
        shape = _local_shape(scene, 1, local_shape)
        if out is not None:
            _check_out(out, shape, torch.int32, device, "out")
        if device.type == "cpu":
            frame = render_packed_reference(camera, scene, config, seed=seed, fast_math=fast_math,
                                            device=device, row0=row0, local_shape=local_shape)
            return frame if out is None else out.copy_(frame)
        from ..utils.build import load_render_mono

        lib = load_render_mono()
        if config.disk:
            _set_disk_lut(device.index)
        if out is None:
            out = torch.empty(shape, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        flags = trace_flags(config)
        rc = lib.bhr_render_mono(
            _kernel_params(camera, scene, config, row0), seed_term(seed), int(bool(fast_math)),
            INTEGRATORS.index(config.integrator), flags, shape[0], shape[1],
            int(scene.max_steps), device.index, out.data_ptr(), stream,
        )
        _raise_on_error(lib, rc, "render_mono launch")
        tracing.COUNTS["launch.render_mono"] += 1
        tracing.COUNTS["launch.render_mono.ks"] += bool(flags & _FLAG_KS)
        tracing.COUNTS["launch.render_mono.ks.fast"] += bool(flags & _FLAG_KS and fast_math)
        return out


# ---- the planes kernel --------------------------------------------------------


def empty_trace_result(height: int, width: int, device) -> TraceResult:
    """Uninitialised planes of an (height, width) TraceResult on `device`,
    for `trace_image(out=...)`."""
    f32, i32 = torch.float32, torch.int32
    return TraceResult(
        final_pos=torch.empty((height, width, 3), dtype=f32, device=device),
        final_vel=torch.empty((height, width, 3), dtype=f32, device=device),
        status=torch.empty((height, width), dtype=i32, device=device),
        steps=torch.empty((height, width), dtype=i32, device=device),
    )


def _local_shape(scene: SceneParams, stride: int, local_shape) -> tuple[int, int]:
    """The (height, width) a trace covers: `local_shape`, or the frame."""
    if int(stride) < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if stride != 1 and local_shape is None:
        raise ValueError("a strided trace needs local_shape (ceil(H / stride), "
                         "ceil(W / stride) for a whole frame)")
    h, w = local_shape or (scene.screen_height, scene.screen_width)
    return int(h), int(w)


def _check_mask(mask: torch.Tensor, shape, device: torch.device) -> None:
    ok = (isinstance(mask, torch.Tensor) and tuple(mask.shape) == tuple(shape)
          and mask.dtype == torch.float32 and mask.device.type == device.type
          and device.index in (None, mask.device.index) and mask.is_contiguous())
    if not ok:
        raise ValueError(f"mask must be a contiguous float32 {tuple(shape)} tensor on {device}")


def trace_image_reference(camera: Camera, scene: SceneParams,
                          config: TraceConfig = TraceConfig(), *, fast_math: bool = False,
                          device, mask: torch.Tensor | None = None, stride: int = 1,
                          local_shape: tuple[int, int] | None = None, row0: int = 0,
                          col0: int = 0) -> TraceResult:
    """The planes kernel's plain PyTorch version, on any device:
    generate_rays, then trace_rays in the chosen tier. `mask`, `stride`,
    `local_shape`, `row0` and `col0` as `trace_image` takes them: only the
    rays the mask keeps are traced, and the others get the same defined
    values the kernel writes."""
    check_traceable(config)
    device = torch.device(device)
    shape = _local_shape(scene, stride, local_shape)
    origins, dirs = generate_rays(
        camera, scene.screen_width, scene.screen_height, scene.fov, device=device,
        stride=stride, row0=row0, col0=col0, local_shape=shape,
    )
    args = (scene.black_hole_position, scene.schwarzschild_radius, scene.spin, scene.max_steps,
            config)
    if mask is None:
        return trace_rays(origins, dirs, *args, fast_math=fast_math)
    _check_mask(mask, shape, device)
    keep = mask > 0.0
    # a masked-off ray: the camera position, its initial unit direction
    # (normalised again as trace_rays normalises), escaped, no steps
    result = TraceResult(
        final_pos=origins.clone(),
        final_vel=dirs / sqrt_rn(dot(dirs, dirs))[..., None],
        status=torch.full(shape, STATUS_ESCAPED, dtype=torch.int32, device=device),
        steps=torch.zeros(shape, dtype=torch.int32, device=device),
    )
    kept = trace_rays(origins[keep], dirs[keep], *args, fast_math=fast_math)
    for name in ("final_pos", "final_vel", "status", "steps"):
        getattr(result, name)[keep] = getattr(kept, name)
    return result


def trace_image(camera: Camera, scene: SceneParams, config: TraceConfig = TraceConfig(), *,
                fast_math: bool = False, device, out: TraceResult | None = None,
                mask: torch.Tensor | None = None, stride: int = 1,
                local_shape: tuple[int, int] | None = None, row0: int = 0,
                col0: int = 0) -> TraceResult:
    """Staged path: trace every pixel -> TraceResult of (H, W) planes
    (final_pos, final_vel fp32 (H, W, 3); status, steps int32 (H, W)), as
    bhr_tpu's pallas_trace_image returns, with `steps` always counted.

    `stride` > 1 with `local_shape` traces every stride-th pixel of the
    full image: local pixel (i, j) is full-image pixel (i * stride + row0,
    j * stride + col0), and ray-gen always refers to the scene's full
    width and height (the multires low pass). `row0` / `col0` with
    `local_shape` alone trace a band. The planes have the local shape.

    `mask` is a float32 tensor of the local shape on `device`: a ray whose
    mask is > 0 is traced exactly as without a mask; any other is not
    integrated and gets defined values -- final_pos the camera position,
    final_vel its initial unit direction, status STATUS_ESCAPED, steps 0
    -- which the caller is expected to discard (bhr_tpu leaves such pixels
    with a sentinel position outside the escape sphere; the kernel and the
    plain version here write the same values, so they compare on every
    pixel). The mask is read on the device: no host sync.

    On a CPU device this is `trace_image_reference`. On a CUDA device it
    launches csrc/trace_planes.cu on the current stream, without a host
    sync, and raises when CUDA is not available or the launch fails.
    `out`, if given (see `empty_trace_result`), receives the planes.

    With plugin physics (config.model "custom") the kernel is built with
    the plugin's acceleration (utils/build.load_trace_planes_custom; the
    recording raises ValueError for a plugin it cannot take) and the launch
    counts in tracing.COUNTS["launch.trace_planes.custom"] too; an exact
    Kerr (Kerr-Schild) launch counts in ["launch.trace_planes.ks"] too, and
    in ["launch.trace_planes.ks.fast"] as well in the fast tier. A launch
    that runs an instantiation with its flags fixed (`planes_flags_fixed`)
    counts in ["launch.trace_planes.fixed"] too.
    """
    with tracing.span("kernel.trace_planes"):
        check_traceable(config)
        device = _kernel_device(device, "trace_image")
        h, w = _local_shape(scene, stride, local_shape)
        if mask is not None:
            _check_mask(mask, (h, w), device)
        if out is not None:
            for name, shape, dtype in (("final_pos", (h, w, 3), torch.float32),
                                       ("final_vel", (h, w, 3), torch.float32),
                                       ("status", (h, w), torch.int32),
                                       ("steps", (h, w), torch.int32)):
                _check_out(getattr(out, name), shape, dtype, device, f"out.{name}")
        if device.type == "cpu":
            result = trace_image_reference(camera, scene, config, fast_math=fast_math,
                                           device=device, mask=mask, stride=stride,
                                           local_shape=local_shape, row0=row0, col0=col0)
            if out is None:
                return result
            for name in ("final_pos", "final_vel", "status", "steps"):
                getattr(out, name).copy_(getattr(result, name))
            return out
        from ..utils.build import load_trace_planes, load_trace_planes_custom

        custom = config.model == "custom"
        if custom:
            lib = load_trace_planes_custom(cuda_source(config.custom_accel))
        else:
            lib = load_trace_planes()
        if out is None:
            out = empty_trace_result(h, w, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        flags = trace_flags(config)
        rc = lib.bhr_trace_planes(
            _kernel_params(camera, scene, config, row0, col0, stride), int(bool(fast_math)),
            INTEGRATORS.index(config.integrator), flags, h, w, int(scene.max_steps),
            device.index, None if mask is None else mask.data_ptr(), out.final_pos.data_ptr(),
            out.final_vel.data_ptr(), out.status.data_ptr(), out.steps.data_ptr(), stream,
        )
        _raise_on_error(lib, rc, "trace_planes launch")
        tracing.COUNTS["launch.trace_planes"] += 1
        tracing.COUNTS["launch.trace_planes.strided"] += stride != 1
        tracing.COUNTS["launch.trace_planes.masked"] += mask is not None
        tracing.COUNTS["launch.trace_planes.custom"] += custom
        tracing.COUNTS["launch.trace_planes.ks"] += bool(flags & _FLAG_KS)
        tracing.COUNTS["launch.trace_planes.ks.fast"] += bool(flags & _FLAG_KS and fast_math)
        tracing.COUNTS["launch.trace_planes.fixed"] += planes_flags_fixed(
            config.integrator, flags, fast_math)
        return out
