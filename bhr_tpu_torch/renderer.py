"""Renderer engine: the public API layer (PyTorch port of
bhr_tpu/renderer.py; reference: src/lib.rs:144-201, 317-703).

    ctx = CudaContext.new()
    renderer = BlackHoleRenderer.new_with_context(ctx, 800, 600)
    camera = Camera.new([15, 5, 0], [0, 0, 0], [0, 1, 0])
    renderer.render_frame(camera, SceneParams(screen_width=800, screen_height=600))
    renderer.save_image("black_hole_render.png")

The port renders the euler, rk4 and leapfrog integrators, fixed or adaptive
dt, on the Schwarzschild, exact Kerr ("kerr", Kerr-Schild Hamiltonian
geodesics), Lense-Thirring Kerr ("kerr_lt") or flat metric, with or
without the accretion disk, the analytic star field, the passthrough,
reinhard or srgb tonemap and the step-count heatmap, in the fast or the
exact math tier. A frame takes the route `frame_route` gives it, as
bhr_tpu/renderer.py:render_image routes it: one csrc/render_mono.cu launch
where the monolithic kernel can produce it, one csrc/neural_mlp.cu launch
for a star-field frame of the neural surrogate (integrator "neural", model
schwarzschild or kerr) at the default or highest tier, else a staged trace
shaded by `shade_image` on the device (one csrc/shade_planes.cu launch for
the star field with the passthrough tonemap and no debug view, the plain
PyTorch epilogue `shade_image_reference` for any other). One plan a call
(`_FramePlan`) runs the route for render_image, the renderer, the
animation and the mesh's bands.

A texture skybox (`skybox=` a path or an array, e.g. io/skybox.load_skybox()
for the procedural 2048x4096 star map) is packed once and kept on the device;
a frame with one is never monolithic: the planes kernel traces it (for the
neural surrogate, the direction-plane output of csrc/neural_mlp.cu,
ops/neural_kernel.neural_trace_dirs) and `shade_image` samples the texture
by `texture_filter` ("bilinear", "nearest", "luma") and
`texture_subsample` (an int, or "checker"). `render_frame_multires`
integrates at 1/divisor resolution through the planes kernel's strided and
masked ray-gen (ops/multires.py), and `cache_deflection=True` keeps the
trace while camera and scene geometry stand still and only shades again.
Plugin physics (`custom_physics=`, a Python file, module or callable of
utils/plugin.py) is traced by the planes kernel built with the plugin's
acceleration, never monolithic and never multires. On the CPU each
kernel's plain PyTorch version stands in. The TPU tuning arguments of
bhr_tpu (tile, kernel_knobs, use_pallas, interpret) have no counterpart
here.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import logging

import numpy as np
import torch

from .core.camera import Camera
from .core.math import on_device
from .core.scene import SceneParams
from .io import image as image_io
from .io.skybox import load_skybox
from .models import neural, neural_kerr
from .models.disk import DiskParams, blackbody_lut
from .ops.display import TONEMAPS
from .ops.multires import render_multires, render_multires_band
from .ops.neural_kernel import (
    as_surrogate,
    dirs_kernel_takes,
    kernel_takes,
    neural_render_packed,
    neural_trace_dirs,
)
from .ops.neural_trace import neural_trace_image
from .ops.sampling import luma_pack_texture, pack_texture_rgba8, unpack_frame
from .ops.shade_kernel import kernel_planes, shade_kernel_takes, shade_planes
from .ops.shading import shade_planes_packed, texture_background
from .ops.trace import TraceConfig, TraceResult
from .ops.trace_kernel import empty_trace_result, monolithic_eligible, render_packed, trace_image
from .utils import tracing
from .utils.plugin import cuda_source, load_plugin


class CudaContext:
    """Device context, the analog of GpuContext (reference: lib.rs:144-201).

    `new()` takes the current CUDA device and raises when there is none:
    rendering on the CPU (with the kernel's plain version) has to be asked
    for with device="cpu".
    """

    def __init__(self, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is visible; pass device='cpu' to render with "
                    "the plain PyTorch version"
                )
            device = "cuda"
        self.device = torch.device(device)

    @classmethod
    def new(cls, device=None) -> "CudaContext":
        return cls(device)

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    def __repr__(self):
        return f"CudaContext(device={self.device})"


# Reference-name aliases: code written against the reference's `GpuContext`
# or bhr_tpu's `TpuContext` keeps working.
GpuContext = CudaContext
TpuContext = CudaContext

logger = logging.getLogger("bhr_tpu_torch")

NEURAL_PRECISIONS = ("auto", "default", "high", "highest")
# asset train_precision values whose weights need a multi-pass tier
# (bhr_tpu/renderer.py:545-550)
_FP32_TRAINED = ("float32", "highest", "high", "tensorfloat32")


def _integrator_from_path(name: str) -> tuple[str, str]:
    """Map an integrator name or legacy shader path to (integrator, model)."""
    low = name.lower()
    model = "kerr" if "kerr" in low else "schwarzschild"
    if "kerr_lt" in low or "lense" in low:
        model = "kerr_lt"
    if "flat" in low:
        model = "flat"
    if "neural" in low or "mlp" in low:
        integrator = "neural"
    elif "rk4" in low:
        integrator = "rk4"
    elif "leapfrog" in low or "verlet" in low:
        integrator = "leapfrog"
    else:
        integrator = "euler"
    return integrator, model


def _check_neural(model: str, adaptive: bool, disk: bool, multires: int) -> None:
    """The ValueErrors of bhr_tpu/renderer.py:481-500 for integrator='neural'."""
    if model not in ("schwarzschild", "kerr"):
        raise ValueError(f"integrator='neural' supports model='schwarzschild' or 'kerr' (got "
                         f"{model!r}); surrogates are trained on those dynamics")
    if adaptive or disk:
        raise ValueError("integrator='neural' does not support adaptive stepping or the "
                         "accretion disk -- it predicts only the final direction and capture "
                         "status")
    if multires:
        raise ValueError("integrator='neural' has no multires mode (the surrogate already "
                         "skips integration; there is no low-res geodesic pass to save)")


def frame_route(config: TraceConfig, scene: SceneParams, *, fast_math: bool, tonemap: str, skybox,
                disk_params, neural_params, neural_dtype: str, neural_precision: str,
                staged: bool = False) -> str:
    """Which kernels render the frame (bhr_tpu/renderer.py:127-239; the frame
    path's one caller of their predicates): "mono" (render_mono), "neural"
    (neural_mlp), or, and always where `staged`, a trace then `shade_image`:
    "planes" (trace_planes), "dirs" (neural_mlp's direction planes) or
    "neural_staged" (ops/neural_trace)."""
    if config.integrator != "neural":
        mono = monolithic_eligible(config, scene, fast_math=fast_math, skybox=skybox,
                                   disk_params=disk_params, tonemap=tonemap)
        return "mono" if mono and not staged else "planes"
    if neural_params is None:
        raise ValueError("integrator='neural' needs neural_params")
    if skybox is None:
        if not staged and kernel_takes(neural_params, scene, tonemap=tonemap,
                                       precision=neural_precision):
            return "neural"
    elif dirs_kernel_takes(neural_params, scene, dtype=neural_dtype, precision=neural_precision):
        return "dirs"
    return "neural_staged"


@dataclasses.dataclass(frozen=True, eq=False, slots=True)
class _FramePlan:
    """The frames of one call: their `route`, decided once from the other
    fields (`frame_route`, or "multires" at `divisor`), and every input it
    reads. `planes`, if given, receive the "planes" and "dirs" routes'
    trace."""

    scene: SceneParams
    config: TraceConfig
    fast_math: bool
    device: torch.device
    tonemap: str = "passthrough"
    seed: int = 2020
    skybox: object = None
    disk_params: DiskParams | None = None
    lut: torch.Tensor | None = None
    texture_filter: str = "bilinear"
    texture_subsample: object = 1
    neural_params: object = None
    neural_dtype: str = "float32"
    neural_precision: str = "default"
    planes: TraceResult | None = None
    divisor: int = 0
    staged: bool = False
    route: str = dataclasses.field(init=False)

    def __post_init__(self):
        if self.tonemap not in TONEMAPS:
            raise ValueError(f"unknown tonemap {self.tonemap!r}; have {sorted(TONEMAPS)}")
        object.__setattr__(self, "route", "multires" if self.divisor else frame_route(
            self.config, self.scene, fast_math=self.fast_math, tonemap=self.tonemap,
            skybox=self.skybox, disk_params=self.disk_params, neural_params=self.neural_params,
            neural_dtype=self.neural_dtype, neural_precision=self.neural_precision,
            staged=self.staged))

    def render(self, camera: Camera, *, out: torch.Tensor | None = None, row0: int = 0,
               local_shape=None, **multires) -> torch.Tensor:
        """The packed int32 frame of `camera` (into `out` if given), or with
        `local_shape` (band_h, W) its band of rows from `row0`. `multires`
        keywords (edge_fix, edge_threshold, texture_subsample) go to
        ops/multires, and only there."""
        band = dict(row0=row0, local_shape=local_shape)
        if self.route == "multires":
            kw = dict(config=self.config, device=self.device, divisor=self.divisor,
                      texture_filter=self.texture_filter, seed=self.seed, fast_math=self.fast_math,
                      **{"texture_subsample": self.texture_subsample, **multires})
            if local_shape is None:
                return render_multires(camera, self.scene, self.skybox, self.disk_params,
                                       packed=True, out=out, **kw)
            return render_multires_band(camera, self.scene, self.skybox, self.disk_params,
                                        row0=row0, band_h=local_shape[0], **kw)
        if multires:
            raise TypeError(f"the {self.route!r} route takes no {sorted(multires)}")
        if self.route == "mono":
            return render_packed(camera, self.scene, self.config, seed=self.seed,
                                 fast_math=self.fast_math, device=self.device, out=out, **band)
        if self.route == "neural":
            return neural_render_packed(self.neural_params, camera, self.scene, seed=self.seed,
                                        precision=self.neural_precision, device=self.device,
                                        out=out, **band)
        return self.shade(self.trace(camera, **band), camera, out=out)

    def trace(self, camera: Camera, *, row0: int = 0, local_shape=None) -> TraceResult:
        """The staged route's trace of `camera` (or of its band)."""
        band = dict(row0=row0, local_shape=local_shape)
        if self.route == "planes":
            return trace_image(camera, self.scene, self.config, fast_math=self.fast_math,
                               device=self.device, out=self.planes, **band)
        if self.route == "dirs":
            return neural_trace_dirs(self.neural_params, camera, self.scene,
                                     precision=self.neural_precision, device=self.device,
                                     out=self.planes, **band)
        if self.route == "neural_staged":
            return neural_trace_image(self.neural_params, camera, self.scene, device=self.device,
                                      dtype=self.neural_dtype, precision=self.neural_precision,
                                      **band)
        raise ValueError(f"the {self.route!r} route has no staged trace")

    def shade(self, result: TraceResult, camera: Camera, *,
              out: torch.Tensor | None = None) -> torch.Tensor:
        """`shade_image` of `result` with the plan's inputs -> packed int32."""
        return shade_image(result, camera, self.scene, self.disk_params, self.lut,
                           tonemap=self.tonemap, seed=self.seed, packed=True, out=out,
                           skybox=self.skybox, texture_filter=self.texture_filter,
                           texture_subsample=self.texture_subsample)


def render_image(camera: Camera, scene: SceneParams, *, config: TraceConfig, fast_math: bool,
                 device, tonemap: str = "passthrough", seed: int = 2020, packed: bool = False,
                 skybox=None, disk_params=None, lut=None, out: torch.Tensor | None = None,
                 planes: TraceResult | None = None, texture_filter: str = "bilinear",
                 texture_subsample=1, neural_params=None, neural_dtype: str = "float32",
                 neural_precision: str = "default", row0: int = 0,
                 local_shape=None) -> torch.Tensor:
    """One frame on `device`: uint8 (H, W, 4), or the packed int32 (H, W)
    frame when `packed` (bhr_tpu/renderer.py:127-307); with `local_shape`
    (band_h, W), the band of rows [row0, row0 + band_h) of that frame, bit
    for bit its rows (the band of parallel/mesh.py: every kernel's ray-gen
    refers to the frame's size; a texture's chroma and subsample grids
    anchor at the band's first row).

    The frame takes the route `frame_route` gives it. With config.disk,
    `disk_params` (models/disk.DiskParams on `device`) and the (512, 3)
    `lut` shade the disk in the staged epilogue. `skybox` is None for the
    analytic star field of `seed`, or the packed int32 texture on `device`
    (ops/sampling.pack_texture_rgba8; for texture_filter "luma",
    luma_pack_texture's pair). `out`, if given, receives the packed frame;
    `planes` (ops/trace_kernel.empty_trace_result) the staged trace. With
    config.integrator "neural", `neural_params` (a NeuralSurrogate on
    `device`) predicts the deflection field at `neural_dtype` and
    `neural_precision` ("default", "high" or "highest")."""
    plan = _FramePlan(scene, config, fast_math, device, tonemap=tonemap, seed=seed, skybox=skybox,
                      disk_params=disk_params, lut=lut, texture_filter=texture_filter,
                      texture_subsample=texture_subsample, neural_params=neural_params,
                      neural_dtype=neural_dtype, neural_precision=neural_precision, planes=planes)
    frame = plan.render(camera, out=out, row0=row0, local_shape=local_shape)
    return frame if packed else unpack_frame(frame)


def shade_image(result: TraceResult, camera: Camera, scene: SceneParams, disk_params, lut, *,
                tonemap: str, seed: int = 2020, packed: bool = False,
                out: torch.Tensor | None = None, skybox=None, texture_filter: str = "bilinear",
                texture_subsample=1) -> torch.Tensor:
    """The staged path's shading epilogue (bhr_tpu/renderer.py:316-395) on
    the planes' device. A frame that `shade_kernel_takes` (contiguous
    planes on a CUDA device, the star field, passthrough, no debug view, no
    disk or the (512, 3) table) is one csrc/shade_planes.cu launch
    (ops/shade_kernel.shade_planes), bit-equal to the plain epilogue
    `shade_image_reference`; every other frame takes the plain epilogue,
    counted in tracing.COUNTS["epilogue.plain"] on a CUDA device. Returns
    uint8 (H, W, 4), or packed int32 (H, W) when `packed`; `out`, if given,
    receives the packed frame."""
    with tracing.span("epilogue"):
        if shade_kernel_takes(result.final_vel.device, scene, skybox=skybox, tonemap=tonemap,
                              disk_params=disk_params, lut=lut,
                              planes=kernel_planes(result, disk_params, out)):
            frame = shade_planes(result, camera, scene, disk_params, lut, seed=seed, out=out)
        else:
            tracing.COUNTS["epilogue.plain"] += result.final_vel.device.type == "cuda"
            frame = shade_image_reference(result, camera, scene, disk_params, lut,
                                          tonemap=tonemap, seed=seed, skybox=skybox,
                                          texture_filter=texture_filter,
                                          texture_subsample=texture_subsample)
            if out is not None:
                frame = out.copy_(frame)
        return frame if packed else unpack_frame(frame)


def shade_image_reference(result: TraceResult, camera: Camera, scene: SceneParams, disk_params,
                          lut, *, tonemap: str, seed: int = 2020, skybox=None,
                          texture_filter: str = "bilinear",
                          texture_subsample=1) -> torch.Tensor:
    """The plain epilogue, plain PyTorch on the planes' device -> packed
    int32 (H, W): the background -- the star field of `seed`, or the packed
    `skybox` texture through its filter tier (ops/shading.texture_background;
    a debug view switches the luma and subsampled tiers off) --, the disk's
    emission when `disk_params` is given, the tonemap, the step heatmap for
    scene.debug_mode == 1, and round-half-to-even quantization in both
    tiers. The CPU path, the path of every frame `shade_kernel_takes`
    refuses, and the yardstick of csrc/shade_planes.cu."""
    return shade_planes_packed(
        result,
        texture_background(skybox, result, texture_filter=texture_filter,
                           texture_subsample=texture_subsample, seed=seed,
                           approximate=scene.debug_mode == 0),
        scene.max_steps,
        debug_mode=scene.debug_mode,
        bh_pos=scene.black_hole_position,
        rs=scene.schwarzschild_radius,
        camera_position=camera.position,
        disk_params=disk_params,
        blackbody_lut=lut,
        tonemap=None if tonemap == "passthrough" else TONEMAPS[tonemap],
        half_up=False,
    )


class BlackHoleRenderer:
    """Black-hole ray-tracing engine (reference: src/lib.rs:317-703)."""

    def __init__(
        self,
        width: int = 800,
        height: int = 600,
        integrator: str = "euler",
        *,
        model: str | None = None,
        context: CudaContext | None = None,
        device=None,
        fast_math: bool = False,
        tonemap: str = "passthrough",
        skybox_seed: int = 2020,
        skybox=None,
        adaptive: bool = False,
        disk: bool = False,
        dt: float | None = None,
        texture_filter: str = "bilinear",
        texture_subsample=1,
        multires: int = 0,
        cache_deflection: bool = False,
        neural_params=None,
        neural_dtype: str = "float32",
        neural_precision: str = "auto",
        custom_physics=None,
    ):
        integ, path_model = _integrator_from_path(integrator)
        # runtime-swappable physics (bhr_tpu/renderer.py:433-457): a .py
        # path, module or callable providing acceleration(rel, vel, r, r2,
        # rs, spin) on component planes
        if custom_physics is not None:
            if model not in (None, "custom"):
                raise ValueError(f"custom_physics conflicts with model={model!r}; leave model "
                                 "unset (it becomes 'custom')")
            model = "custom"
            if multires:
                raise ValueError("custom physics has no multires mode (bhr_tpu runs it on its "
                                 "scratch-status kernel, which has no strided flavour): use "
                                 "full resolution")
        elif model == "custom":
            raise ValueError("model='custom' needs custom_physics=")
        model = model or path_model
        if model not in ("schwarzschild", "kerr", "kerr_lt", "flat", "custom"):
            raise ValueError(f"unknown spacetime model {model!r}")
        if integ == "neural":
            _check_neural(model, adaptive, disk, multires)
        if texture_filter == "fast":
            raise ValueError("the 'fast' prefiltered tier was removed (strictly inside the "
                             "speed/quality frontier); use 'luma' (bilinear-exact luminance at "
                             "about nearest's cost) instead")
        if texture_filter not in ("bilinear", "nearest", "luma"):
            raise ValueError(f"texture_filter must be bilinear/nearest/luma, got "
                             f"{texture_filter!r}")
        if texture_subsample != "checker":
            if int(texture_subsample) < 1:
                raise ValueError("texture_subsample must be >= 1 or 'checker'")
            texture_subsample = int(texture_subsample)
        if multires and int(multires) < 0:
            raise ValueError("multires divisor must be >= 0")
        if tonemap not in TONEMAPS:
            raise ValueError(f"unknown tonemap {tonemap!r}; have {sorted(TONEMAPS)}")
        if neural_precision not in NEURAL_PRECISIONS:
            raise ValueError(f"neural_precision must be auto/default/high/highest, got "
                             f"{neural_precision!r}")
        if str(neural_dtype) not in ("float32", "bfloat16"):
            raise ValueError(f"neural_dtype must be float32 or bfloat16, got {neural_dtype!r}")
        if context is not None and device is not None:
            raise ValueError("pass either context= or device=, not both")
        wanted = context.device if context is not None else torch.device(device or "cuda")
        plugin = {}
        if custom_physics is not None:
            with tracing.span("setup.plugin"):
                accel, capture_factor = load_plugin(custom_physics)
                if wanted.type == "cuda":
                    # the kernel's build takes the plugin's recorded arithmetic;
                    # one it cannot record raises here, naming what it does
                    cuda_source(accel)
            plugin = dict(custom_accel=accel, custom_capture_factor=capture_factor)
        self.context = context if context is not None else CudaContext.new(device)
        self.width = int(width)
        self.height = int(height)
        self.config = TraceConfig(integrator=integ, model=model, adaptive=bool(adaptive),
                                  disk=bool(disk), **({"dt": dt} if dt is not None else {}),
                                  **plugin)
        self.fast_math = bool(fast_math)
        self.tonemap = tonemap
        self.skybox_seed = int(skybox_seed)
        # int > 1: the texture's colour sampled on a 1/sub grid of the
        # full-resolution directions and upsampled; "checker": half the
        # pixels sampled in a checkerboard (ops/sampling.py)
        self.texture_filter = texture_filter
        self.texture_subsample = texture_subsample
        # skybox: None -> the analytic star field; a path or an array ->
        # decode, pack and keep on the device (bhr_tpu/renderer.py:607-628)
        self.skybox = None
        if skybox is not None:
            packed = pack_texture_rgba8(load_skybox(skybox), device=self.device)
            self.skybox = luma_pack_texture(packed) if texture_filter == "luma" else packed
        # the divisor of the animation path (OrbitAnimator): 0 is full
        # resolution. render_frame stays at full resolution; a single
        # multires frame comes from render_frame_multires
        self.multires = int(multires)
        # trace once per camera and scene geometry, shade every frame
        self.cache_deflection = bool(cache_deflection)
        self._deflection_key = None
        self._deflection_result = None
        # the staged epilogue's blackbody table, on the device once
        # (bhr_tpu/renderer.py:637)
        self._lut = blackbody_lut(device=self.device) if disk else None
        # default camera/scene (reference: lib.rs:354-370)
        self.camera = Camera.default()
        self.scene = SceneParams(screen_width=self.width, screen_height=self.height)
        self._last_frame = None
        # the neural surrogate (bhr_tpu/renderer.py:466-556): weights, their
        # trained domain, and the precision tier resolved from the asset
        self.neural_params = None
        self.neural_dtype = str(neural_dtype)
        self.neural_precision = neural_precision
        self._neural_domain = None
        self._neural_spin_range = None
        if integ == "neural":
            self._load_neural(model, neural_params)

    # -- constructors matching the reference API (lib.rs:339, 351) ---------

    @classmethod
    def new(cls, width: int, height: int, shader_path: str = "euler", **kw):
        return cls(width, height, shader_path, **kw)

    @classmethod
    def new_with_context(cls, context: CudaContext, width: int, height: int,
                         shader_path: str = "euler", **kw):
        return cls(width, height, shader_path, context=context, **kw)

    # -- the hot path (lib.rs:550-590) --------------------------------------

    def frame_scene(self, scene: SceneParams | None = None) -> SceneParams:
        """`scene` (default: the last one) at this renderer's image size."""
        scene = scene if scene is not None else self.scene
        if (scene.screen_width, scene.screen_height) != (self.width, self.height):
            scene = scene.replace(screen_width=self.width, screen_height=self.height)
        return scene

    def _load_neural(self, model: str, params) -> None:
        """Load the surrogate (the model's default asset when `params` is
        None, an npz path, a NeuralSurrogate or (W, b) pairs) onto the
        device, with its trained domain, and resolve "auto" precision from
        the asset's train_precision (bhr_tpu/renderer.py:501-556)."""
        load = neural_kerr.load_params if model == "kerr" else neural.load_params
        if params is None:
            asset = "neural_kerr.npz" if model == "kerr" else "neural_schwarzschild.npz"
            params = neural.ASSETS_DIR / asset
            if not params.exists():
                raise FileNotFoundError(f"no trained surrogate weights at {params} (pass "
                                        "neural_params=)")
        meta = None
        if isinstance(params, (str, bytes)) or hasattr(params, "__fspath__"):
            params, meta = load(params)
            if "r_range" in meta and "rs_range" in meta:
                self._neural_domain = (tuple(np.asarray(meta["r_range"], np.float32)),
                                       tuple(np.asarray(meta["rs_range"], np.float32)))
            if "spin_range" in meta:
                self._neural_spin_range = tuple(np.asarray(meta["spin_range"], np.float32))
        params = as_surrogate(params)
        if params.model != model:
            raise ValueError(f"the surrogate's shapes are a {params.model} net, not {model}")
        if self.neural_precision == "auto":
            # bf16-trained weights (no train_precision, or "default") are
            # native to the default tier; fp32-trained ones need "high"
            tp = str(meta.get("train_precision", "default")) if meta is not None else "default"
            self.neural_precision = "high" if tp in _FP32_TRAINED else "default"
        # a module of its own, so that moving it leaves the caller's in place
        self.neural_params = neural.NeuralSurrogate(params).to(self.device)

    def _warn_outside_domain(self, camera: Camera, scene: SceneParams) -> None:
        """Warn when the camera distance, rs or spin lie outside the ranges
        the weights were trained on (bhr_tpu/renderer.py:687-720)."""
        def host(x):
            return np.asarray(torch.as_tensor(x, dtype=torch.float32).cpu(), np.float32)

        if self._neural_domain is not None:
            r_rng, rs_rng = self._neural_domain
            r0 = float(np.linalg.norm(host(camera.position) - host(scene.black_hole_position)))
            rs_v = float(host(scene.schwarzschild_radius))
            if not (r_rng[0] <= r0 <= r_rng[1] and rs_rng[0] <= rs_v <= rs_rng[1]):
                logger.warning(
                    "neural surrogate extrapolating outside its trained domain: camera "
                    "r0=%.1f (trained %.1f-%.1f), rs=%.2f (trained %.2f-%.2f) -- quality is "
                    "unvalidated there", r0, r_rng[0], r_rng[1], rs_v, rs_rng[0], rs_rng[1],
                )
        if self._neural_spin_range is not None:
            spin_v = float(host(scene.spin))
            lo, hi = self._neural_spin_range
            if not lo <= spin_v <= hi:
                logger.warning("Kerr neural surrogate extrapolating outside its trained spin "
                               "range: a*=%.2f (trained %.2f-%.2f)", spin_v, lo, hi)

    def disk_params(self, scene: SceneParams) -> DiskParams | None:
        """The scene's disk on the device (bhr_tpu/renderer.py:721-722), or
        None without the disk. Built by fill kernels: no host sync."""
        if not self.config.disk:
            return None
        with tracing.span("epilogue"):
            return DiskParams.for_scene(on_device(scene.schwarzschild_radius, self.device))

    def _frame_plan(self, scene: SceneParams | None = None, *, divisor: int = 0,
                    staged: bool = False, reuse_planes: bool = False) -> _FramePlan:
        """The plan of this renderer's frames of `scene` (default: the last
        one), at the multires `divisor` if given, staged if `staged`. Where
        the route shades in an epilogue, the plan gets the disk's parameters
        and, with `reuse_planes`, planes its trace fills frame by frame."""
        scene = self.frame_scene(scene)
        plan = _FramePlan(scene, self.config, self.fast_math, self.device, tonemap=self.tonemap,
                          seed=self.skybox_seed, skybox=self.skybox, lut=self._lut,
                          texture_filter=self.texture_filter,
                          texture_subsample=self.texture_subsample,
                          neural_params=self.neural_params, neural_dtype=self.neural_dtype,
                          neural_precision=self.neural_precision, divisor=divisor, staged=staged)
        if plan.route in ("mono", "neural"):
            return plan
        reuse = reuse_planes and plan.route in ("planes", "dirs")
        return dataclasses.replace(
            plan, disk_params=self.disk_params(scene),
            planes=empty_trace_result(self.height, self.width, self.device) if reuse else None)

    def _frame_setup(self, scene: SceneParams | None = None) -> _FramePlan:
        """An animation's plan: at the `multires` divisor, with reused planes."""
        return self._frame_plan(scene, divisor=self.multires, reuse_planes=True)

    def render_frame(self, camera: Camera | None = None, scene: SceneParams | None = None,
                     timestamp_query=None) -> torch.Tensor:
        """Render one frame; returns (and retains) the uint8 (H, W, 4) RGBA
        tensor on the renderer's device. Does not wait for the device.

        `timestamp_query` (utils/timing.TimestampQuery) brackets the frame's
        work (bhr_tpu/renderer.py:751-757, 782-784; the reference's
        timestamp queries, lib.rs:569-577): on CUDA two events on the
        current stream, so the frame still makes no host sync; its
        gpu_time_ms waits for the device only when it is read."""
        camera = camera if camera is not None else self.camera
        scene = self.frame_scene(scene)
        if self.config.integrator == "neural":
            self._warn_outside_domain(camera, scene)
        if timestamp_query is not None:
            timestamp_query.begin(self.device)
        if self.cache_deflection and scene.debug_mode == 0:
            frame = self._render_cached(camera, self._frame_plan(scene, staged=True))
        else:
            frame = unpack_frame(self._frame_plan(scene).render(camera))
        if timestamp_query is not None:
            timestamp_query.end()
        self.camera = camera
        self.scene = scene
        self._last_frame = frame
        return frame

    def _static_key(self, camera: Camera, scene: SceneParams):
        """What the traced deflection field depends on: the camera basis,
        the black hole, fov, steps, image size and the trace configuration
        (bhr_tpu/renderer.py:790-803)."""
        arrs = (camera.position, camera.forward, camera.right, camera.up,
                scene.black_hole_position, scene.schwarzschild_radius, scene.fov, scene.spin)
        return (tuple(np.asarray(torch.as_tensor(a, dtype=torch.float32).cpu()).tobytes()
                      for a in arrs),
                scene.max_steps, scene.screen_width, scene.screen_height, self.config,
                self.fast_math)

    def _render_cached(self, camera: Camera, plan: _FramePlan) -> torch.Tensor:
        """Trace once per camera and scene geometry, shade every frame
        (bhr_tpu/renderer.py:805-850; the reference roadmap's Phase 4-4) by
        the staged `plan`: on the card one trace launch when the key
        changes, then none until it changes again."""
        key = self._static_key(camera, plan.scene)
        if key != self._deflection_key:
            self._deflection_result = plan.trace(camera)
            self._deflection_key = key
        return unpack_frame(plan.shade(self._deflection_result, camera))

    def render_frame_multires(self, camera: Camera | None = None,
                              scene: SceneParams | None = None, *, divisor: int = 3,
                              **kw) -> torch.Tensor:
        """An approximate frame from 1/divisor-resolution geodesics and a
        fix-up of the shadow's edge (ops/multires.render_multires; the
        reference roadmap's Phase 4-1): the star field or texture shades at
        full resolution on the interpolated deflection field, so only the
        lensing geometry is coarse. Two trace_planes launches, strided then
        masked. A disk interpolates the hit positions the same way; debug
        views are refused. Extra keywords (edge_fix, edge_threshold,
        texture_subsample) go to render_multires."""
        if int(divisor) < 1:
            raise ValueError("multires divisor must be >= 1")
        if self.config.integrator == "neural":
            raise ValueError("multires is not supported with integrator='neural'")
        if self.config.model == "custom":
            raise ValueError("custom physics has no multires mode: use render_frame")
        camera = camera if camera is not None else self.camera
        plan = self._frame_plan(scene, divisor=divisor)
        frame = unpack_frame(plan.render(camera, **kw))
        self.camera = camera
        self.scene = plan.scene
        self._last_frame = frame
        return frame

    # -- readback & I/O (lib.rs:613-702) ------------------------------------

    @property
    def output_texture_view(self) -> torch.Tensor:
        """The last rendered frame, still on the device (lib.rs:595-597)."""
        if self._last_frame is None:
            self.render_frame()
        return self._last_frame

    def get_image_data(self):
        """Device frame -> host uint8 (H, W, 4) numpy array (lib.rs:613-686)."""
        return image_io.get_image_data(self.output_texture_view)

    def save_image(self, path: str) -> None:
        """Save the last frame; format by extension (lib.rs:692-702)."""
        image_io.save_image(self.output_texture_view, path)

    @property
    def device(self) -> torch.device:
        return self.context.device

    @property
    def queue(self) -> torch.device:
        """Reference-API parity accessor (lib.rs:605-607): PyTorch has no
        queue object apart from the device's streams, so it returns the
        context's device, as bhr_tpu's does."""
        return self.context.device


def block_on(value):
    """Run an awaitable to completion, or pass a plain value through
    (bhr_tpu/renderer.py:1037-1046; the reference's Jupyter helper,
    src/lib.rs:712-716). The renderer is synchronous from Python, so a
    notebook cell like `block_on(GpuContext.new())` works unchanged."""
    if inspect.isawaitable(value):
        return asyncio.new_event_loop().run_until_complete(value)
    return value
