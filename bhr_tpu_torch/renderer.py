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
exact math tier. A frame that the monolithic kernel can produce goes to it
(csrc/render_mono.cu); every other one is traced by the planes kernel
(csrc/trace_planes.cu) and shaded by the plain PyTorch epilogue
`shade_image` on the device, as bhr_tpu/renderer.py:render_image routes
them. On the CPU each kernel's plain PyTorch version stands in. Plugin
physics, texture skyboxes, the neural surrogate and multires raise
NotImplementedError naming the ROADMAP item (queue A) that brings them. The TPU tuning
arguments of bhr_tpu (tile, kernel_knobs, use_pallas, interpret) have no
counterpart here.
"""

from __future__ import annotations

import functools

import torch

from .core.camera import Camera
from .core.math import on_device
from .core.scene import SceneParams
from .io import image as image_io
from .models.disk import DiskParams, blackbody_lut
from .ops.display import TONEMAPS
from .ops.sampling import unpack_frame
from .ops.shading import shade_planes_packed
from .ops.starfield import procedural_background
from .ops.trace import TraceConfig, TraceResult
from .ops.trace_kernel import monolithic_eligible, render_packed, trace_image


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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A, item {item})")


def render_image(camera: Camera, scene: SceneParams, *, config: TraceConfig, fast_math: bool,
                 device, tonemap: str = "passthrough", seed: int = 2020, packed: bool = False,
                 skybox=None, disk_params=None, lut=None, out: torch.Tensor | None = None,
                 planes: TraceResult | None = None) -> torch.Tensor:
    """One frame on `device`: uint8 (H, W, 4), or the packed int32 (H, W)
    frame when `packed` (bhr_tpu/renderer.py:127-307).

    A frame that `monolithic_eligible` admits is one render_mono launch;
    any other is one trace_planes launch followed by `shade_image`. With
    config.disk, `disk_params` (models/disk.DiskParams on `device`) and
    the (512, 3) `lut` shade the disk in the staged epilogue. `out`, if
    given, receives the packed frame; `planes` (ops/trace_kernel.
    empty_trace_result) are reused for the staged path's trace.
    """
    if skybox is not None:
        raise _not_ported("texture skyboxes", "10")
    if tonemap not in TONEMAPS:
        raise ValueError(f"unknown tonemap {tonemap!r}; have {sorted(TONEMAPS)}")
    if monolithic_eligible(config, scene, fast_math=fast_math, skybox=skybox,
                           disk_params=disk_params, tonemap=tonemap):
        frame = render_packed(camera, scene, config, seed=seed, fast_math=fast_math,
                              device=device, out=out)
        return frame if packed else unpack_frame(frame)
    result = trace_image(camera, scene, config, fast_math=fast_math, device=device, out=planes)
    return shade_image(result, camera, scene, disk_params, lut, tonemap=tonemap, seed=seed,
                       packed=packed, out=out)


def shade_image(result: TraceResult, camera: Camera, scene: SceneParams, disk_params, lut, *,
                tonemap: str, seed: int = 2020, packed: bool = False,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The staged path's shading epilogue (bhr_tpu/renderer.py:316-395),
    plain PyTorch on the planes' device: the star field of `seed`, the
    disk's emission when `disk_params` is given, the tonemap, the step
    heatmap for scene.debug_mode == 1, and round-half-to-even quantization
    in both tiers. Returns uint8 (H, W, 4), or packed int32 (H, W) when
    `packed`; `out`, if given, receives the packed frame."""
    tm = TONEMAPS[tonemap]
    frame = shade_planes_packed(
        result,
        functools.partial(procedural_background, seed=seed),
        scene.max_steps,
        debug_mode=scene.debug_mode,
        bh_pos=scene.black_hole_position,
        rs=scene.schwarzschild_radius,
        camera_position=camera.position,
        disk_params=disk_params,
        blackbody_lut=lut,
        tonemap=None if tonemap == "passthrough" else tm,
        half_up=False,
    )
    if out is not None:
        frame = out.copy_(frame)
    return frame if packed else unpack_frame(frame)


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
        multires: int = 0,
        neural_params=None,
        custom_physics=None,
    ):
        integ, path_model = _integrator_from_path(integrator)
        model = model or path_model
        if integ == "neural" or neural_params is not None:
            raise _not_ported("the neural surrogate", "11")
        if custom_physics is not None or model == "custom":
            raise _not_ported("plugin physics (model='custom')", "14")
        if model not in ("schwarzschild", "kerr", "kerr_lt", "flat"):
            raise ValueError(f"unknown spacetime model {model!r}")
        if skybox is not None:
            raise _not_ported("texture skyboxes", "10")
        if multires:
            raise _not_ported("multires rendering", "12")
        if tonemap not in TONEMAPS:
            raise ValueError(f"unknown tonemap {tonemap!r}; have {sorted(TONEMAPS)}")
        if context is not None and device is not None:
            raise ValueError("pass either context= or device=, not both")
        self.context = context if context is not None else CudaContext.new(device)
        self.width = int(width)
        self.height = int(height)
        self.config = TraceConfig(integrator=integ, model=model, adaptive=bool(adaptive),
                                  disk=bool(disk), **({"dt": dt} if dt is not None else {}))
        self.fast_math = bool(fast_math)
        self.tonemap = tonemap
        self.skybox_seed = int(skybox_seed)
        # the staged epilogue's blackbody table, on the device once
        # (bhr_tpu/renderer.py:637)
        self._lut = blackbody_lut(device=self.device) if disk else None
        # default camera/scene (reference: lib.rs:354-370)
        self.camera = Camera.default()
        self.scene = SceneParams(screen_width=self.width, screen_height=self.height)
        self._last_frame = None

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

    def disk_params(self, scene: SceneParams) -> DiskParams | None:
        """The scene's disk on the device (bhr_tpu/renderer.py:721-722), or
        None without the disk. Built by fill kernels: no host sync."""
        if not self.config.disk:
            return None
        return DiskParams.for_scene(on_device(scene.schwarzschild_radius, self.device))

    def render_frame(self, camera: Camera | None = None,
                     scene: SceneParams | None = None) -> torch.Tensor:
        """Render one frame; returns (and retains) the uint8 (H, W, 4) RGBA
        tensor on the renderer's device. Does not wait for the device."""
        camera = camera if camera is not None else self.camera
        scene = self.frame_scene(scene)
        frame = render_image(
            camera, scene, config=self.config, fast_math=self.fast_math,
            device=self.device, tonemap=self.tonemap, seed=self.skybox_seed,
            disk_params=self.disk_params(scene), lut=self._lut,
        )
        self.camera = camera
        self.scene = scene
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
