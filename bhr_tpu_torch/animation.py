"""Animation: orbiting-camera frames rendered back to back on the device
(PyTorch port of bhr_tpu/animation.py; reference: src/main.rs:851-869,
angle = t * 0.3 rad/s, radius 15, height 5, looking at the origin).

Where bhr_tpu fuses the frames into one lax.scan, the port renders frame
by frame into one preallocated (F, H, W) tensor: one monolithic kernel
launch per frame (one neural_mlp launch for a neural renderer), or, for a
staged configuration, one planes-kernel launch into trace planes reused
across frames (the neural staged route for a neural one) and an epilogue
that writes its packed words into frames[k]. A frame with a texture skybox
is staged (one trace_planes launch, or the neural kernel's direction-plane
output, into the reused planes, then the texture epilogue); a renderer
with `multires = d` renders each frame by ops/multires.render_multires,
two trace_planes launches (strided, then masked). The cameras and kernel
parameters are computed on the host and passed by value, and the
epilogue's per-frame scalars reach the device as fill-kernel arguments, so
no frame waits for the device. The animation is a pure function of the
frame index, so `start_frame` resumes a run exactly.
"""

from __future__ import annotations

import torch

from .core.camera import orbit_camera
from .ops.sampling import unpack_frame
from .ops.multires import render_multires
from .ops.neural_kernel import dirs_kernel_takes
from .ops.trace_kernel import empty_trace_result, monolithic_eligible
from .renderer import BlackHoleRenderer, render_image


class OrbitAnimator:
    """Orbiting-camera animation driver (the reference app's path)."""

    def __init__(self, renderer: BlackHoleRenderer, rotation_speed: float = 0.3,
                 radius: float = 15.0, height: float = 5.0):
        self.renderer = renderer
        self.rotation_speed = rotation_speed
        self.radius = radius
        self.height = height

    def frame_times(self, n_frames: int, fps: float = 60.0, start_frame: int = 0) -> torch.Tensor:
        """fp32 times of frames start_frame .. start_frame + n_frames - 1."""
        idx = torch.arange(start_frame, start_frame + n_frames, dtype=torch.float32)
        return idx / torch.tensor(fps, dtype=torch.float32)

    def render_frames(self, n_frames: int, fps: float = 60.0, start_frame: int = 0,
                      scene=None, packed: bool = False) -> torch.Tensor:
        """Frames on the renderer's device: uint8 (F, H, W, 4), or packed
        int32 (F, H, W) when `packed`. Does not wait for the device."""
        r = self.renderer
        scene = r.frame_scene(scene)
        disk_params = r.disk_params(scene)
        frames = torch.empty((n_frames, r.height, r.width), dtype=torch.int32, device=r.device)
        neural = r.config.integrator == "neural"
        if neural:  # the direction-plane kernel writes into planes; the staged route does not
            staged = r.skybox is not None and dirs_kernel_takes(
                r.neural_params, scene, dtype=r.neural_dtype, precision=r.neural_precision)
        else:
            staged = not r.multires and not monolithic_eligible(
                r.config, scene, fast_math=r.fast_math, skybox=r.skybox, disk_params=disk_params,
                tonemap=r.tonemap)
        planes = empty_trace_result(r.height, r.width, r.device) if staged else None
        for k, t in enumerate(self.frame_times(n_frames, fps, start_frame)):
            cam = orbit_camera(t, radius=self.radius, height=self.height,
                               rotation_speed=self.rotation_speed)
            if r.multires and not neural:
                render_multires(cam, scene, packed=True, out=frames[k],
                                **r.multires_kwargs(scene, r.multires))
            else:
                render_image(cam, scene, config=r.config, fast_math=r.fast_math, device=r.device,
                             tonemap=r.tonemap, seed=r.skybox_seed, packed=True,
                             disk_params=disk_params, lut=r._lut, out=frames[k], planes=planes,
                             **r.shade_kwargs(), **r.neural_kwargs())
        return frames if packed else unpack_frame(frames)
