"""Animation: frames along a camera path rendered back to back on the
device (PyTorch port of bhr_tpu/animation.py). `PathAnimator` takes any
`camera_fn(t) -> Camera`; `OrbitAnimator` is its subclass for the
reference app's orbit (src/main.rs:851-869: angle = t * 0.3 rad/s, radius
15, height 5, looking at the origin).

Where bhr_tpu fuses the frames into one lax.scan, the port renders frame
by frame into one preallocated (F, H, W) tensor. The renderer decides the
frames' route once a call (renderer._FramePlan: one render_mono or
neural_mlp launch a frame; a staged trace into planes reused across the
frames, then an epilogue that writes its packed words into frames[k]; or,
with `multires = d`, ops/multires' two trace_planes launches), and the
loop runs it. The cameras and kernel parameters are computed on the host
and passed by value, and the epilogue's per-frame scalars reach the device
as fill-kernel arguments, so no frame waits for the device. The animation
is a pure function of the frame index, so `start_frame` resumes a run
exactly, and `render_to_dir` resumes a PNG sequence from the first missing
frame (its manifest.json refuses a resume under another configuration).
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch

from .core.camera import orbit_camera
from .ops.sampling import unpack_frame
from .renderer import BlackHoleRenderer
from .utils import tracing


class PathAnimator:
    """Animation driver over an arbitrary camera path (bhr_tpu/animation.py:
    146-337). `camera_fn(t) -> Camera` is called on the host with t a 0-d
    fp32 tensor, once a frame; the camera goes to the kernel by value.
    Generalizes the reference's hardcoded orbit (main.rs:851-869)."""

    def __init__(self, renderer: BlackHoleRenderer, camera_fn):
        self.renderer = renderer
        self.camera_fn = camera_fn

    def frame_times(self, n_frames: int, fps: float = 60.0, start_frame: int = 0) -> torch.Tensor:
        """fp32 times of frames start_frame .. start_frame + n_frames - 1."""
        idx = torch.arange(start_frame, start_frame + n_frames, dtype=torch.float32)
        return idx / torch.tensor(fps, dtype=torch.float32)

    def render_frames(self, n_frames: int, fps: float = 60.0, start_frame: int = 0,
                      scene=None, packed: bool = False) -> torch.Tensor:
        """Frames on the renderer's device: uint8 (F, H, W, 4), or packed
        int32 (F, H, W) when `packed`. Does not wait for the device. While
        utils/tracing records, the call is a span "host.frames" and the
        spans of frame k carry start_frame + k."""
        with tracing.span("host.frames"):
            r = self.renderer
            plan = r._frame_setup(scene)
            frames = torch.empty((n_frames, r.height, r.width), dtype=torch.int32,
                                 device=r.device)
            with tracing.span("host.camera"):
                times = self.frame_times(n_frames, fps, start_frame)
            try:
                for k, t in enumerate(times):
                    tracing.set_frame(start_frame + k)
                    with tracing.span("host.camera"):
                        cam = self.camera_fn(t)
                    plan.render(cam, out=frames[k])
            finally:
                tracing.set_frame(None)
            return frames if packed else unpack_frame(frames)

    def _manifest(self, fps, scene) -> dict:
        """Render-run fingerprint for the manifest sidecar: everything that
        changes frame content (bhr_tpu/animation.py:_manifest), so that a
        resume under another configuration raises instead of mixing frames."""
        r = self.renderer
        scene = r.frame_scene(scene)

        def f(x):
            return torch.as_tensor(x, dtype=torch.float32).cpu().numpy().tolist()

        return {
            "width": r.width,
            "height": r.height,
            "fps": fps,
            "max_steps": int(scene.max_steps),
            "integrator": r.config.integrator,
            "model": r.config.model,
            "adaptive": r.config.adaptive,
            "disk": r.config.disk,
            "fast_math": r.fast_math,
            "tonemap": r.tonemap,
            "texture_filter": r.texture_filter,
            "texture_subsample": str(r.texture_subsample),
            "skybox": "texture" if r.skybox is not None else f"procedural:{r.skybox_seed}",
            "multires": r.multires,
            "scene": {
                "black_hole_position": f(scene.black_hole_position),
                "schwarzschild_radius": f(scene.schwarzschild_radius),
                "fov": f(scene.fov),
                "spin": f(scene.spin),
            },
            "camera_path": self._path_fingerprint(),
        }

    def _path_fingerprint(self) -> str:
        fn = self.camera_fn
        return f"custom:{getattr(fn, '__qualname__', repr(fn))}"

    def render_to_dir(self, out_dir: str, n_frames: int, fps: float = 60.0,
                      start_frame: int = 0, chunk_size: int = 16, scene=None,
                      resume: bool = False) -> list[str]:
        """Render chunk by chunk into a PNG sequence frame_{index:05d}.png,
        written by the native worker pool (io/native.submit_frame). With
        `resume=True`, frames already on disk are skipped and rendering
        continues from the first missing index, exactly, because a frame is
        a function of its index. A manifest.json sidecar records the render
        configuration; resuming into a directory whose manifest differs
        raises ValueError. Each chunk is read back to the host once."""
        from .io import native

        os.makedirs(out_dir, exist_ok=True)
        manifest = self._manifest(fps, scene)
        mpath = os.path.join(out_dir, "manifest.json")
        if resume and os.path.exists(mpath):
            try:
                with open(mpath) as fh:
                    existing = json.load(fh)
            except (OSError, json.JSONDecodeError):
                existing = None
            if existing is not None and existing != manifest:
                diff = {k for k in set(existing) | set(manifest)
                        if existing.get(k) != manifest.get(k)}
                raise ValueError(
                    f"resume=True but {mpath} was written by a different render configuration "
                    f"(differs in: {sorted(diff)}); use a fresh directory or matching settings")
        with open(mpath, "w") as fh:
            json.dump(manifest, fh, indent=1)
        paths = []
        done = 0
        if resume:
            while done < n_frames:
                path = os.path.join(out_dir, f"frame_{start_frame + done:05d}.png")
                if not os.path.exists(path):
                    break
                paths.append(path)
                done += 1
        while done < n_frames:
            n = min(chunk_size, n_frames - done)
            frames = self.render_frames(n, fps, start_frame + done, scene, packed=True)
            host = frames.cpu().numpy().view(np.uint8).reshape(n, frames.shape[1], -1, 4)
            for k in range(n):
                path = os.path.join(out_dir, f"frame_{start_frame + done + k:05d}.png")
                native.submit_frame(path, host[k])
                paths.append(path)
            done += n
        failures = native.drain()
        if failures:
            raise IOError(f"{failures} frame write(s) failed under {out_dir}")
        return paths

    def save_video(self, path: str, n_frames: int, fps: float = 30.0, scene=None,
                   quality: int = 90) -> None:
        """Render and write an MJPEG AVI (io/video.py; needs Pillow)."""
        from .io.video import write_mjpeg_avi

        frames = self.render_frames(n_frames, fps, 0, scene).cpu().numpy()
        write_mjpeg_avi(path, frames, fps=fps, quality=quality)

    def save_gif(self, path: str, n_frames: int, fps: float = 60.0, scene=None) -> None:
        """Render and write an animated GIF (needs Pillow)."""
        from PIL import Image

        frames = self.render_frames(n_frames, fps, 0, scene).cpu().numpy()
        imgs = [Image.fromarray(f, "RGBA").convert("P") for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000.0 / fps),
                     loop=0)


class OrbitAnimator(PathAnimator):
    """Orbiting-camera animation driver (the reference app's path)."""

    def __init__(self, renderer: BlackHoleRenderer, rotation_speed: float = 0.3,
                 radius: float = 15.0, height: float = 5.0):
        super().__init__(renderer, functools.partial(orbit_camera, radius=radius, height=height,
                                                     rotation_speed=rotation_speed))
        self.rotation_speed = rotation_speed
        self.radius = radius
        self.height = height

    def _path_fingerprint(self) -> str:
        return (f"orbit:speed={float(self.rotation_speed)},radius={float(self.radius)},"
                f"height={float(self.height)}")
