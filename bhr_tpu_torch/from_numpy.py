"""Build the port's data model from numpy arrays, so one scene (or one
set of surrogate weights, one skybox texture, one set of trace planes) can
feed both bhr_tpu and bhr_tpu_torch (pass np.asarray of each JAX field)."""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.scene import DEBUG_NONE, SceneParams
from .models.neural import NeuralSurrogate
from .ops.sampling import luma_pack_texture, pack_texture_rgba8
from .ops.trace import TraceResult


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def camera_from_numpy(position, forward, right, up) -> Camera:
    """A Camera from the four fp32[3] fields of a bhr_tpu Camera."""
    return Camera(position=_f32(position), forward=_f32(forward), right=_f32(right),
                  up=_f32(up))


def scene_from_numpy(black_hole_position, schwarzschild_radius, fov, spin, screen_width,
                     screen_height, max_steps, debug_mode=DEBUG_NONE) -> SceneParams:
    """A SceneParams from the fields of a bhr_tpu SceneParams."""
    return SceneParams(
        black_hole_position=_f32(black_hole_position),
        schwarzschild_radius=_f32(schwarzschild_radius),
        fov=_f32(fov),
        spin=_f32(spin),
        screen_width=int(screen_width),
        screen_height=int(screen_height),
        max_steps=int(max_steps),
        debug_mode=int(debug_mode),
    )


def neural_params_from_numpy(params) -> NeuralSurrogate:
    """A NeuralSurrogate from bhr_tpu's tuple of (W, b) surrogate weights
    (np.asarray of each), so that both packages compute with the same fp32
    weights."""
    return NeuralSurrogate((np.asarray(w, np.float32), np.asarray(b, np.float32))
                           for w, b in params)


def texture_from_numpy(texture, *, texture_filter: str = "bilinear", device="cpu"):
    """The port's device texture from bhr_tpu's: either its loaded skybox
    (io.skybox.load_skybox: fp32 (H, W, 3 or 4) of k/255) or its packed
    uint32 (H, W) plane (ops.sampling.pack_texture_rgba8). Returns the
    packed int32 (H, W) tensor with the same bits, or for `texture_filter`
    "luma" the pair of ops/sampling.luma_pack_texture, as
    BlackHoleRenderer keeps it and render_image, shade_image and
    render_multires take it."""
    arr = np.asarray(texture)
    if arr.ndim == 2:
        packed = torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(device)
    else:
        packed = pack_texture_rgba8(arr.astype(np.float32), device=device)
    return luma_pack_texture(packed) if texture_filter == "luma" else packed


def trace_result_from_numpy(final_pos, final_vel, status, steps, *, device="cpu") -> TraceResult:
    """A TraceResult from the four planes of a bhr_tpu TraceResult, so both
    packages shade the same trace."""
    return TraceResult(
        final_pos=_f32(final_pos).to(device),
        final_vel=_f32(final_vel).to(device),
        status=torch.from_numpy(np.array(status, dtype=np.int32)).to(device),
        steps=torch.from_numpy(np.array(steps, dtype=np.int32)).to(device),
    )
