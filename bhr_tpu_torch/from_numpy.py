"""Build the port's data model from numpy arrays, so one scene (or one
set of surrogate weights) can feed both bhr_tpu and bhr_tpu_torch (pass
np.asarray of each JAX field)."""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.scene import DEBUG_NONE, SceneParams
from .models.neural import NeuralSurrogate


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
