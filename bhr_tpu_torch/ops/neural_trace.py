"""Frame-level neural-surrogate tracing, the staged route (PyTorch port of
bhr_tpu/ops/neural_trace.py:29-90).

Per-pixel ray-gen (the integrator paths' generate_rays), reduced features,
one MLP forward pass over the (H*W, F) pixel batch with torch.matmul, and
reconstruction into a TraceResult, so that the staged shading epilogue
(renderer.shade_image: star field, tonemaps, packed frames) applies
unchanged. Plain PyTorch on the device: bhr_tpu computes this route in XLA,
outside any Pallas kernel.

The surrogate classifies each ray as captured (black) or escaped (the
background along its predicted final direction); step counts are not
predicted, so `steps` is max_steps everywhere and the debug heatmap is
uniform.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera, generate_rays
from ..core.math import on_device
from ..models.neural import predict_directions
from ..models.neural_kerr import N_FEATURES_KERR, predict_directions_kerr
from .trace import STATUS_CAPTURED, STATUS_ESCAPED, TraceResult


def neural_trace_image(params, camera: Camera, scene, *, device, dtype=torch.float32,
                       precision="default", row0: int = 0,
                       local_shape: tuple[int, int] | None = None) -> TraceResult:
    """Predict the (H, W) deflection field of one frame on `device`, or
    with `local_shape` (band_h, W) that of its rows [row0, row0 + band_h)
    (the band route of bhr_tpu/parallel/mesh.py:121-126; ray-gen refers to
    the frame's size, so a band is the same rows of the whole frame).

    `params` is a models/neural.NeuralSurrogate (or a sequence of (W, b))
    on `device`, Schwarzschild or Kerr by its input width (the spin then
    comes from the scene); `dtype` and `precision` as mlp_apply takes
    them. Scene scalars reach the device through fill kernels, so the
    route makes the host wait for nothing.
    """
    device = torch.device(device)
    h, w = local_shape or (scene.screen_height, scene.screen_width)
    origins, dirs = generate_rays(camera, scene.screen_width, scene.screen_height, scene.fov,
                                  device=device, row0=row0, local_shape=(h, w))
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    bh = on_device(scene.black_hole_position, device)
    rs = on_device(scene.schwarzschild_radius, device)
    if params[0][0].shape[0] == N_FEATURES_KERR:
        vel, captured = predict_directions_kerr(
            params, flat_o, flat_d, bh, rs, on_device(scene.spin, device), dtype=dtype,
            precision=precision,
        )
    else:
        vel, captured = predict_directions(params, flat_o, flat_d, bh, rs, dtype=dtype,
                                           precision=precision)
    status = torch.where(captured.reshape(h, w), STATUS_CAPTURED, STATUS_ESCAPED).to(torch.int32)
    steps = torch.full((h, w), scene.max_steps, dtype=torch.int32, device=device)
    return TraceResult(final_pos=origins, final_vel=vel.reshape(h, w, 3), status=status,
                       steps=steps)
