"""Shading stage (PyTorch port of bhr_tpu/ops/shading.py:63-113).

Escaped and step-exhausted rays take the background colour of their final
direction; captured rays are black (reference: wgsl:154-170). The disk
emission, the debug heatmap and tonemaps are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.scene import DEBUG_NONE
from .sampling import pack_rgba8_planes
from .trace import STATUS_CAPTURED, TraceResult


def shade_planes_packed(
    result: TraceResult,
    background,
    max_steps: int,
    debug_mode: int = DEBUG_NONE,
    bh_pos=None,
    rs=None,
    camera_position=None,
    disk_params=None,
    blackbody_lut=None,
    tonemap=None,
    *,
    half_up: bool = False,
) -> torch.Tensor:
    """Planar shading epilogue -> packed RGBA int32 frame.

    `background` is a callable (dx, dy, dz) -> (r, g, b) planes, e.g. the
    analytic star field. `half_up` selects the fast tier's quantizer (see
    sampling.pack_rgba8_planes). `max_steps`, `bh_pos`, `rs` and
    `camera_position` serve the debug heatmap and the disk, which raise.
    """
    del max_steps, bh_pos, rs, camera_position
    if debug_mode != DEBUG_NONE:
        raise NotImplementedError("the debug step heatmap is not ported yet (ROADMAP queue A, item 7)")
    if disk_params is not None or blackbody_lut is not None:
        raise NotImplementedError("disk shading is not ported yet (ROADMAP queue A, item 8)")
    if tonemap is not None:
        raise NotImplementedError("tonemaps are not ported yet (ROADMAP queue A, item 6)")
    vel = result.final_vel
    r, g, b = background(vel[..., 0], vel[..., 1], vel[..., 2])
    captured = result.status == STATUS_CAPTURED
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    r = torch.where(captured, zero, r)
    g = torch.where(captured, zero, g)
    b = torch.where(captured, zero, b)
    return pack_rgba8_planes(r, g, b, half_up=half_up)
