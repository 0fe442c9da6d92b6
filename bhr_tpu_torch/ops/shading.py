"""Shading stage (PyTorch port of bhr_tpu/ops/shading.py:63-113).

Escaped and step-exhausted rays take the background colour of their final
direction; captured rays are black (reference: wgsl:154-170); disk hits
take the relativistic thin-disk emission; debug mode 1 replaces everything
with the step-count heatmap (wgsl:203-211). On the staged path this
epilogue runs as plain PyTorch on the device after the trace kernel.
"""

from __future__ import annotations

import functools

import torch

from ..core.math import dot, on_device, sqrt_rn
from ..core.scene import DEBUG_STEPS
from ..models.disk import disk_emission
from ..utils import tracing
from .heatmap import steps_to_color
from .sampling import (
    pack_rgba8_planes,
    sample_equirect_packed,
    sample_equirect_packed_checkerboard,
    sample_equirect_packed_luma,
    sample_equirect_packed_subsampled,
)
from .starfield import procedural_background
from .trace import STATUS_CAPTURED, STATUS_DISK, TraceResult


def shade_planes_packed(
    result: TraceResult,
    background,
    max_steps: int,
    debug_mode: int = 0,
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
    analytic star field. With `disk_params` (models/disk.DiskParams, on the
    planes' device), disk rays take `disk_emission` seen from
    `camera_position`, with the (512, 3) `blackbody_lut`. `tonemap` is a
    function of one colour plane, or None. `half_up` selects the fast
    monolithic kernel's quantizer (see sampling.pack_rgba8_planes); the
    staged epilogue rounds half to even in both tiers.
    """
    if debug_mode == DEBUG_STEPS:
        rgb = steps_to_color(result.steps, max_steps)
        return pack_rgba8_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2], half_up=half_up)
    vel = result.final_vel
    with tracing.span("epilogue.background"):
        r, g, b = background(vel[..., 0], vel[..., 1], vel[..., 2])
    captured = result.status == STATUS_CAPTURED
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    r = torch.where(captured, zero, r)
    g = torch.where(captured, zero, g)
    b = torch.where(captured, zero, b)
    if disk_params is not None:
        bh = on_device(bh_pos, vel.device)
        to_cam = on_device(camera_position, vel.device) - bh
        emission = disk_emission(result.final_pos - bh, vel, sqrt_rn(dot(to_cam, to_cam)),
                                 on_device(rs, vel.device), disk_params, blackbody_lut)
        is_disk = result.status == STATUS_DISK
        r = torch.where(is_disk, emission[..., 0], r)
        g = torch.where(is_disk, emission[..., 1], g)
        b = torch.where(is_disk, emission[..., 2], b)
    if tonemap is not None:
        r, g, b = tonemap(r), tonemap(g), tonemap(b)
    return pack_rgba8_planes(r, g, b, half_up=half_up)


def texture_background(skybox, result: TraceResult, *, texture_filter: str, texture_subsample,
                       seed: int, approximate: bool = True):
    """The background callable (dx, dy, dz) -> (r, g, b) of a shading
    epilogue (bhr_tpu/renderer.py:333-381, bhr_tpu/ops/multires.py:111-146):
    the analytic star field of `seed` without a skybox; else the packed
    texture through the luma tier (`skybox` is then luma_pack_texture's
    pair), the subsampled or checkerboard reconstruction, or the plain
    sampler. `approximate=False` (the debug views) switches the luma and
    subsampled tiers off, as bhr_tpu does."""
    if skybox is None:
        return functools.partial(procedural_background, seed=seed)
    vel, status = result.final_vel, result.status
    planes = (vel[..., 0], vel[..., 1], vel[..., 2], status)
    if texture_filter == "luma" and approximate:
        chroma_sub = (texture_subsample
                      if isinstance(texture_subsample, int) and texture_subsample > 1 else 2)
        rgb = sample_equirect_packed_luma(skybox, *planes, chroma_sub=chroma_sub)
        return lambda *_: rgb
    if texture_subsample != 1 and approximate:
        if texture_subsample == "checker":
            rgb = sample_equirect_packed_checkerboard(skybox, *planes, filter=texture_filter)
        else:
            rgb = sample_equirect_packed_subsampled(skybox, *planes, texture_subsample,
                                                    filter=texture_filter)
        return lambda *_: rgb
    return functools.partial(sample_equirect_packed, skybox, filter=texture_filter)
