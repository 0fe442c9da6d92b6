"""Multi-resolution rendering (PyTorch port of bhr_tpu/ops/multires.py;
the reference roadmap's Phase 4-1, docs/ROADMAP.md:826-946).

Geodesics are integrated at 1/divisor resolution, the resulting deflection
field (the final ray directions) is interpolated to full resolution, and
shading runs at full resolution on the interpolated directions, so the
star field or texture stays pixel-sharp while the integration runs on
divisor^2 times fewer rays. Pixels at the shadow's edge, where
interpolating the field would blend captured and escaped rays, are
detected and integrated again at full resolution.

One frame is two launches of csrc/trace_planes.cu (ops/trace_kernel.
trace_image): the strided low pass, then the masked full-resolution pass
over the edge pixels; the upsample, the edge detector, the merge and the
shading are plain PyTorch on the device, and nothing waits for the host.
bhr_tpu's loop knobs (tile, fix_tile, low_knobs, fix_knobs) restructure
its TPU loop with identical results and have no counterpart here.

This is an approximation mode (the reference targets SSIM > 0.95, not
parity): pixels off the edge shade with interpolated directions.
"""

from __future__ import annotations

import torch

from .resample import neighbor_max, shift, upsample_bilinear
from .sampling import unpack_frame
from .shading import shade_planes_packed, texture_background
from .trace import TraceConfig, TraceResult
from .trace_kernel import trace_image


def deflection_edges(vel_planes, status: torch.Tensor, threshold: float) -> torch.Tensor:
    """Low-resolution fp32 0/1 mask of pixels whose deflection field cannot
    be interpolated (bhr_tpu/ops/multires.py:53-72).

    A pixel is an edge when a 4-neighbour differs in termination status
    (the shadow's boundary) or in deflection by more than `threshold` (the
    photon ring's whirl, where the field's curvature outruns bilinear
    accuracy); dilated by one pixel so that the full-resolution bilinear
    support of every flagged sample is covered."""
    st = status.to(torch.float32)
    diff = torch.zeros_like(st)
    for axis in (0, 1):
        for s in (-1, 1):
            d = torch.zeros_like(st)
            for v in vel_planes:
                d = torch.maximum(d, torch.abs(shift(v, s, axis) - v))
            d = torch.maximum(d, torch.abs(shift(st, s, axis) - st) * 1e6)
            diff = torch.maximum(diff, d)
    return neighbor_max((diff > threshold).to(torch.float32))


def render_multires(camera, scene, skybox=None, disk_params=None, *,
                    config: TraceConfig = TraceConfig(), device, divisor: int = 3,
                    texture_filter: str = "bilinear", texture_subsample=1, seed: int = 2020,
                    edge_fix: bool = True, edge_threshold: float = 0.05,
                    fast_math: bool = True, packed: bool = False,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One frame with 1/divisor-resolution geodesics and the edge fix-up
    (bhr_tpu/ops/multires.py:172-289) -> uint8 (H, W, 4), or the packed
    int32 (H, W) frame when `packed`; `out`, if given, receives the packed
    frame.

    `skybox` is None (the analytic star field of `seed`), a packed int32
    texture, or luma_pack_texture's pair for texture_filter "luma". With
    `config.disk`, `disk_params` (models/disk.DiskParams on `device`) is
    needed: the low pass runs with the disk, the hit-position planes are
    upsampled beside the deflection field (every support of mixed status
    lands in the edge mask and is traced again), and the emission is
    evaluated per full-resolution pixel with bhr_tpu's "select" blackbody
    curve. Debug views need true per-pixel step counts and are refused.
    """
    if config.disk and disk_params is None:
        raise ValueError("config.disk needs disk_params")
    if scene.debug_mode != 0:
        raise ValueError("multires does not support debug modes")
    divisor = int(divisor)
    height, width = scene.screen_height, scene.screen_width
    out_shape = (height, width)
    # the strided low pass traces every divisor-th pixel of the full image,
    # so low pixel (i, j) is exactly full pixel (i * divisor, j * divisor)
    low = trace_image(camera, scene, config, fast_math=fast_math, device=device, stride=divisor,
                      local_shape=(-(-height // divisor), -(-width // divisor)))
    low_vel = [low.final_vel[..., k] for k in range(3)]
    vel = [upsample_bilinear(v, divisor, out_shape) for v in low_vel]
    pos = ([upsample_bilinear(low.final_pos[..., k], divisor, out_shape) for k in range(3)]
           if config.disk else None)

    def repeat(plane):
        return (plane.repeat_interleave(divisor, dim=0).repeat_interleave(divisor, dim=1)
                [:height, :width])

    status = repeat(low.status)
    if edge_fix:
        edge = repeat(deflection_edges(low_vel, low.status, edge_threshold)).contiguous()
        fix = trace_image(camera, scene, config, fast_math=fast_math, device=device, mask=edge)
        em = edge > 0.0
        vel = [torch.where(em, fix.final_vel[..., k], vel[k]) for k in range(3)]
        status = torch.where(em, fix.status, status)
        if config.disk:
            pos = [torch.where(em, fix.final_pos[..., k], pos[k]) for k in range(3)]
    result = TraceResult(
        final_pos=(torch.stack(pos, dim=-1) if config.disk
                   else torch.zeros((height, width, 3), dtype=torch.float32, device=status.device)),
        final_vel=torch.stack(vel, dim=-1),
        status=status,
        steps=torch.zeros(out_shape, dtype=torch.int32, device=status.device),
    )
    frame = shade_planes_packed(
        result,
        texture_background(skybox, result, texture_filter=texture_filter,
                           texture_subsample=texture_subsample, seed=seed),
        scene.max_steps,
        bh_pos=scene.black_hole_position,
        rs=scene.schwarzschild_radius,
        camera_position=camera.position,
        disk_params=disk_params,
        blackbody_lut="select" if config.disk else None,
    )
    if out is not None:
        frame = out.copy_(frame)
    return frame if packed else unpack_frame(frame)
