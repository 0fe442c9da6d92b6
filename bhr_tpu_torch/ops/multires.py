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
`render_multires_band` renders any band of the frame's rows, pixel for
pixel, for the mesh of parallel/mesh.py; the whole frame is the band of
all its rows. bhr_tpu's loop knobs (tile, fix_tile, low_knobs, fix_knobs)
restructure its TPU loop with identical results and have no counterpart
here.

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
    frame. The frame is the band of all its rows (`render_multires_band`),
    whose low pass traces 6 low rows outside the image (2 above, 4 below)
    that bhr_tpu's whole frame leaves out.

    `skybox` is None (the analytic star field of `seed`), a packed int32
    texture, or luma_pack_texture's pair for texture_filter "luma". With
    `config.disk`, `disk_params` (models/disk.DiskParams on `device`) is
    needed: the low pass runs with the disk, the hit-position planes are
    upsampled beside the deflection field (every support of mixed status
    lands in the edge mask and is traced again), and the emission is
    evaluated per full-resolution pixel with bhr_tpu's "select" blackbody
    curve. Debug views need true per-pixel step counts and are refused.
    """
    frame = render_multires_band(camera, scene, skybox, disk_params, row0=0,
                                 band_h=scene.screen_height, config=config, device=device,
                                 divisor=divisor, texture_filter=texture_filter,
                                 texture_subsample=texture_subsample, seed=seed, edge_fix=edge_fix,
                                 edge_threshold=edge_threshold, fast_math=fast_math)
    if out is not None:
        frame = out.copy_(frame)
    return frame if packed else unpack_frame(frame)


def render_multires_band(camera, scene, skybox=None, disk_params=None, *, row0: int,
                         band_h: int, config: TraceConfig = TraceConfig(), device,
                         divisor: int = 3, texture_filter: str = "bilinear",
                         texture_subsample=1, seed: int = 2020, edge_fix: bool = True,
                         edge_threshold: float = 0.05, fast_math: bool = True) -> torch.Tensor:
    """Rows [row0, row0 + band_h) of a multires frame -> packed int32
    (band_h, W) (bhr_tpu/ops/multires.py:292-430; the band of
    parallel/mesh.py; `render_multires` is the band of every row). Every
    band is the same rows of the whole frame, pixel for pixel:

      * the strided low pass traces the band's low rows plus a 2-row halo
        (the edge mask at a low row depends on rows +-2 through the
        shift-difference and the dilation), from low row row0 // d - 2,
        which is negative for the first band: ray-gen forms row * d + row0
        in integers, so any low row g is traced as in the whole frame's pass;
      * halo rows outside the image's low grid are replaced by copies of its
        border rows, as resample.shift's clamp sees the border;
      * the corner-aligned upsample is shift-invariant under the
        divisor-aligned block origin, so the band is the block's rows from
        row0 - low0 * d; the masked fix-up traces the band's own rows.

    The texture's chroma and subsample grids anchor at the band's first
    row, as bhr_tpu's band does.
    """
    if config.disk and disk_params is None:
        raise ValueError("config.disk needs disk_params")
    if scene.debug_mode != 0:
        raise ValueError("multires does not support debug modes")
    height, width = scene.screen_height, scene.screen_width
    d = int(divisor)
    lh_full, lw = -(-height // d), -(-width // d)
    halo = 2
    # a band's low rows span <= ceil(band_h / d) + 2 (a row0 off the
    # divisor's grid adds a partial row at each end), plus the halo
    n_low = -(-band_h // d) + 2 + 2 * halo
    low0 = int(row0) // d - halo
    low = trace_image(camera, scene, config, fast_math=fast_math, device=device, stride=d,
                      local_shape=(n_low, lw), row0=low0 * d)
    src = (torch.arange(low0, low0 + n_low, device=low.status.device)
           .clamp(0, lh_full - 1) - low0)

    def clamped(plane):
        return plane.index_select(0, src)

    up_shape = (n_low * d, width)
    off = int(row0) - low0 * d  # the band's first row in the upsampled block

    def band(plane):
        return plane[off:off + band_h]

    def repeat(plane):
        return band(plane.repeat_interleave(d, dim=0).repeat_interleave(d, dim=1)[:, :width])

    low_vel = [clamped(low.final_vel[..., k]) for k in range(3)]
    low_status = clamped(low.status)
    vel = [band(upsample_bilinear(v, d, up_shape)) for v in low_vel]
    pos = ([band(upsample_bilinear(clamped(low.final_pos[..., k]), d, up_shape))
            for k in range(3)] if config.disk else None)
    status = repeat(low_status)
    if edge_fix:
        edge = repeat(deflection_edges(low_vel, low_status, edge_threshold)).contiguous()
        fix = trace_image(camera, scene, config, fast_math=fast_math, device=device, mask=edge,
                          row0=int(row0), local_shape=(band_h, width))
        em = edge > 0.0
        vel = [torch.where(em, fix.final_vel[..., k], vel[k]) for k in range(3)]
        status = torch.where(em, fix.status, status)
        if config.disk:
            pos = [torch.where(em, fix.final_pos[..., k], pos[k]) for k in range(3)]
    shape = (band_h, width)
    result = TraceResult(
        final_pos=(torch.stack(pos, dim=-1) if config.disk
                   else torch.zeros((*shape, 3), dtype=torch.float32, device=status.device)),
        final_vel=torch.stack(vel, dim=-1),
        status=status,
        steps=torch.zeros(shape, dtype=torch.int32, device=status.device),
    )
    return _shade(result, camera, scene, skybox, disk_params, config,
                  texture_filter=texture_filter, texture_subsample=texture_subsample, seed=seed)


def _shade(result: TraceResult, camera, scene, skybox, disk_params, config: TraceConfig, *,
           texture_filter: str, texture_subsample, seed: int) -> torch.Tensor:
    """The multires epilogue (bhr_tpu/ops/multires.py:_shade_multires):
    the background at full resolution on the merged planes, the disk's
    emission with the "select" blackbody curve -> packed int32."""
    return shade_planes_packed(
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
