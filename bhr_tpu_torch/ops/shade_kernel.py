"""The staged epilogue's CUDA kernel (csrc/shade_planes.cu): its route and
its wrapper.

`shade_kernel_takes` decides from what a `renderer.shade_image` call holds
whether the kernel shades the frame: contiguous planes (and `out`) on a
CUDA device, the analytic star field (no skybox), no debug view, the
passthrough tonemap, and no disk or the (512, 3) fp32 blackbody table with
DiskParams on the device. Every other frame keeps the plain epilogue
(`renderer.shade_image_reference`): a texture, the step heatmap, the
reinhard and srgb tonemaps, strided planes, every CPU frame; so does the
multires epilogue's "select" curve, which does not go through
shade_image. `shade_planes` launches the kernel or raises: it never falls
back to the plain epilogue, which stays the kernel's yardstick.
"""

from __future__ import annotations

import torch

from ..core.camera import Camera
from ..core.scene import SceneParams
from ..models.disk import LUT_STEPS, DiskParams
from ..utils import tracing
from .starfield import seed_term
from .trace import TraceResult
from .trace_kernel import _check_out, _kernel_device, _raise_on_error

_F32 = torch.float32
_DISK_FIELDS = ("r_isco", "r_outer", "t_isco")


def _device_scalar(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.dim() == 0 and t.dtype == _F32
            and t.device.type != "cpu")


def shade_kernel_takes(device, scene: SceneParams, *, skybox, tonemap: str, disk_params,
                       lut, planes=()) -> bool:
    """True when csrc/shade_planes.cu shades a staged frame whose planes lie
    on `device`: a CUDA device, the analytic star field (`skybox` None), no
    debug view, the passthrough tonemap, every tensor of `planes` (what the
    kernel reads and writes, `kernel_planes`; None for one not given)
    contiguous, and either no disk (`disk_params` None) or the (512, 3)
    fp32 `lut` with each value of `disk_params` a 0-d fp32 tensor off the
    host. DiskParams on the host (DiskParams.for_scene of a float) keep the
    plain epilogue, which divides by them as host scalars, that is by a
    multiply with their reciprocal; so do strided planes or `out`, which
    the plain epilogue reads and fills whatever their layout."""
    disk_ok = disk_params is None or (
        isinstance(lut, torch.Tensor) and tuple(lut.shape) == (LUT_STEPS, 3)
        and lut.dtype == _F32
        and all(_device_scalar(getattr(disk_params, k)) for k in _DISK_FIELDS))
    return (torch.device(device).type == "cuda" and skybox is None and scene.debug_mode == 0
            and tonemap == "passthrough" and disk_ok
            and all(t is None or t.is_contiguous() for t in planes))


def kernel_planes(result: TraceResult, disk_params, out) -> tuple:
    """The tensors csrc/shade_planes.cu reads and writes for a frame:
    final_vel, status and `out`, and final_pos only with the disk (a frame
    without it never reads the hit points, which the neural route leaves
    as the camera's position broadcast)."""
    return (result.final_vel, result.status, out,
            result.final_pos if disk_params is not None else None)


def _check_plane(t, shape, dtype, device, what: str) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what} must be a tensor; got {type(t).__name__}")
    _check_out(t, shape, dtype, device, what)


def _check_planes(result: TraceResult, disk_params, lut, out) -> tuple:
    """(H, W, device) of planes `shade_planes` can take; ValueError for a
    plane, table, disk value or `out` of the wrong dtype, shape, device or
    layout, or planes off a CUDA device."""
    vel = result.final_vel
    if not isinstance(vel, torch.Tensor) or vel.dim() != 3 or vel.shape[-1] != 3:
        raise ValueError(f"final_vel must be an (H, W, 3) tensor; got "
                         f"{tuple(getattr(vel, 'shape', ())) or type(vel).__name__}")
    h, w = vel.shape[:2]
    planes = [("final_vel", vel, (h, w, 3), _F32), ("status", result.status, (h, w), torch.int32)]
    if disk_params is not None:
        planes += [("final_pos", result.final_pos, (h, w, 3), _F32),
                   ("lut", lut, (LUT_STEPS, 3), _F32)]
        planes += [(f"disk_params.{k}", getattr(disk_params, k), (), _F32) for k in _DISK_FIELDS]
    if out is not None:
        planes.append(("out", out, (h, w), torch.int32))
    for what, t, shape, dtype in planes:
        _check_plane(t, shape, dtype, vel.device, what)
    if vel.device.type != "cuda":
        raise ValueError(f"shade_planes runs on a CUDA device, not {vel.device}; the plain "
                         "epilogue is renderer.shade_image_reference")
    return h, w, vel.device


def _host_floats(x) -> list:
    return torch.as_tensor(x, dtype=_F32).cpu().reshape(-1).tolist()


def shade_planes(result: TraceResult, camera: Camera, scene: SceneParams,
                 disk_params: DiskParams | None = None, lut: torch.Tensor | None = None, *,
                 seed: int = 2020, out: torch.Tensor | None = None) -> torch.Tensor:
    """One staged frame (or band) shaded in one csrc/shade_planes.cu launch
    -> packed int32 (H, W), bit-equal to `renderer.shade_image_reference`
    with the passthrough tonemap on the same planes: the star field of
    `seed`, captured rays black, with `disk_params` a disk ray's emission
    seen from `camera`, round half to even.

    `result.final_vel` fp32 (H, W, 3) and `result.status` int32 (H, W),
    and with `disk_params` also `result.final_pos` fp32 (H, W, 3), the
    (512, 3) fp32 `lut` and DiskParams' 0-d fp32 tensors, all contiguous on
    one CUDA device; `out`, if given, a contiguous int32 (H, W) tensor there
    that receives the frame. The scene's rs and positions go to the kernel
    as arguments, DiskParams and the table by pointer: no host sync.
    Launches on the current stream; raises ValueError for planes of the
    wrong dtype, shape, device or layout, RuntimeError when the launch
    fails."""
    with tracing.span("kernel.shade_planes"):
        h, w, device = _check_planes(result, disk_params, lut, out)
        device = _kernel_device(device, "shade_planes")
        from ..utils.build import load_shade_planes

        lib = load_shade_planes()
        if out is None:
            out = torch.empty((h, w), dtype=torch.int32, device=device)
        disk = disk_params is not None
        pointers = ([getattr(disk_params, k).data_ptr() for k in _DISK_FIELDS]
                    + [lut.data_ptr(), result.final_pos.data_ptr()] if disk else [None] * 5)
        (rs,) = _host_floats(scene.schwarzschild_radius)
        rc = lib.bhr_shade_planes(
            h * w, seed_term(seed), int(disk), rs, *_host_floats(scene.black_hole_position),
            *_host_floats(camera.position), *pointers, result.final_vel.data_ptr(),
            result.status.data_ptr(), out.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on_error(lib, rc, "shade_planes launch")
        tracing.COUNTS["launch.shade_planes"] += 1
        return out

