"""Camera data model and ray generation (PyTorch port of
bhr_tpu/core/camera.py; reference: src/lib.rs:15-59 and the ray-gen block
of src/ray_tracer_euler.wgsl:183-198)."""

from __future__ import annotations

import dataclasses
import math
import struct

import torch

from .math import cross, dot, normalize, on_device, sqrt_rn

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera basis. All fields are fp32[3] tensors.

    Matches the field semantics of reference src/lib.rs:17-26.
    """

    position: torch.Tensor
    forward: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor

    @classmethod
    def new(cls, position, look_at, up, *, device="cpu") -> "Camera":
        """Look-at constructor (reference: src/lib.rs:35-59).

        forward = normalize(look_at - position)
        right   = normalize(forward x up)
        up      = normalize(right x forward)
        """
        position = torch.as_tensor(position, dtype=_F32, device=device)
        look_at = torch.as_tensor(look_at, dtype=_F32, device=device)
        up = torch.as_tensor(up, dtype=_F32, device=device)
        forward = normalize(look_at - position)
        right = normalize(cross(forward, up))
        up_ortho = normalize(cross(right, forward))
        return cls(position=position, forward=forward, right=right, up=up_ortho)

    look_at = new

    @classmethod
    def default(cls, *, device="cpu") -> "Camera":
        """Default library camera (reference: src/lib.rs:354-358)."""
        return cls.new([0.0, 5.0, 15.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], device=device)

    def to(self, device) -> "Camera":
        return Camera(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    fov,
    *,
    device=None,
    stride: int = 1,
    row0: int = 0,
    col0: int = 0,
    local_shape: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel primary rays for a (height, width) image on `device`
    (default: the camera's device).

    Mirrors the shader's ray-gen exactly (reference: wgsl:183-198):
      u = (x / W - 0.5) *  2 * aspect     (pixel index, NOT pixel center)
      v = (y / H - 0.5) * -2              (Y flipped)
      dir = normalize(fwd + right*u*tan(fov/2) + up*v*tan(fov/2))

    Returns (origins, directions), each fp32[height, width, 3] -- or
    fp32[*local_shape, 3] with `local_shape`, whose pixel (i, j) is pixel
    (i * stride + row0, j * stride + col0) of the full (height, width)
    image (bhr_tpu/ops/pallas_trace.py:743-757: the multires low pass, or a
    band); u and v always divide by the full width and height.
    tan(fov/2) and the aspect ratio are computed where `fov` lives (the
    host, by default), exactly as ops/trace_kernel.build_params computes
    them for the kernel. Every division has a tensor divisor on `device`:
    CUDA turns division by a host scalar into a multiply by its reciprocal,
    which rounds differently. Host values reach the device through fill
    kernels (core/math.on_device), so ray-gen makes the host wait for
    nothing.
    """
    device = camera.position.device if device is None else torch.device(device)
    fov = torch.as_tensor(fov, dtype=_F32)
    wf = torch.tensor(float(width), dtype=_F32)
    hf = torch.tensor(float(height), dtype=_F32)
    aspect = on_device(wf / hf, device)
    fov_factor = on_device(torch.tan(fov * 0.5), device)
    local_h, local_w = local_shape or (height, width)
    # pixel indices in integers, then converted, as the kernel does
    xs = (torch.arange(local_w, device=device) * stride + col0).to(_F32)
    ys = (torch.arange(local_h, device=device) * stride + row0).to(_F32)
    u = (xs / on_device(wf, device) - 0.5) * 2.0
    v = (ys / on_device(hf, device) - 0.5) * -2.0
    u = u * aspect
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    cam = Camera(*(on_device(getattr(camera, f.name), device)
                   for f in dataclasses.fields(camera)))
    d = (
        cam.forward
        + cam.right * (uu * fov_factor)[..., None]
        + cam.up * (vv * fov_factor)[..., None]
    )
    d = d / sqrt_rn(dot(d, d))[..., None]
    origins = cam.position.expand(d.shape)
    return origins, d


_FP32 = struct.Struct("f")


def _rn(x: float) -> float:
    """`x` rounded to the nearest fp32, as a Python float. A + - * / or
    square root of fp32 operands taken in float64 and rounded once here is
    the correctly rounded fp32 result (53 >= 2 * 24 + 2 bits). Raises
    OverflowError where the fp32 result would be infinite."""
    return _FP32.unpack(_FP32.pack(x))[0]


def _dot3(a, b) -> float:
    """core/math.dot on host floats: each product and sum rounded to fp32,
    summed left to right."""
    return _rn(_rn(_rn(a[0] * b[0]) + _rn(a[1] * b[1])) + _rn(a[2] * b[2]))


def _cross3(a, b) -> tuple[float, float, float]:
    """core/math.cross on host floats, rounded to fp32 as it rounds."""
    return (_rn(_rn(a[1] * b[2]) - _rn(a[2] * b[1])),
            _rn(_rn(a[2] * b[0]) - _rn(a[0] * b[2])),
            _rn(_rn(a[0] * b[1]) - _rn(a[1] * b[0])))


def _normalize3(v) -> tuple[float, float, float]:
    """core/math.normalize on host floats, with its zero-length guard."""
    length = _rn(math.sqrt(_dot3(v, v)))
    if not length > 0.0:
        return tuple(v)
    return tuple(_rn(x / length) for x in v)


def _look_at_host(position, look_at, up) -> tuple[tuple[float, float, float], ...]:
    """`Camera.new`'s basis on host floats (fp32 values, operation for
    operation in its order): (position, forward, right, up)."""
    forward = _normalize3([_rn(a - p) for a, p in zip(look_at, position)])
    right = _normalize3(_cross3(forward, up))
    return tuple(position), forward, right, _normalize3(_cross3(right, forward))


def orbit_camera(t, radius=15.0, height=5.0, rotation_speed=0.3, *, device="cpu") -> Camera:
    """Equatorial orbit camera as a pure function of time.

    Mirrors the app's animation loop (reference: src/main.rs:851-869):
    angle = t * 0.3 rad/s, camera at (r*cos, h, r*sin), always looking at the
    origin with +Y up.

    For one time on the CPU (the animation's camera, once a frame) the
    basis is computed on host floats, each operation rounded to fp32 as
    `Camera.new` rounds it, from the same torch.cos and torch.sin of the
    fp32 angle: bit for bit the tensor version's fields, without its
    ~50 tensor operations. A batch of times or another device takes the
    tensor version.
    """
    t = torch.as_tensor(t, dtype=_F32, device=device)
    angle = t * torch.tensor(rotation_speed, dtype=_F32, device=device)
    if angle.ndim == 0 and angle.device.type == "cpu":
        try:
            r = _rn(float(radius))
            pos = (_rn(r * torch.cos(angle).item()), _rn(float(height)),
                   _rn(r * torch.sin(angle).item()))
            basis = _look_at_host(pos, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        except OverflowError:  # an infinite fp32 value: the tensor version has it
            pass
        else:
            return Camera(*torch.tensor(basis, dtype=_F32).unbind(0))
    r = torch.tensor(radius, dtype=_F32, device=device)
    pos = torch.stack(
        [
            r * torch.cos(angle),
            torch.tensor(height, dtype=_F32, device=device).expand(angle.shape),
            r * torch.sin(angle),
        ],
        dim=-1,
    )
    return Camera.new(
        pos, torch.zeros(3, dtype=_F32, device=device), [0.0, 1.0, 0.0], device=device
    )
