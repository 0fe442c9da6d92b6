"""What every plain reference of the benchmark shares: vector arithmetic,
the orbit camera, ray generation, the analytic star field and the packed
RGBA word.

These are copies of the raytracer's plain PyTorch versions, kept here so
that the yardstick does not move when the program does. They import no
module of the program. Every function computes in the dtype of its
tensors (float32 for the reference; the control runs the same functions
in a lower precision), and every division whose divisor is a host scalar
takes it as a tensor on the data's device: on CUDA, PyTorch turns a
division by a host scalar into a multiplication by its reciprocal, which
rounds differently.
"""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32
STATUS_RUNNING, STATUS_ESCAPED, STATUS_CAPTURED, STATUS_DISK = 0, 1, 2, 3
GRID = 96  # star cells per cube-face edge
_MASK32 = 0xFFFFFFFF


def dot(a, b):
    """Dot product over the last (size-3) axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def sqrt_rn(x):
    """Correctly rounded sqrt in x's dtype. PyTorch's vectorised CPU root is
    an ulp off on some inputs, so there it is taken in float64."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def rsqrt(x):
    """Correctly rounded 1/sqrt(x) in x's dtype (torch.rsqrt is approximate
    on CUDA)."""
    return torch.reciprocal(torch.sqrt(x.double())).to(x.dtype)


def on_device(x, device, dtype=F32):
    """A host value as a tensor on `device`, built by fill kernels (no copy
    from host memory, so no wait for the device's queue)."""
    x = torch.as_tensor(x, dtype=dtype)
    vals = [torch.full((), v, dtype=dtype, device=device) for v in x.reshape(-1).tolist()]
    return torch.stack(vals).reshape(x.shape)


def normalize(v):
    length = sqrt_rn(dot(v, v))[..., None]
    nonzero = length > 0.0
    return torch.where(nonzero, v / torch.where(nonzero, length, torch.ones_like(length)), v)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera basis on the host, fp32[3] each."""

    position: torch.Tensor
    forward: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor


def look_at(position, target, up) -> Camera:
    position = torch.as_tensor(position, dtype=F32)
    target = torch.as_tensor(target, dtype=F32)
    up = torch.as_tensor(up, dtype=F32)
    forward = normalize(target - position)
    right = normalize(cross(forward, up))
    return Camera(position, forward, right, normalize(cross(right, forward)))


def orbit_camera(frame: int, path: dict) -> Camera:
    """The reference app's orbit (src/main.rs:851-869) at frame index
    `frame`: t = frame / fps, angle = t * speed, the camera at (r cos, h,
    r sin) looking at the origin with +Y up; every value in fp32 as the
    application computes it."""
    t = torch.tensor(float(frame), dtype=F32) / torch.tensor(float(path["fps"]), dtype=F32)
    angle = t * torch.tensor(path["rotation_speed"], dtype=F32)
    r = torch.tensor(path["radius"], dtype=F32)
    pos = torch.stack([r * torch.cos(angle), torch.tensor(path["height"], dtype=F32),
                       r * torch.sin(angle)])
    return look_at(pos, torch.zeros(3, dtype=F32), [0.0, 1.0, 0.0])


def view_constants(width: int, height: int, fov: float):
    """(float W, float H, aspect, tan(fov / 2)) in fp32 on the host."""
    wf = torch.tensor(float(width), dtype=F32)
    hf = torch.tensor(float(height), dtype=F32)
    return wf, hf, wf / hf, torch.tan(torch.tensor(fov, dtype=F32) * 0.5)


def generate_rays(camera: Camera, width: int, height: int, fov: float, device, dtype=F32,
                  rows=None):
    """(origins, unit directions) of the shader's ray-gen (wgsl:183-198):
    u = (x / W - 0.5) * 2 * aspect, v = (y / H - 0.5) * -2 at the pixel
    index, dir = normalize(fwd + right u tan(fov/2) + up v tan(fov/2)).
    `rows` (start, stop) keeps a band of the frame's rows."""
    wf, hf, aspect, fov_factor = view_constants(width, height, fov)
    r0, r1 = rows or (0, height)
    xs = torch.arange(width, device=device).to(dtype)
    ys = torch.arange(r0, r1, device=device).to(dtype)
    u = (xs / on_device(wf, device, dtype) - 0.5) * 2.0
    v = (ys / on_device(hf, device, dtype) - 0.5) * -2.0
    u = u * on_device(aspect, device, dtype)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    ff = on_device(fov_factor, device, dtype)
    fwd, right, up = (on_device(getattr(camera, n), device, dtype)
                      for n in ("forward", "right", "up"))
    d = fwd + right * (uu * ff)[..., None] + up * (vv * ff)[..., None]
    d = d / sqrt_rn(dot(d, d))[..., None]
    return on_device(camera.position, device, dtype).expand(d.shape), d


# ---- the analytic star field -------------------------------------------------


def seed_term(seed: int) -> int:
    return (seed * 2654435761) & _MASK32


def _hash(x):
    """lowbias32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def _unit(h, dtype):
    return (h >> 8).to(F32).mul(1.0 / 16777216.0).to(dtype)


def star_field(dx, dy, dz, seed: int):
    """The default star field (cube-face hash lattice of 96 cells a face
    edge, 3x3 neighbourhood, power-law brightness, temperature tint,
    galactic band, x / (1 + x) tone map) -> (r, g, b) planes."""
    dtype = dx.dtype
    n_inv = rsqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx * n_inv, dy * n_inv, dz * n_inv
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    maj = torch.where(x_major, ax, torch.where(y_major, ay, az))
    inv_maj = 1.0 / maj
    s = torch.where(x_major, ny, torch.where(y_major, nz, nx)) * inv_maj
    t = torch.where(x_major, nz, torch.where(y_major, nx, ny)) * inv_maj
    axis = torch.where(x_major, 0, torch.where(y_major, 1, 2)).to(torch.int64)
    sign_bit = (torch.where(x_major, nx, torch.where(y_major, ny, nz)) < 0.0).to(torch.int64)
    face = axis * 2 + sign_bit
    fs = (s + 1.0) * (0.5 * GRID)
    ft = (t + 1.0) * (0.5 * GRID)
    cs0 = torch.floor(fs).to(torch.int64)
    ct0 = torch.floor(ft).to(torch.int64)
    offset = seed_term(seed)
    r = torch.zeros_like(fs)
    g = torch.zeros_like(fs)
    b = torch.zeros_like(fs)
    for dds in (-1, 0, 1):
        for ddt in (-1, 0, 1):
            cs = torch.clamp(cs0 + dds, 0, GRID - 1)
            ct = torch.clamp(ct0 + ddt, 0, GRID - 1)
            h = _hash((face * GRID * GRID + cs * GRID + ct + offset) & _MASK32)
            h2 = _hash(h)
            h3 = _hash(h2)
            h4 = _hash(h3)
            su = (cs0 + dds).to(dtype) + _unit(h, dtype)
            sv = (ct0 + ddt).to(dtype) + _unit(h2, dtype)
            du = fs - su
            dv = ft - sv
            d2 = du * du + dv * dv
            tt_ = _unit(h3, dtype)
            t2 = tt_ * tt_
            t4 = t2 * t2
            bright = t4 * t4 * 2.5 + 0.04
            fall = torch.clamp_min(1.0 - d2 * 18.0, 0.0)
            glow = fall * fall
            amp = bright * glow * glow
            temp = _unit(h4, dtype)
            r = r + amp * (0.75 + 0.25 * temp)
            g = g + amp * (0.80 + 0.15 * (4.0 * temp * (1.0 - temp)))
            b = b + amp * (1.00 - 0.45 * temp)
    h2d = nx * nx + nz * nz
    wobble = 2.0 * nx * nz * (1.0 / torch.clamp_min(h2d, 1e-6))
    tband = (ny - 0.12 * wobble) * (1.0 / 0.11)
    band = 1.0 / (1.0 + tband * tband)
    band = band * band
    r = r + band * 0.035
    g = g + band * 0.033
    b = b + band * 0.045
    return r / (1.0 + r), g / (1.0 + g), b / (1.0 + b)


def pack_rgba8(r, g, b, *, half_up: bool):
    """Colour planes in [0, 1] -> the packed RGBA int32 word, alpha 255:
    clip(c, 0, 1) * 255 rounded half to even, or half up (floor(x + 0.5))
    as the fast tier's and the neural kernel's quantizer rounds."""
    def q(c):
        x = torch.clamp(c.to(F32), 0.0, 1.0) * 255.0
        return (torch.floor(x + 0.5) if half_up else torch.round(x)).to(torch.int64)

    word = q(r) | (q(g) << 8) | (q(b) << 16) | (255 << 24)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)

