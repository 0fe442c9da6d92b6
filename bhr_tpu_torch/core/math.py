"""Vector math primitives (PyTorch port of bhr_tpu/core/math.py).

Every function works on fp32 tensors whose last axis holds the 3 vector
components, on whatever device the inputs live. Sums over the 3 components
are written out left to right, ((x + y) + z), so the result does not depend
on how a backend orders a reduction: the CUDA kernel
(csrc/render_mono.cu) uses the same order.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last (size-3) axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of 3-vectors (reference: src/lib.rs:129-135)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize with a zero-length guard: a zero vector comes back
    unchanged (reference: src/lib.rs:119-126)."""
    length = sqrt_rn(dot(v, v))[..., None]
    nonzero = length > 0.0
    return torch.where(nonzero, v / torch.where(nonzero, length, torch.ones_like(length)), v)


def direction_to_equirectangular_uv(direction: torch.Tensor) -> torch.Tensor:
    """Map fp32 (..., 3) directions to equirectangular (..., 2) UVs
    (reference: wgsl:93-98): u = 0.5 + atan2(z, x) / (2 pi), v = 0.5 -
    asin(y) / pi, on the direction normalised again as the shader does.
    The divisors are tensors on the data's device (see `on_device`)."""
    n = direction / sqrt_rn(dot(direction, direction))[..., None]
    u = 0.5 + torch.atan2(n[..., 2], n[..., 0]) / on_device(6.28318530718, n.device)
    v = 0.5 - torch.asin(torch.clamp(n[..., 1], -1.0, 1.0)) / on_device(3.14159265359, n.device)
    return torch.stack([u, v], dim=-1)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 1/sqrt(x).

    `torch.rsqrt` is an approximation on CUDA and 1/sqrt (two roundings) on
    the CPU; the exact-tier kernel uses the correctly rounded `__frsqrt_rn`,
    so the plain version computes in float64 and rounds once to fp32.
    """
    return torch.reciprocal(torch.sqrt(x.double())).to(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 sqrt on any device. `torch.sqrt` rounds
    correctly on CUDA, but PyTorch's vectorised CPU kernel is off by an ulp
    on ~0.6% of inputs; there the root is taken in float64 and rounded once
    (exact: 53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(torch.float32)


def on_device(x, device) -> torch.Tensor:
    """A small fp32 host value (a scalar or a short vector) as a tensor on
    `device`, built by fill kernels that take each value as a kernel
    argument. A host-to-device copy would make the host wait for the
    device's queue to drain; this does not. A tensor already on a device is
    moved as it is."""
    x = torch.as_tensor(x, dtype=torch.float32)
    device = torch.device(device)
    if x.device.type == device.type and device.index in (None, x.device.index):
        return x
    if x.device.type != "cpu":
        return x.to(device)
    vals = [torch.full((), v, dtype=torch.float32, device=device) for v in x.reshape(-1).tolist()]
    return torch.stack(vals).reshape(x.shape)
