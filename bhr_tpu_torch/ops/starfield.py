"""Analytic procedural star field (PyTorch port of
bhr_tpu/ops/starfield.py:35-138).

A deterministic hash-based star field evaluated per pixel from the final
ray direction: cube-face star cells (96 per face edge, each star tested in
its 3x3 cell neighbourhood), power-law brightness, a temperature tint, a
galactic band, and the Reinhard x/(1+x) tone map. The CUDA kernel
(csrc/render_mono.cu) computes the same operations in the same order.

The lowbias32 hash runs in int64 masked to 32 bits: PyTorch has no `>>` or
`+` for uint32 on the CPU.
"""

from __future__ import annotations

import torch

from ..core.math import rsqrt

GRID = 96  # star cells per cube-face edge
_MASK32 = 0xFFFFFFFF


def seed_term(seed: int) -> int:
    """The per-seed offset added to every cell id before hashing
    (bhr_tpu/ops/starfield.py:101), as a Python int in [0, 2^32)."""
    return (seed * 2654435761) & _MASK32


def _hash(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 integer hash on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    x = x ^ (x >> 16)
    return x


def _unit(h: torch.Tensor) -> torch.Tensor:
    """uint32 -> fp32 in [0, 1) through its top 24 bits (exact in fp32)."""
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def procedural_background(dx, dy, dz, seed: int = 2020):
    """Default star field: cube-face hash lattice, transcendental-free.

    dx/dy/dz are fp32 (...,) direction components (not necessarily unit);
    returns (r, g, b) planes in [0, 1].
    """
    n_inv = rsqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx * n_inv, dy * n_inv, dz * n_inv
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)

    # dominant-axis cube projection: face id in 0..5, in-face coords s,t
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    maj = torch.where(x_major, ax, torch.where(y_major, ay, az))
    inv_maj = 1.0 / maj
    s = torch.where(x_major, ny, torch.where(y_major, nz, nx)) * inv_maj
    t = torch.where(x_major, nz, torch.where(y_major, nx, ny)) * inv_maj
    axis = torch.where(x_major, 0, torch.where(y_major, 1, 2)).to(torch.int64)
    sign_bit = (torch.where(x_major, nx, torch.where(y_major, ny, nz)) < 0.0).to(torch.int64)
    face = axis * 2 + sign_bit  # 0..5

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
            su = (cs0 + dds).to(torch.float32) + _unit(h)
            sv = (ct0 + ddt).to(torch.float32) + _unit(h2)
            du = fs - su
            dv = ft - sv
            d2 = du * du + dv * dv
            tt_ = _unit(h3)
            t2 = tt_ * tt_
            t4 = t2 * t2
            bright = t4 * t4 * 2.5 + 0.04
            fall = torch.clamp_min(1.0 - d2 * 18.0, 0.0)
            glow = fall * fall
            amp = bright * glow * glow
            temp = _unit(h4)
            r = r + amp * (0.75 + 0.25 * temp)
            # parabola 4t(1-t) stands in for sin(pi t)
            g = g + amp * (0.80 + 0.15 * (4.0 * temp * (1.0 - temp)))
            b = b + amp * (1.00 - 0.45 * temp)

    # galactic band around the equator; azimuthal wobble via
    # sin(2*az) = 2*nx*nz/(nx^2+nz^2)
    h2d = nx * nx + nz * nz
    wobble = 2.0 * nx * nz * (1.0 / torch.clamp_min(h2d, 1e-6))
    tband = (ny - 0.12 * wobble) * (1.0 / 0.11)
    band = 1.0 / (1.0 + tband * tband)
    band = band * band
    r = r + band * 0.035
    g = g + band * 0.033
    b = b + band * 0.045

    r = r / (1.0 + r)
    g = g / (1.0 + g)
    b = b / (1.0 + b)
    return r, g, b
