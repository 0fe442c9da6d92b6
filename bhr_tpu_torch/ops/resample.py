"""Static-phase plane resampling (PyTorch port of bhr_tpu/ops/resample.py).

For an integer factor the bilinear sample positions of an upsample fall on
`factor` static phases per axis, so upsampling blends whole planes with
their one-pixel shifts. Used by the multi-resolution renderer
(ops/multires.py, the deflection field's upsample) and the subsampled
texture samplers (ops/sampling.py).

All helpers are corner-aligned: the low grid holds samples of full-
resolution pixels j * factor, so full pixel q * factor + p interpolates low
pixels q and q + 1 with weight p / factor, and phase 0 is a bit-exact copy
of the low sample. Every value is bhr_tpu's expression tree in fp32.
"""

from __future__ import annotations

import numpy as np
import torch


def shift(plane: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """plane[clip(i + s)] along `axis` (edge clamp), for s in (-1, 0, 1)."""
    if s == 0:
        return plane
    n = plane.shape[axis]
    if s == 1:
        return torch.cat([plane.narrow(axis, 1, n - 1), plane.narrow(axis, n - 1, 1)], dim=axis)
    if s == -1:
        return torch.cat([plane.narrow(axis, 0, 1), plane.narrow(axis, 0, n - 1)], dim=axis)
    raise ValueError(s)


def upsample_axis(plane: torch.Tensor, factor: int, axis: int) -> torch.Tensor:
    """Bilinear x`factor` upsample along one axis, static phases, clamped."""
    phases = [plane]
    hi = shift(plane, 1, axis)
    for p in range(1, factor):
        frac = np.float32(p / factor)  # the weights rounded to fp32 as bhr_tpu rounds them
        phases.append(plane * float(np.float32(1.0) - frac) + hi * float(frac))
    stacked = torch.stack(phases, dim=axis + 1)
    shape = list(plane.shape)
    shape[axis] *= factor
    return stacked.reshape(shape)


def upsample_bilinear(plane: torch.Tensor, factor: int, out_shape) -> torch.Tensor:
    """(lh, lw) -> bilinear (lh * factor, lw * factor), cropped to out_shape."""
    up = upsample_axis(upsample_axis(plane, factor, 0), factor, 1)
    return up[: out_shape[0], : out_shape[1]]


def subsample(plane: torch.Tensor, stride: int, offset: int = 0) -> torch.Tensor:
    """plane[offset::stride, offset::stride]: what bhr_tpu's `subsample_mm`
    computes with two one-hot matrix products (exact, so the values are the
    slice's)."""
    return plane[offset::stride, offset::stride]


def neighbor_max(plane: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhood max (separable, edge-clamped)."""
    m = torch.maximum(torch.maximum(shift(plane, -1, 0), shift(plane, 1, 0)), plane)
    return torch.maximum(torch.maximum(shift(m, -1, 1), shift(m, 1, 1)), m)
