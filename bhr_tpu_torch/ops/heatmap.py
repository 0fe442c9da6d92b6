"""Step-count heatmap for the debug visualization mode (PyTorch port of
bhr_tpu/ops/heatmap.py; reference: src/ray_tracer_euler.wgsl:114-135):
blue -> cyan -> green -> yellow -> red over t = steps / max_steps, in four
linear segments, written branch-free."""

from __future__ import annotations

import torch

from ..core.math import on_device

_BLUE = (0.0, 0.0, 1.0)
_CYAN = (0.0, 1.0, 1.0)
_GREEN = (0.0, 1.0, 0.0)
_YELLOW = (1.0, 1.0, 0.0)
_RED = (1.0, 0.0, 0.0)


def _mix(a, b, t):
    """a + (b - a) * t per channel; the colours are kernel arguments, so
    nothing is copied to the device."""
    return torch.stack([ai + (bi - ai) * t for ai, bi in zip(a, b)], dim=-1)


def steps_to_color(steps: torch.Tensor, max_steps: int) -> torch.Tensor:
    """steps int (...,) -> fp32 (..., 3) heatmap colour."""
    t = steps.to(torch.float32) / on_device(float(max_steps), steps.device)
    c0 = _mix(_BLUE, _CYAN, t * 4.0)
    c1 = _mix(_CYAN, _GREEN, (t - 0.25) * 4.0)
    c2 = _mix(_GREEN, _YELLOW, (t - 0.5) * 4.0)
    c3 = _mix(_YELLOW, _RED, (t - 0.75) * 4.0)
    out = torch.where((t < 0.25)[..., None], c0, c1)
    out = torch.where((t < 0.5)[..., None], out, c2)
    out = torch.where((t < 0.75)[..., None], out, c3)
    return out
