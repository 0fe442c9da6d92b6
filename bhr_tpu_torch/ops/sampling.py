"""Frame packing (PyTorch port of bhr_tpu/ops/sampling.py:674-700).

The frame format is one packed 32-bit RGBA word per pixel,
R | G<<8 | B<<16 | A<<24, held in an int32 tensor with the same bits as
bhr_tpu's uint32 frame (PyTorch's uint32 lacks shifts and adds on the CPU).
`unpack_frame` views it as uint8 (..., H, W, 4); on a little-endian machine
that is the byte order of jax.lax.bitcast_convert_type.
"""

from __future__ import annotations

import torch


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_rgba8_planes(r, g, b, alpha: float = 1.0, *, half_up: bool = False) -> torch.Tensor:
    """fp32 color planes in [0,1] -> packed RGBA int32 plane.

    Rounds clip(c, 0, 1) * 255 half to even, like jnp.round; `half_up=True`
    rounds half up, floor(x + 0.5), as the fast tier's in-kernel quantizer
    does (bhr_tpu/ops/pallas_trace.py:1306-1312).
    """
    def q(c):
        x = torch.clamp(c, 0.0, 1.0) * 255.0
        x = torch.floor(x + 0.5) if half_up else torch.round(x)
        return x.to(torch.int64)

    a = int(round(alpha * 255.0)) << 24
    return _to_int32_bits(q(r) | (q(g) << 8) | (q(b) << 16) | a)


def unpack_frame(packed: torch.Tensor) -> torch.Tensor:
    """Packed int32 (..., H, W) frame -> uint8 (..., H, W, 4) RGBA view."""
    return packed.contiguous().view(torch.uint8).view(*packed.shape, 4)


def quantize_rgba8(rgb: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """fp32 (..., 3) in [0,1] -> uint8 (..., 4) RGBA (rgba8unorm: round to
    nearest even of clamp(v, 0, 1) * 255; reference alpha 1.0, wgsl:214)."""
    q = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    a = torch.full(q.shape[:-1] + (1,), int(round(alpha * 255.0)), dtype=torch.uint8, device=q.device)
    return torch.cat([q, a], dim=-1)
