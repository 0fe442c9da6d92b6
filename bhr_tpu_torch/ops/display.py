"""Display stage: the tonemaps applied between shading and quantization
(PyTorch port of bhr_tpu/ops/display.py; reference: src/display.wgsl:12-29).

`Vertex`/`QUAD_VERTICES` are provided for API parity with the reference
library exports (reference: src/lib.rs:79-112); they are plain data.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Vertex:
    """Fullscreen-quad vertex (reference: src/lib.rs:79-96). Data-only."""

    position: tuple[float, float]


# Triangle-strip fullscreen quad (reference: src/lib.rs:99-112).
QUAD_VERTICES = (
    Vertex((-1.0, -1.0)),
    Vertex((1.0, -1.0)),
    Vertex((-1.0, 1.0)),
    Vertex((1.0, 1.0)),
)


def passthrough(color: torch.Tensor) -> torch.Tensor:
    """Identity display transform (reference display.wgsl behavior)."""
    return color


def reinhard(color: torch.Tensor) -> torch.Tensor:
    """Reinhard x / (1 + x) (the EXR loader's operator, lib.rs:295)."""
    return color / (1.0 + color)


def srgb_encode(color: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer function (reference: src/main.rs:346-351)."""
    c = torch.clamp(color, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


TONEMAPS = {
    "passthrough": passthrough,
    "reinhard": reinhard,
    "srgb": srgb_encode,
}
