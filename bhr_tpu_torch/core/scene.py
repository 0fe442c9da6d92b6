"""Scene parameter data model (PyTorch port of bhr_tpu/core/scene.py).

The continuously varying quantities (black-hole position, Schwarzschild
radius, fov, spin) are fp32 tensors; image size, max_steps and the debug
mode are plain ints. Scene tensors live on the host by default: the CUDA
kernel takes them by value as kernel parameters (ops/trace_kernel.py), and
the plain version moves them to its device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Workload-defining constants of the reference integrator
# (reference: wgsl:142 dt, wgsl:154 escape radius, wgsl:62 capture factor).
DEFAULT_DT = 0.1
ESCAPE_RADIUS = 100.0
CAPTURE_FACTOR = 1.05

# Debug modes (reference: wgsl:23, 204-211).
DEBUG_NONE = 0
DEBUG_STEPS = 1

_TENSOR_FIELDS = ("black_hole_position", "schwarzschild_radius", "fov", "spin")


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Scene configuration.

    Defaults mirror the reference library defaults
    (reference: src/lib.rs:360-370): r_s = 2.0, fov = pi/3, max_steps = 500.
    Tensor fields also accept Python numbers or sequences, which are
    converted to fp32 tensors on the CPU.
    """

    black_hole_position: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(3, dtype=torch.float32)
    )
    schwarzschild_radius: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(2.0, dtype=torch.float32)
    )
    fov: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(math.pi / 3.0, dtype=torch.float32)
    )
    # Kerr spin parameter a/M in [0, 1); 0.0 == Schwarzschild.
    spin: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0.0, dtype=torch.float32)
    )
    screen_width: int = 800
    screen_height: int = 600
    max_steps: int = 500
    debug_mode: int = DEBUG_NONE

    def __post_init__(self):
        for name in _TENSOR_FIELDS:
            value = torch.as_tensor(getattr(self, name), dtype=torch.float32)
            object.__setattr__(self, name, value)

    def replace(self, **kw) -> "SceneParams":
        return dataclasses.replace(self, **kw)

    @property
    def width(self) -> int:
        return self.screen_width

    @property
    def height(self) -> int:
        return self.screen_height
