"""Lense-Thirring Kerr approximation, registered as model "kerr_lt"
(PyTorch port of bhr_tpu/models/kerr.py).

The Schwarzschild radial term plus a Lense-Thirring (gravito-magnetic)
frame-dragging term, with the spin-dependent horizon radius. Geometric
units with r_s = 2M; the spin a* = a/M lies in [0, 1) and its axis is +Y,
so the XZ plane of the orbit and the disk is equatorial. The exact Kerr
model is models/kerr_schild.py ("kerr").
"""

from __future__ import annotations

import torch

from ..core.math import cross, sqrt_rn
from . import schwarzschild

SPIN_AXIS = (0.0, 1.0, 0.0)


def horizon_radius(rs, spin):
    """Outer event horizon r_+ = M (1 + sqrt(1 - a*^2)), with M = rs/2 and
    the spin clipped to [0, 0.999]."""
    m = rs * 0.5
    a = torch.clamp(torch.as_tensor(spin, dtype=torch.float32), 0.0, 0.999)
    return m * (1.0 + sqrt_rn(1.0 - a * a))


def capture_radius(rs, spin=0.0):
    """Capture at 1.05 r_+ (the safety factor of wgsl:62)."""
    return 1.05 * horizon_radius(rs, spin)


def acceleration(rel_pos, vel, r, rs, spin):
    """Schwarzschild acceleration + Lense-Thirring drag, in the oracle's
    operation order:

        B_g    = (j / (r r r)) (3 (J_hat . r_hat) r_hat - J_hat),  j = a* M^2
        a_drag = v x B_g

    With J_hat = +Y, J_hat . r_hat is r_hat's y component (the oracle's sum
    adds two zeros to it). `rs` and `spin` are tensors on the state's
    device, so every division divides by a device tensor.
    """
    a_schw = schwarzschild.acceleration(rel_pos, vel, r, rs)
    m = rs * 0.5
    j = spin * m * m
    r_ = r[..., None]
    r_hat = rel_pos / r_
    jdotr = r_hat[..., 1:2]
    j_hat = torch.tensor(SPIN_AXIS, dtype=torch.float32, device=rel_pos.device)
    b_g = (j / (r_ * r_ * r_)) * (3.0 * jdotr * r_hat - j_hat)
    return a_schw + cross(vel, b_g)
