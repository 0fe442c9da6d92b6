"""Schwarzschild spacetime model (PyTorch port of
bhr_tpu/models/schwarzschild.py; reference: src/ray_tracer_euler.wgsl:34-41
metric terms, wgsl:51-90 approximate null-geodesic acceleration).
"""

from __future__ import annotations

from ..core.math import dot


def g_tt(r, rs):
    """Schwarzschild metric tt component (reference: wgsl:34-36)."""
    return -(1.0 - rs / r)


def g_rr(r, rs):
    """Schwarzschild metric rr component (reference: wgsl:39-41)."""
    return 1.0 / (1.0 - rs / r)


def acceleration(rel_pos, vel, r, rs):
    """Approximate null-geodesic acceleration in Cartesian coordinates.

    Matches the shader formula and its operation order exactly
    (reference: wgsl:69-79):
        r_vec  = pos / r
        v_rad  = dot(vel, r_vec)
        factor = rs / (2 r^2 (1 - rs/r))
        accel  = -factor * (vel*(1 - rs/r) - r_vec*v_rad*(1 + rs/r))

    `rel_pos`/`vel` are (..., 3); `r` is (...,) and `rs` a tensor on the
    same device. Caller guarantees r > capture radius.
    """
    r = r[..., None]
    r_vec = rel_pos / r
    v_rad = dot(vel, r_vec)[..., None]
    rs_over_r = rs / r
    factor = rs / (2.0 * r * r * (1.0 - rs_over_r))
    return -factor * (vel * (1.0 - rs_over_r) - r_vec * v_rad * (1.0 + rs_over_r))


def capture_radius(rs, spin=0.0):
    """Radius below which a ray is captured: 1.05 r_s (reference: wgsl:62).
    `spin` is accepted for interface parity and ignored."""
    del spin
    return 1.05 * rs
