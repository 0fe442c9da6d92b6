"""Geodesic integrators (PyTorch port of bhr_tpu/ops/geodesic.py).

This slice carries semi-implicit Euler, the reference shader's integrator
(reference: src/ray_tracer_euler.wgsl:80-85), in two forms:

* `euler_step`: the oracle's literal operation order, which the exact tier
  of the CUDA kernel reproduces bit for bit;
* `euler_step_folded`: the fast tier's folded two-coefficient update
  (bhr_tpu/ops/pallas_trace.py `physics_substep`), computed here with
  correctly rounded operations where the kernel uses approximate ones.

rk4, leapfrog and adaptive stepping are not ported yet (ROADMAP queue A,
item 6).
"""

from __future__ import annotations

import torch

from ..core.math import dot, rsqrt
from ..models import flat, schwarzschild

MODELS = {"schwarzschild": schwarzschild, "flat": flat}


def model_acceleration(model: str):
    """Unified accel(rel, vel, r, rs, spin) for a named spacetime model."""
    if model == "schwarzschild":
        return lambda rel, vel, r, rs, spin: schwarzschild.acceleration(rel, vel, r, rs)
    if model == "flat":
        return flat.acceleration
    raise NotImplementedError(
        f"spacetime model {model!r} is not ported yet (ROADMAP queue A, "
        "item 9 for kerr/kerr_lt); have schwarzschild, flat"
    )


def model_capture_radius(model: str, rs, spin):
    if model not in MODELS:
        model_acceleration(model)  # raises NotImplementedError, naming the ROADMAP item
    return MODELS[model].capture_radius(rs, spin)


def euler_step(accel_fn, rel, vel, r, rs, spin, dt):
    """Semi-implicit (symplectic) Euler step (reference: wgsl:80-85).

    v' = v + a(p, v) dt ; p' = p + v' dt  -- the position update uses the
    *new* velocity, matching the shader's order exactly.
    """
    a = accel_fn(rel, vel, r, rs, spin)
    new_vel = vel + a * dt
    new_rel = rel + new_vel * dt
    return new_rel, new_vel


def euler_step_folded(rel, vel, rs, dt):
    """The fast tier's Schwarzschild Euler step, folded into two
    coefficients: v' = v*b1 + rel*b2, p' = rel + v' dt, then v' made unit.

    Mirrors bhr_tpu/ops/pallas_trace.py `physics_substep` (including the
    one_m >= 0.02 clamp, which only ever touches rays about to be captured)
    with exact 1/sqrt and reciprocal in place of the kernel's approximate
    ones. Returns (new_rel, unit new_vel).
    """
    r2 = dot(rel, rel)
    inv_r = rsqrt(r2)
    c = dot(vel, rel)
    rs_inv_r = rs * inv_r
    one_m = torch.clamp_min(1.0 - rs_inv_r, 0.02)
    factor_dt = (rs * torch.reciprocal(2.0 * r2 * one_m)) * dt
    b1 = 1.0 - factor_dt * one_m
    b2 = factor_dt * (1.0 + rs_inv_r) * c * (inv_r * inv_r)
    nv = vel * b1[..., None] + rel * b2[..., None]
    new_rel = rel + nv * dt
    return new_rel, nv * rsqrt(dot(nv, nv))[..., None]


STEP_FNS = {"euler": euler_step}
