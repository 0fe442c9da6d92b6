"""Geodesic integrators (PyTorch port of bhr_tpu/ops/geodesic.py).

Each integrator comes in two forms, one per math tier of the CUDA kernels:

* the oracle's literal operation order (`euler_step`, `rk4_step`,
  `leapfrog_step`, `adaptive_dt`), which the exact tier reproduces bit for
  bit (reference: src/ray_tracer_euler.wgsl:80-85; docs/ROADMAP.md:155-231);
* the fast tier's folded forms (`euler_step_folded`, `sl_rk4`,
  `sl_leapfrog`; bhr_tpu/ops/pallas_trace.py `physics_substep`, `sl_deriv`,
  `sl_rk4`, `sl_leapfrog`), computed here with correctly rounded operations
  where the kernel uses approximate ones. Each returns a unit velocity.

In flat spacetime every fast form is a straight line. Given `spin`, the
fast forms add the Lense-Thirring drag of model "kerr_lt". The exact Kerr
model ("kerr") has no acceleration form: ops/trace.py integrates it in
Hamiltonian form (models/kerr_schild.py).
"""

from __future__ import annotations

import torch

from ..core.math import cross, dot, rsqrt, sqrt_rn
from ..models import flat, kerr, kerr_schild, schwarzschild

MODELS = {
    "schwarzschild": schwarzschild,
    "kerr": kerr_schild,  # exact Kerr-Schild Hamiltonian geodesics
    "kerr_lt": kerr,  # the Lense-Thirring approximation
    "flat": flat,
}
INTEGRATORS = ("euler", "rk4", "leapfrog")


def model_acceleration(model: str):
    """Unified accel(rel, vel, r, rs, spin) for a named spacetime model."""
    if model == "schwarzschild":
        return lambda rel, vel, r, rs, spin: schwarzschild.acceleration(rel, vel, r, rs)
    if model == "kerr_lt":
        return kerr.acceleration
    if model == "flat":
        return flat.acceleration
    if model == "kerr":
        raise ValueError(
            "model 'kerr' is Hamiltonian (Kerr-Schild); it has no acceleration form -- "
            "ops/trace.py integrates it on its own path"
        )
    if model == "custom":
        raise ValueError(
            "plugin physics (model='custom') has no named acceleration: "
            "ops/trace.custom_accel_arrays adapts TraceConfig.custom_accel"
        )
    raise ValueError(f"unknown spacetime model {model!r}; have {sorted(MODELS)}")


def model_capture_radius(model: str, rs, spin):
    if model not in MODELS:
        model_acceleration(model)  # raises
    return MODELS[model].capture_radius(rs, spin)


def _bcast_dt(dt, rel):
    """A per-ray dt (...,) gains the component axis; a scalar stays one."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=rel.device)
    if dt.ndim == rel.ndim - 1:
        dt = dt[..., None]
    return dt


def _radius_guard(rs):
    """1.0001 * max(rs, 1e-6): substep radii are held off r = rs."""
    return 1.0001 * torch.clamp_min(rs, 1e-6)


def euler_step(accel_fn, rel, vel, r, rs, spin, dt):
    """Semi-implicit (symplectic) Euler step (reference: wgsl:80-85).

    v' = v + a(p, v) dt ; p' = p + v' dt  -- the position update uses the
    *new* velocity, matching the shader's order exactly.
    """
    a = accel_fn(rel, vel, r, rs, spin)
    dt = _bcast_dt(dt, rel)
    new_vel = vel + a * dt
    new_rel = rel + new_vel * dt
    return new_rel, new_vel


def rk4_step(accel_fn, rel, vel, r, rs, spin, dt):
    """Classic RK4 on state (pos, vel) (reference: docs/ROADMAP.md:169-176).

    Substep radii are guarded away from the coordinate singularity at r = rs.
    """
    del r  # recomputed per substep
    dt = _bcast_dt(dt, rel)
    guard = _radius_guard(rs)

    def deriv(p, v):
        rr = torch.maximum(sqrt_rn(dot(p, p)), guard)
        return v, accel_fn(p, v, rr, rs, spin)

    k1p, k1v = deriv(rel, vel)
    k2p, k2v = deriv(rel + 0.5 * dt * k1p, vel + 0.5 * dt * k1v)
    k3p, k3v = deriv(rel + 0.5 * dt * k2p, vel + 0.5 * dt * k2v)
    k4p, k4v = deriv(rel + dt * k3p, vel + dt * k3v)
    sixth = dt * (1.0 / 6.0)
    new_rel = rel + sixth * (k1p + 2.0 * k2p + 2.0 * k3p + k4p)
    new_vel = vel + sixth * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return new_rel, new_vel


def leapfrog_step(accel_fn, rel, vel, r, rs, spin, dt):
    """Kick-drift-kick leapfrog with one fixed-point corrector on the final
    kick (docs/ROADMAP.md:179-190):

    v_half = v + a(p, v) dt/2 ; p' = p + v_half dt ;
    v' = v_half + a(p', v*) dt/2,  v* = v_half + a(p', v_half) dt/2.
    """
    dt = _bcast_dt(dt, rel)
    half = 0.5 * dt
    a1 = accel_fn(rel, vel, r, rs, spin)
    v_half = vel + a1 * half
    new_rel = rel + v_half * dt
    rr = torch.maximum(sqrt_rn(dot(new_rel, new_rel)), _radius_guard(rs))
    a2a = accel_fn(new_rel, v_half, rr, rs, spin)
    v_pred = v_half + a2a * half
    a2 = accel_fn(new_rel, v_pred, rr, rs, spin)
    new_vel = v_half + a2 * half
    return new_rel, new_vel


STEP_FNS = {"euler": euler_step, "rk4": rk4_step, "leapfrog": leapfrog_step}


def adaptive_dt(r, rs, base_dt, k=0.1, lo=0.01, hi=1.0):
    """dt = base_dt * clamp((r - rs) * k, lo, hi) (docs/ROADMAP.md:195-201):
    small careful steps near the horizon, long strides far away."""
    return base_dt * torch.clamp((r - rs) * k, lo, hi)


# ---- the fast tier's folded forms -------------------------------------------


def _lt_field(p, inv_r, rs, spin):
    """The fast tier's Lense-Thirring field B_g at p, folded as
    pallas_trace.py writes it (:486-496, :821-831): j inv_r^3 (3 jr p_i
    inv_r - J_hat_i) with jr = p_y inv_r, j = a* M^2."""
    mm = rs * 0.5
    j = spin * mm * mm
    inv_r3 = inv_r * inv_r * inv_r
    jr = p[..., 1] * inv_r
    c = j * inv_r3
    return torch.stack([c * (3.0 * jr * p[..., 0] * inv_r),
                        c * (3.0 * jr * p[..., 1] * inv_r - 1.0),
                        c * (3.0 * jr * p[..., 2] * inv_r)], dim=-1)


def euler_step_folded(rel, vel, rs, dt, flat_model=False, *, spin=None):
    """The fast tier's Euler step, folded into two coefficients:
    v' = v*b1 + rel*b2, p' = rel + v' dt, then v' made unit.

    Mirrors pallas_trace.py `physics_substep` with exact 1/sqrt and
    reciprocal in place of the kernel's approximate ones. In flat spacetime
    v' = v. Without `spin` (Schwarzschild) one_m is clamped at 0.02, which
    only ever touches rays about to be captured; with `spin` (kerr_lt) it
    is not -- the Kerr capture radius lies inside r_s, so live rays reach
    one_m < 0 -- and the Lense-Thirring drag of the pre-step velocity,
    scaled by dt, is added to v' (:821-831). Returns (new_rel, unit
    new_vel).
    """
    dt = torch.as_tensor(dt, dtype=torch.float32, device=rel.device)
    if flat_model:
        nv = vel
    else:
        r2 = dot(rel, rel)
        inv_r = rsqrt(r2)
        c = dot(vel, rel)
        rs_inv_r = rs * inv_r
        one_m = 1.0 - rs_inv_r
        if spin is None:
            one_m = torch.clamp_min(one_m, 0.02)
        factor_dt = (rs * torch.reciprocal(2.0 * r2 * one_m)) * dt  # dt: () or per ray
        b1 = 1.0 - factor_dt * one_m
        b2 = factor_dt * (1.0 + rs_inv_r) * c * (inv_r * inv_r)
        nv = vel * b1[..., None] + rel * b2[..., None]
        if spin is not None:
            nv = nv + cross(vel, _lt_field(rel, inv_r, rs, spin)) * _bcast_dt(dt, rel)
    new_rel = rel + nv * _bcast_dt(dt, rel)
    return new_rel, nv * rsqrt(dot(nv, nv))[..., None]


def sl_deriv(p, v, rs, spin=None):
    """The fast tier's folded acceleration a = p*a2 - v*a1, with one_m
    clamped at 0.02 (substeps may probe just inside the horizon for rays
    about to be captured) (pallas_trace.py:469-497); with `spin`, plus the
    Lense-Thirring drag v x B_g of kerr_lt, clamped all the same."""
    rr2 = dot(p, p)
    inv_rr = rsqrt(rr2)
    rs_inv = rs * inv_rr
    one_m = torch.clamp_min(1.0 - rs_inv, 0.02)
    factor = rs * torch.reciprocal(2.0 * rr2 * one_m)
    c = dot(v, p)
    a1 = factor * one_m
    a2 = factor * (1.0 + rs_inv) * c * (inv_rr * inv_rr)
    a = p * a2[..., None] - v * a1[..., None]
    if spin is not None:
        a = a + cross(v, _lt_field(p, inv_rr, rs, spin))
    return a


def sl_rk4(rel, vel, rs, dt, flat_model=False, *, spin=None):
    """The fast tier's RK4 on (rel, vel) (pallas_trace.py:499-530), ending
    in an rsqrt renormalisation; a straight line in flat spacetime. `spin`
    adds kerr_lt's drag (sl_deriv)."""
    dt = _bcast_dt(dt, rel)
    if flat_model:
        return rel + vel * dt, vel
    half = 0.5 * dt
    k1v = sl_deriv(rel, vel, rs, spin)
    p2 = rel + vel * half
    v2 = vel + k1v * half
    k2v = sl_deriv(p2, v2, rs, spin)
    p3 = rel + v2 * half
    v3 = vel + k2v * half
    k3v = sl_deriv(p3, v3, rs, spin)
    p4 = rel + v3 * dt
    v4 = vel + k3v * dt
    k4v = sl_deriv(p4, v4, rs, spin)
    sixth = dt * (1.0 / 6.0)
    kp = vel + 2.0 * (v2 + v3) + v4
    kv = k1v + 2.0 * (k2v + k3v) + k4v
    new_rel = rel + kp * sixth
    nv = vel + kv * sixth
    return new_rel, nv * rsqrt(dot(nv, nv))[..., None]


def sl_leapfrog(rel, vel, rs, dt, flat_model=False, *, spin=None):
    """The fast tier's corrected kick-drift-kick (pallas_trace.py:532-546),
    ending in an rsqrt renormalisation; a straight line in flat spacetime.
    `spin` adds kerr_lt's drag (sl_deriv)."""
    dt = _bcast_dt(dt, rel)
    if flat_model:
        return rel + vel * dt, vel
    half = 0.5 * dt
    a1 = sl_deriv(rel, vel, rs, spin)
    vh = vel + a1 * half
    new_rel = rel + vh * dt
    a2a = sl_deriv(new_rel, vh, rs, spin)
    vp = vh + a2a * half
    a2 = sl_deriv(new_rel, vp, rs, spin)
    nv = vh + a2 * half
    return new_rel, nv * rsqrt(dot(nv, nv))[..., None]


FAST_STEP_FNS = {"euler": euler_step_folded, "rk4": sl_rk4, "leapfrog": sl_leapfrog}
