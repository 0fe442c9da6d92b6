"""Plain reference of the geodesic frames: Schwarzschild null geodesics by
semi-implicit Euler or classic RK4, fixed or adaptive dt, the thin
accretion disk, the analytic star field, packed RGBA, in the exact tier
(the oracle's literal operations, correctly rounded, the 512-entry
blackbody table, rounding half to even) or the fast tier (the folded
integrators, the r^2 tests, the in-kernel disk with its 128-entry table,
rounding half up), each in exact operations.

A copy of the raytracer's plain PyTorch versions (trace_rays,
shade_image's epilogue and the monolithic kernel's shading), cut to what
the benchmark's geodesic configurations run. It imports no module of the
program. `render` with control=True computes the same frame in bfloat16,
the precision below the float32 that the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (
    F32,
    STATUS_CAPTURED,
    STATUS_DISK,
    STATUS_ESCAPED,
    STATUS_RUNNING,
    dot,
    generate_rays,
    on_device,
    pack_rgba8,
    rsqrt,
    sqrt_rn,
    star_field,
)

LUT_T_MIN, LUT_T_MAX = 1000.0, 30000.0
LUT_STEPS, KERNEL_LUT_STEPS = 512, 128


# ---- the exact tier's steps (the oracle's operation order) -------------------


def acceleration(rel, vel, r, rs):
    """wgsl:69-79: -factor (vel (1 - rs/r) - r_vec v_rad (1 + rs/r)),
    factor = rs / (2 r^2 (1 - rs/r))."""
    r = r[..., None]
    r_vec = rel / r
    v_rad = dot(vel, r_vec)[..., None]
    rs_over_r = rs / r
    factor = rs / (2.0 * r * r * (1.0 - rs_over_r))
    return -factor * (vel * (1.0 - rs_over_r) - r_vec * v_rad * (1.0 + rs_over_r))


def _bcast(dt, rel):
    return dt[..., None] if dt.ndim == rel.ndim - 1 else dt


def euler_step(rel, vel, r, rs, dt):
    a = acceleration(rel, vel, r, rs)
    dt = _bcast(dt, rel)
    new_vel = vel + a * dt
    return rel + new_vel * dt, new_vel


def rk4_step(rel, vel, r, rs, dt):
    dt = _bcast(dt, rel)
    guard = 1.0001 * torch.clamp_min(rs, 1e-6)

    def deriv(p, v):
        rr = torch.maximum(sqrt_rn(dot(p, p)), guard)
        return v, acceleration(p, v, rr, rs)

    k1p, k1v = deriv(rel, vel)
    k2p, k2v = deriv(rel + 0.5 * dt * k1p, vel + 0.5 * dt * k1v)
    k3p, k3v = deriv(rel + 0.5 * dt * k2p, vel + 0.5 * dt * k2v)
    k4p, k4v = deriv(rel + dt * k3p, vel + dt * k3v)
    sixth = dt * (1.0 / 6.0)
    return (rel + sixth * (k1p + 2.0 * k2p + 2.0 * k3p + k4p),
            vel + sixth * (k1v + 2.0 * k2v + 2.0 * k3v + k4v))


def adaptive_dt(r, rs, base_dt):
    """base_dt * clamp((r - rs) * 0.1, 0.01, 1)."""
    return base_dt * torch.clamp((r - rs) * 0.1, 0.01, 1.0)


# ---- the fast tier's folded steps --------------------------------------------


def euler_step_folded(rel, vel, rs, dt):
    """v' = v b1 + rel b2, p' = rel + v' dt, v' made unit by rsqrt; one_m
    clamped at 0.02."""
    r2 = dot(rel, rel)
    inv_r = rsqrt(r2)
    c = dot(vel, rel)
    rs_inv_r = rs * inv_r
    one_m = torch.clamp_min(1.0 - rs_inv_r, 0.02)
    factor_dt = (rs * torch.reciprocal(2.0 * r2 * one_m)) * dt
    b1 = 1.0 - factor_dt * one_m
    b2 = factor_dt * (1.0 + rs_inv_r) * c * (inv_r * inv_r)
    nv = vel * b1[..., None] + rel * b2[..., None]
    new_rel = rel + nv * _bcast(dt, rel)
    return new_rel, nv * rsqrt(dot(nv, nv))[..., None]


def sl_deriv(p, v, rs):
    rr2 = dot(p, p)
    inv_rr = rsqrt(rr2)
    rs_inv = rs * inv_rr
    one_m = torch.clamp_min(1.0 - rs_inv, 0.02)
    factor = rs * torch.reciprocal(2.0 * rr2 * one_m)
    c = dot(v, p)
    a1 = factor * one_m
    a2 = factor * (1.0 + rs_inv) * c * (inv_rr * inv_rr)
    return p * a2[..., None] - v * a1[..., None]


def sl_rk4(rel, vel, rs, dt):
    dt = _bcast(dt, rel)
    half = 0.5 * dt
    k1v = sl_deriv(rel, vel, rs)
    p2 = rel + vel * half
    v2 = vel + k1v * half
    k2v = sl_deriv(p2, v2, rs)
    p3 = rel + v2 * half
    v3 = vel + k2v * half
    k3v = sl_deriv(p3, v3, rs)
    p4 = rel + v3 * dt
    v4 = vel + k3v * dt
    k4v = sl_deriv(p4, v4, rs)
    sixth = dt * (1.0 / 6.0)
    kp = vel + 2.0 * (v2 + v3) + v4
    kv = k1v + 2.0 * (k2v + k3v) + k4v
    nv = vel + kv * sixth
    return rel + kp * sixth, nv * rsqrt(dot(nv, nv))[..., None]


EXACT_STEPS = {"euler": euler_step, "rk4": rk4_step}
FAST_STEPS = {"euler": euler_step_folded, "rk4": sl_rk4}


# ---- the disk ----------------------------------------------------------------


def intersect_equatorial(old, new, r_isco, r_outer):
    oy, ny = old[..., 1], new[..., 1]
    crosses = oy * ny < 0.0
    denom = ny - oy
    t = -oy / torch.where(crosses, denom, torch.ones_like(denom))
    hit_pos = old + t[..., None] * (new - old)
    r = sqrt_rn(dot(hit_pos, hit_pos))
    return crosses & (r >= r_isco) & (r <= r_outer), hit_pos


def intersect_equatorial_fast(old, new, r_isco, r_outer):
    oy, ny = old[..., 1], new[..., 1]
    crosses = oy * ny < 0.0
    den = torch.where(crosses, ny - oy, torch.ones_like(ny))
    tt = -oy * torch.reciprocal(den)
    hx = old[..., 0] + tt * (new[..., 0] - old[..., 0])
    hz = old[..., 2] + tt * (new[..., 2] - old[..., 2])
    hr2 = hx * hx + hz * hz
    hit = crosses & (hr2 >= r_isco * r_isco) & (hr2 <= r_outer * r_outer)
    return hit, torch.stack([hx, torch.zeros_like(hx), hz], dim=-1)


def blackbody_lut_np(steps: int) -> np.ndarray:
    """(steps, 3) linear-sRGB blackbody colours over [1000, 30000] K: Planck
    -> CIE XYZ (Wyman-Sloan-Shirley fit) -> linear sRGB, clipped at 0, each
    normalised to its largest channel."""
    wl = np.linspace(380e-9, 780e-9, 200)
    wl_nm = wl * 1e9

    def g(x, mu, s1, s2):
        t = (x - mu) / np.where(x < mu, s1, s2)
        return np.exp(-0.5 * t * t)

    xbar = (1.056 * g(wl_nm, 599.8, 37.9, 31.0) + 0.362 * g(wl_nm, 442.0, 16.0, 26.7)
            - 0.065 * g(wl_nm, 501.1, 20.4, 26.2))
    ybar = 0.821 * g(wl_nm, 568.8, 46.9, 40.5) + 0.286 * g(wl_nm, 530.9, 16.3, 31.1)
    zbar = 1.217 * g(wl_nm, 437.0, 11.8, 36.0) + 0.681 * g(wl_nm, 459.0, 26.0, 13.8)
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    temps = np.linspace(LUT_T_MIN, LUT_T_MAX, steps)
    with np.errstate(over="ignore"):
        b = (2 * h * c**2 / wl**5) / (np.expm1(h * c / (wl * kb * temps[:, None])))
    xyz = np.stack([b @ xbar, b @ ybar, b @ zbar], axis=-1)
    m = np.array([[3.2406, -1.5372, -0.4986], [-0.9689, 1.8758, 0.0415],
                  [0.0557, -0.2040, 1.0570]])
    rgb = np.clip(xyz @ m.T, 0.0, None)
    return (rgb / np.maximum(rgb.max(axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def disk_emission(hit, ray_dir, observer_r, rs, r_isco, r_outer, t_isco, lut):
    """The exact tier's observed disk colour: Keplerian Doppler x
    gravitational g, T = T_isco (r / r_isco)^-3/4 / g, the blackbody table
    lerped, I = I_emit / g^3 (T / T_isco)^2 with the outer edge faded."""
    dev, dtype = hit.device, hit.dtype
    r_disk = sqrt_rn(dot(hit, hit))
    # Keplerian velocity: beta = sqrt(M / r) (clipped), tangent (z, 0, -x)
    rk = r_disk[..., None]
    beta_k = sqrt_rn(torch.clamp(rs * 0.5 / rk, 0.0, 0.81))
    x, z = hit[..., 0:1], hit[..., 2:3]
    tangent = torch.cat([z, torch.zeros_like(x), -x], dim=-1)
    tangent = tangent / torch.clamp_min(sqrt_rn(dot(tangent, tangent))[..., None], 1e-20)
    v = beta_k * tangent
    beta = sqrt_rn(dot(v, v))
    v_hat = v / torch.clamp_min(beta[..., None], 1e-20)
    d = ray_dir / sqrt_rn(dot(ray_dir, ray_dir))[..., None]
    doppler = (1.0 - beta * dot(v_hat, d)) / sqrt_rn(1.0 - beta * beta)
    grav_emit = sqrt_rn(torch.clamp(1.0 - rs / torch.maximum(r_disk, 1.001 * rs), 1e-4, 1.0))
    grav_obs = sqrt_rn(torch.clamp(1.0 - rs / torch.maximum(observer_r, 1.001 * rs), 1e-4, 1.0))
    g = torch.clamp_min(doppler * (grav_emit / grav_obs), 1e-3)
    t_obs = t_isco * torch.pow(torch.clamp_min(r_disk / r_isco, 1e-6), -0.75) / g
    steps = lut.shape[0]
    xl = (t_obs - LUT_T_MIN) / on_device(LUT_T_MAX - LUT_T_MIN, dev, dtype) * (steps - 1)
    xl = torch.clamp(xl, 0.0, steps - 1.0)
    # the index clamped again as an integer: in bfloat16 (the control) the
    # clamp's steps - 1 rounds up to steps; in float32 this changes nothing
    i0 = torch.clamp(torch.floor(xl).to(torch.int64), 0, steps - 1)
    i1 = torch.clamp_max(i0 + 1, steps - 1)
    f = (xl - i0.to(dtype))[..., None]
    color = lut[i0] * (1.0 - f) + lut[i1] * f
    beaming = 1.0 / (g * g * g)
    edge = torch.clamp((r_outer - r_disk) / (r_outer - r_isco), 0.0, 1.0)
    rel_t = t_obs / on_device(10000.0, dev, dtype)
    return color * torch.clamp(beaming * (rel_t * rel_t) * edge, 0.0, 4.0)[..., None]


def shade_disk_fast(hx, hz, vel, rs, r_isco, r_outer, t_isco, observer_r, lut):
    """The fast tier's in-kernel disk: the same physics folded (rsqrt,
    reciprocals), T ~ r^-3/4 as rsqrt(x) rsqrt(sqrt(x)), the channel-major
    128-entry table read by an indexed lerp."""
    dr2 = hx * hx + hz * hz
    inv_dr = rsqrt(torch.clamp_min(dr2, 1e-12))
    dr = dr2 * inv_dr
    beta2 = torch.clamp(rs * 0.5 * inv_dr, 0.0, 0.81)
    beta = sqrt_rn(beta2)
    cos_t = (hz * vel[..., 0] - hx * vel[..., 2]) * inv_dr
    doppler = (1.0 - beta * cos_t) * rsqrt(1.0 - beta2)
    grav_emit = sqrt_rn(torch.clamp(
        1.0 - rs * torch.reciprocal(torch.maximum(dr, 1.001 * rs)), 1e-4, 1.0))
    grav_obs = sqrt_rn(torch.clamp(1.0 - rs / torch.maximum(observer_r, 1.001 * rs), 1e-4, 1.0))
    inv_g = torch.reciprocal(torch.clamp_min(doppler * (grav_emit / grav_obs), 1e-3))
    x = torch.clamp_min(dr * (1.0 / r_isco), 1e-6)
    t_obs = t_isco * (rsqrt(x) * rsqrt(sqrt_rn(x))) * inv_g
    rel_t = t_obs * (1.0 / 10000.0)
    edge = torch.clamp((r_outer - dr) * (1.0 / (r_outer - r_isco)), 0.0, 1.0)
    intensity = torch.clamp(inv_g * inv_g * inv_g * rel_t * rel_t * edge, 0.0, 4.0)
    n = lut.shape[0] // 3
    t_cl = torch.clamp((t_obs - LUT_T_MIN) * ((n - 1) / (LUT_T_MAX - LUT_T_MIN)), 0.0,
                       float(n - 1))
    i0f = torch.floor(t_cl)
    frac = t_cl - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    return tuple((lut[c * n + i0] + frac * (lut[c * n + i1] - lut[c * n + i0])) * intensity
                 for c in range(3))


# ---- the frame ---------------------------------------------------------------


def trace(origins, dirs, scene: dict, renderer: dict, trace_c: dict, *, fast: bool):
    """Integrate every ray to termination -> (final rel position, unit
    direction, status, steps). Rays are updated under a mask until none
    is running or max_steps is spent (wgsl:138-171)."""
    dev, dtype = dirs.device, dirs.dtype
    rs = on_device(scene["schwarzschild_radius"], dev, dtype)
    bh = on_device(scene["black_hole_position"], dev, dtype)
    base_dt = on_device(renderer["dt"], dev, dtype)
    escape_r = on_device(trace_c["escape_radius"], dev, dtype)
    r_capture = rs * trace_c["capture_factor"]
    esc2, cap2 = escape_r * escape_r, r_capture * r_capture
    r_isco = trace_c["disk_r_isco_factor"] * rs
    r_outer = trace_c["disk_r_outer_factor"] * rs
    integ, adaptive, disk = renderer["integrator"], renderer["adaptive"], renderer["disk"]
    pos = origins
    vel = dirs / sqrt_rn(dot(dirs, dirs))[..., None]
    shape = pos.shape[:-1]
    status = torch.zeros(shape, dtype=torch.int32, device=dev)
    steps = torch.zeros(shape, dtype=torch.int32, device=dev)
    i = 0
    while i < scene["max_steps"] and bool((status == STATUS_RUNNING).any()):
        active = status == STATUS_RUNNING
        rel = pos - bh
        r2 = dot(rel, rel)
        dist = sqrt_rn(r2)
        steps = torch.where(active, i + 1, steps)
        if fast:
            escaped = active & (r2 > esc2)
            captured = active & ~escaped & (r2 < cap2)
        else:
            escaped = active & (dist > escape_r)
            captured = active & ~escaped & (dist < r_capture)
        stepping = active & ~escaped & ~captured
        dt = base_dt
        if adaptive:
            dt = adaptive_dt(r2 * rsqrt(r2) if fast else dist, rs, base_dt)
        if fast:
            new_rel, new_vel = FAST_STEPS[integ](rel, vel, rs, dt)
        else:
            new_rel, new_vel = EXACT_STEPS[integ](rel, vel, dist, rs, dt)
            # torch.sqrt, as the raytracer's plain version takes this one root
            # (correctly rounded on CUDA)
            new_vel = new_vel / torch.sqrt(dot(new_vel, new_vel))[..., None]
        new_pos = new_rel + bh
        if disk:
            hit, hit_rel = (intersect_equatorial_fast if fast else intersect_equatorial)(
                rel, new_rel, r_isco, r_outer)
            hit = hit & stepping
            hit_rel = torch.stack([hit_rel[..., 0], torch.zeros_like(hit_rel[..., 1]),
                                   hit_rel[..., 2]], dim=-1)
            new_pos = torch.where(hit[..., None], hit_rel + bh, new_pos)
            status = torch.where(hit, STATUS_DISK, status)
        m3 = stepping[..., None]
        pos = torch.where(m3, new_pos, pos)
        vel = torch.where(m3, new_vel, vel)
        status = torch.where(escaped, STATUS_ESCAPED, status)
        status = torch.where(captured, STATUS_CAPTURED, status)
        i += 1
    return pos - bh, vel, status, steps


def render(cell, camera, *, seed: int, device, control: bool = False, rows=None):
    """The packed int32 frame (or the band of `rows`) of `camera` and the
    rays' step counts. `cell` carries the configuration ("scene",
    "renderer", "trace") and the traffic's tier (its renderer's "fast_math")."""
    dtype = torch.bfloat16 if control else F32
    scene, renderer, trace_c = cell.config["scene"], cell.config["renderer"], cell.config["trace"]
    fast = bool(cell.traffic.get("renderer", {}).get("fast_math", False))
    origins, dirs = generate_rays(camera, scene["width"], scene["height"], scene["fov"], device,
                                  dtype, rows)
    hit, vel, status, steps = trace(origins, dirs, scene, renderer, trace_c, fast=fast)
    r, g, b = star_field(vel[..., 0], vel[..., 1], vel[..., 2], seed)
    if renderer["disk"]:
        rs = on_device(scene["schwarzschild_radius"], device, dtype)
        to_cam = (on_device(camera.position, device, dtype)
                  - on_device(scene["black_hole_position"], device, dtype))
        obs_r = sqrt_rn(dot(to_cam, to_cam))
        r_isco = trace_c["disk_r_isco_factor"] * rs
        r_outer = trace_c["disk_r_outer_factor"] * rs
        t_isco = on_device(trace_c["t_isco"], device, dtype)
        if fast:
            lut = torch.from_numpy(np.ascontiguousarray(
                blackbody_lut_np(KERNEL_LUT_STEPS).T.reshape(-1))).to(device, dtype)
            disk = shade_disk_fast(hit[..., 0], hit[..., 2], vel, rs, r_isco, r_outer, t_isco,
                                   obs_r, lut)
        else:
            lut = torch.from_numpy(blackbody_lut_np(LUT_STEPS)).to(device, dtype)
            em = disk_emission(hit, vel, obs_r, rs, r_isco, r_outer, t_isco, lut)
            disk = (em[..., 0], em[..., 1], em[..., 2])
        on_disk = status == STATUS_DISK
        r, g, b = (torch.where(on_disk, d, c) for d, c in zip(disk, (r, g, b)))
    captured = status == STATUS_CAPTURED
    zero = torch.zeros((), dtype=dtype, device=device)
    r, g, b = (torch.where(captured, zero, c) for c in (r, g, b))
    return pack_rgba8(r, g, b, half_up=fast), steps
