"""Reference tracer: the plain PyTorch oracle of the geodesic loop
(PyTorch port of bhr_tpu/ops/trace.py:33-207).

The loop reproduces `trace_ray` (reference: src/ray_tracer_euler.wgsl:
138-171), extended as bhr_tpu extends it:

    for i in 0..max_steps:
        steps = i + 1
        rel = pos - bh;  dist = |rel|
        if dist > 100           -> escaped (background sampled with vel)
        if dist < 1.05 rs       -> captured (black)
        dt = base_dt, or adaptive_dt(dist) when config.adaptive
        step (euler | rk4 | leapfrog);  pos = rel' + bh;  vel = normalize(vel')
        if config.disk and the step crossed y = 0 inside the annulus
                                -> disk hit: pos = the hit point

Rays that exhaust max_steps sample the background with their current
velocity (wgsl:170). Every ray is updated under a mask, and the loop ends
when no ray is still running. This is the plain version the CUDA kernels
(ops/trace_kernel.py) are held against.

The exact Kerr model ("kerr") integrates the Hamiltonian state (q, p) of
models/kerr_schild.py on its own loop, `_trace_rays_kerr_schild`
(bhr_tpu/ops/trace.py:210-320); "kerr_lt" runs the loop above with the
Lense-Thirring acceleration of models/kerr.py; plugin physics ("custom")
runs it with the user's acceleration (`custom_accel_arrays`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import dot, rsqrt, sqrt_rn
from ..core.scene import CAPTURE_FACTOR, DEFAULT_DT, ESCAPE_RADIUS
from ..models import kerr_schild as ks
from ..models.disk import intersect_equatorial, intersect_equatorial_fast
from .geodesic import (
    FAST_STEP_FNS,
    MODELS,
    STEP_FNS,
    adaptive_dt,
    model_acceleration,
    model_capture_radius,
)

# Ray status codes.
STATUS_RUNNING = 0  # still integrating / exhausted max_steps -> background
STATUS_ESCAPED = 1  # |pos - bh| > escape_radius -> background
STATUS_CAPTURED = 2  # crossed the (padded) horizon -> black
STATUS_DISK = 3  # hit the accretion disk -> disk emission


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace configuration, with the same fields and defaults as
    bhr_tpu's TraceConfig (bhr_tpu/ops/trace.py:40-83). The port traces
    the euler, rk4 and leapfrog integrators with model "schwarzschild",
    "kerr", "kerr_lt", "flat" or "custom".

    model="custom" is plugin physics (utils/plugin.py): `custom_accel` is
    the user's acceleration(rel, vel, r, r2, rs, spin) -> (ax, ay, az) on
    component planes, and the capture radius is custom_capture_factor *
    rs. The configuration hashes the callable by identity."""

    integrator: str = "euler"  # "euler" | "rk4" | "leapfrog"
    model: str = "schwarzschild"  # "schwarzschild" | "kerr" | "kerr_lt" | "flat" | "custom"
    adaptive: bool = False  # adaptive step size (docs/ROADMAP.md:195-201)
    dt: float = DEFAULT_DT
    escape_radius: float = ESCAPE_RADIUS
    disk: bool = False  # equatorial thin accretion disk
    disk_r_isco_factor: float = 3.0  # in units of r_s
    disk_r_outer_factor: float = 10.0
    custom_accel: object = None
    custom_capture_factor: float = float(CAPTURE_FACTOR)

    def __post_init__(self):
        if self.model == "custom" and self.custom_accel is None:
            raise ValueError(
                "model='custom' needs custom_accel(rel, vel, r, r2, rs, spin)"
                " -> (ax, ay, az) on component-plane tuples"
            )


def custom_accel_arrays(config: TraceConfig):
    """The plugin's plane-form acceleration as accel(rel, vel, r, rs, spin)
    on (..., 3) state (bhr_tpu/ops/trace.py:86-105): r2 is r * r, and each
    component is broadcast to the rays' shape."""
    plug = config.custom_accel

    def accel_fn(rel, vel, r, rs, spin):
        out = plug((rel[..., 0], rel[..., 1], rel[..., 2]),
                   (vel[..., 0], vel[..., 1], vel[..., 2]), r, r * r, rs, spin)
        return torch.stack([torch.broadcast_to(torch.as_tensor(a, dtype=torch.float32,
                                                               device=rel.device),
                                               rel.shape[:-1]) for a in out], dim=-1)

    return accel_fn


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Per-pixel integration outputs over the pixel grid."""

    final_pos: torch.Tensor  # (..., 3) absolute position at termination
    final_vel: torch.Tensor  # (..., 3) unit direction at termination
    status: torch.Tensor  # (...,) int32 STATUS_*
    steps: torch.Tensor  # (...,) int32 steps taken (wgsl steps_taken)


def check_traceable(config: TraceConfig) -> None:
    """Raise NotImplementedError for a configuration this port cannot
    trace yet, naming the ROADMAP item that brings it."""
    if config.integrator not in STEP_FNS:
        raise NotImplementedError(
            f"integrator {config.integrator!r} is not ported yet "
            "(ROADMAP queue A, item 11: neural)"
        )
    if config.model not in MODELS and config.model != "custom":
        raise ValueError(f"unknown spacetime model {config.model!r}; have {sorted(MODELS)}")


def trace_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    bh_pos,
    rs,
    spin,
    max_steps: int,
    config: TraceConfig = TraceConfig(),
    *,
    fast_math: bool = False,
) -> TraceResult:
    """Integrate a batch of rays to termination, on the device of `origins`.

    origins/directions: fp32 (..., 3). bh_pos fp32[3]; rs/spin fp32 scalars.
    `fast_math=True` runs the fast tier's arithmetic in exact operations:
    termination tested on r^2 against escape^2 and capture^2, the adaptive
    radius taken as r^2 * rsqrt(r^2), the folded integrators of
    ops/geodesic.py, and the disk crossing tested in r^2 space
    (models/disk.intersect_equatorial_fast). Plugin physics has no folded
    form: bhr_tpu's kernel runs it on its generic body, where the fast
    tier changes the renormalisation alone (v * rsqrt(v.v),
    pallas_trace.py:318-321), so its fast tier is the exact loop with that
    renormalisation.

    A disk hit's final_pos is the hit point with its y set to the black
    hole's: the exact tier finds the hit as the oracle does
    (models/disk.intersect_equatorial), whose interpolated y lies within
    rounding of the plane.
    """
    check_traceable(config)
    device = origins.device
    f32 = torch.float32
    rs = torch.as_tensor(rs, dtype=f32).to(device)
    spin = torch.as_tensor(spin, dtype=f32).to(device)
    bh_pos = torch.as_tensor(bh_pos, dtype=f32).to(device)
    if config.model == "kerr":
        return _trace_rays_kerr_schild(origins, directions, bh_pos, rs, spin, max_steps, config,
                                       fast_math)
    flat_model = config.model == "flat"
    lt_spin = spin if config.model == "kerr_lt" else None
    custom = config.model == "custom"
    if custom:
        accel_fn = custom_accel_arrays(config)
        r_capture = rs * torch.tensor(config.custom_capture_factor, dtype=f32, device=device)
    elif config.model == "schwarzschild":
        accel_fn = model_acceleration(config.model)
        r_capture = rs * CAPTURE_FACTOR  # the literal wgsl:62 expression
    else:
        accel_fn = model_acceleration(config.model)
        r_capture = model_capture_radius(config.model, rs, spin)
    folded = fast_math and not custom  # the fast tier's folded loop
    escape_r = torch.tensor(config.escape_radius, dtype=f32, device=device)
    base_dt = torch.tensor(config.dt, dtype=f32, device=device)
    esc2 = escape_r * escape_r
    cap2 = r_capture * r_capture
    r_isco = config.disk_r_isco_factor * rs
    r_outer = config.disk_r_outer_factor * rs

    pos = origins.to(f32)
    d = directions.to(f32)
    vel = d / sqrt_rn(dot(d, d))[..., None]  # wgsl:140
    batch_shape = pos.shape[:-1]
    status = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    steps = torch.zeros(batch_shape, dtype=torch.int32, device=device)

    i = 0
    while i < max_steps and bool((status == STATUS_RUNNING).any()):
        active = status == STATUS_RUNNING
        rel = pos - bh_pos
        r2 = dot(rel, rel)
        dist = sqrt_rn(r2)
        # steps_taken = i + 1 for every ray still in the loop (wgsl:149)
        steps = torch.where(active, i + 1, steps)
        if folded:
            escaped = active & (r2 > esc2)
            captured = active & ~escaped & (r2 < cap2)
        else:
            escaped = active & (dist > escape_r)
            captured = active & ~escaped & (dist < r_capture)
        stepping = active & ~escaped & ~captured

        dt = base_dt
        if config.adaptive:
            dt = adaptive_dt(r2 * rsqrt(r2) if folded else dist, rs, base_dt)
        if folded:
            new_rel, new_vel_n = FAST_STEP_FNS[config.integrator](rel, vel, rs, dt, flat_model,
                                                                  spin=lt_spin)
        else:
            new_rel, new_vel = STEP_FNS[config.integrator](accel_fn, rel, vel, dist, rs, spin, dt)
            if fast_math:  # plugin physics' fast tier
                new_vel_n = new_vel * rsqrt(dot(new_vel, new_vel))[..., None]
            else:
                # torch.sqrt, the one root not taken by sqrt_rn (the same on
                # CUDA): on the CPU it is an ulp off on some inputs, and
                # sqrt_rn here moves one more pixel of test_torch_render's
                # 48x32 exact parity frame off bhr_tpu's, below its bar
                # (ROADMAP queue C)
                new_vel_n = new_vel / torch.sqrt(dot(new_vel, new_vel))[..., None]
        new_pos = new_rel + bh_pos

        if config.disk:
            intersect = intersect_equatorial_fast if folded else intersect_equatorial
            hit, hit_rel = intersect(rel, new_rel, r_isco, r_outer)
            hit = hit & stepping
            hit_rel = torch.stack(
                [hit_rel[..., 0], torch.zeros_like(hit_rel[..., 1]), hit_rel[..., 2]], dim=-1)
            new_pos = torch.where(hit[..., None], hit_rel + bh_pos, new_pos)
            status = torch.where(hit, STATUS_DISK, status)

        m3 = stepping[..., None]
        pos = torch.where(m3, new_pos, pos)
        vel = torch.where(m3, new_vel_n, vel)
        status = torch.where(escaped, STATUS_ESCAPED, status)
        status = torch.where(captured, STATUS_CAPTURED, status)
        i += 1
    return TraceResult(final_pos=pos, final_vel=vel, status=status, steps=steps)


def _trace_rays_kerr_schild(origins, directions, bh_pos, rs, spin, max_steps: int,
                            config: TraceConfig, fast_math: bool) -> TraceResult:
    """Exact Kerr null geodesics in Cartesian Kerr-Schild coordinates
    (bhr_tpu/ops/trace.py:210-320): the loop above on the Hamiltonian
    state (q, p) with E = -p_t = 1, escape tested on |q|, capture on the
    Kerr-Schild radius (the horizon lies at r_+ in KS r), adaptive dt on
    the KS radius, and the shading direction dq/dl taken from (q, p) after
    the loop.

    A disk hit stops at the oracle's interpolated hit point, whose y lies
    within rounding of the plane: the exact tier's direction is evaluated
    there, as the oracle's is, and final_pos takes the black hole's y. The
    fast tier (`fast_math=True`; pallas_trace.py:1005-1047, :1134-1146)
    tests escape on |q|^2 against esc^2 and capture on KS r^2 against
    cap^2, takes the adaptive radius as r^2 rsqrt(r^2), finds the hit with
    y = 0 (models/disk.intersect_equatorial_fast) and normalises the
    direction by rsqrt.
    """
    device = origins.device
    f32 = torch.float32
    r_capture = ks.capture_radius(rs, spin)
    escape_r = torch.tensor(config.escape_radius, dtype=f32, device=device)
    base_dt = torch.tensor(config.dt, dtype=f32, device=device)
    esc2 = escape_r * escape_r
    cap2 = r_capture * r_capture
    r_isco = config.disk_r_isco_factor * rs
    r_outer = config.disk_r_outer_factor * rs

    def derivs(q, p):
        return ks.derivs(q, p, rs, spin)

    def step_euler(q, p, dt):
        # semi-implicit: p first, then q with the updated p (wgsl:80-85)
        _, dp = derivs(q, p)
        p2 = p + dp * dt
        dq2, _ = derivs(q, p2)
        return q + dq2 * dt, p2

    def step_rk4(q, p, dt):
        k1q, k1p = derivs(q, p)
        k2q, k2p = derivs(q + 0.5 * dt * k1q, p + 0.5 * dt * k1p)
        k3q, k3p = derivs(q + 0.5 * dt * k2q, p + 0.5 * dt * k2p)
        k4q, k4p = derivs(q + dt * k3q, p + dt * k3p)
        sixth = dt * (1.0 / 6.0)
        return (q + sixth * (k1q + 2.0 * k2q + 2.0 * k3q + k4q),
                p + sixth * (k1p + 2.0 * k2p + 2.0 * k3p + k4p))

    def step_leapfrog(q, p, dt):
        # kick-drift-kick with a midpoint-corrected drift and a corrector on
        # the final kick: the KS Hamiltonian is not separable
        half = 0.5 * dt
        _, dp1 = derivs(q, p)
        ph = p + dp1 * half
        dq_a, _ = derivs(q, ph)
        q_mid = q + dq_a * half
        dq_b, _ = derivs(q_mid, ph)
        q2 = q + dq_b * dt
        _, dp2a = derivs(q2, ph)
        p_pred = ph + dp2a * half
        _, dp2 = derivs(q2, p_pred)
        return q2, ph + dp2 * half

    step = {"euler": step_euler, "rk4": step_rk4, "leapfrog": step_leapfrog}[config.integrator]

    q = origins.to(f32) - bh_pos
    d = directions.to(f32)
    d = d / sqrt_rn(dot(d, d))[..., None]
    p = ks.init_momentum(q, d, rs, spin)
    batch_shape = q.shape[:-1]
    status = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    steps = torch.zeros(batch_shape, dtype=torch.int32, device=device)

    i = 0
    while i < max_steps and bool((status == STATUS_RUNNING).any()):
        active = status == STATUS_RUNNING
        r2_ks, rho2 = ks.ks_r2(q, rs, spin)
        steps = torch.where(active, i + 1, steps)
        if fast_math:
            escaped = active & (rho2 > esc2)
            captured = active & ~escaped & (r2_ks < cap2)
            r_dt = r2_ks * rsqrt(r2_ks)
        else:
            r_dt = sqrt_rn(r2_ks)  # ks_radius
            escaped = active & (sqrt_rn(rho2) > escape_r)
            captured = active & ~escaped & (r_dt < r_capture)
        stepping = active & ~escaped & ~captured

        dt = base_dt
        if config.adaptive:
            dt = adaptive_dt(r_dt, rs, base_dt)[..., None]
        new_q, new_p = step(q, p, dt)

        if config.disk:
            intersect = intersect_equatorial_fast if fast_math else intersect_equatorial
            hit, hit_rel = intersect(q, new_q, r_isco, r_outer)
            hit = hit & stepping
            new_q = torch.where(hit[..., None], hit_rel, new_q)
            status = torch.where(hit, STATUS_DISK, status)

        m3 = stepping[..., None]
        q = torch.where(m3, new_q, q)
        p = torch.where(m3, new_p, p)
        status = torch.where(escaped, STATUS_ESCAPED, status)
        status = torch.where(captured, STATUS_CAPTURED, status)
        i += 1

    direction = ks.final_direction_fast if fast_math else ks.final_direction
    vel = direction(q, p, rs, spin)
    if config.disk:
        on_plane = torch.stack([q[..., 0], torch.zeros_like(q[..., 1]), q[..., 2]], dim=-1)
        q = torch.where((status == STATUS_DISK)[..., None], on_plane, q)
    return TraceResult(final_pos=q + bh_pos, final_vel=vel, status=status, steps=steps)
