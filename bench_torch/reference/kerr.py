"""Plain reference of the Kerr frames: exact null geodesics of the Kerr
metric in Cartesian Kerr-Schild coordinates, integrated by semi-implicit
Euler on the Hamiltonian state (q, p) with E = -p_t = 1, the thin
accretion disk, the analytic star field, packed RGBA, in the exact tier
(correctly rounded operations, the 512-entry blackbody table, rounding
half to even) or the fast tier (r^2 tests, the in-kernel disk with its
128-entry table, rounding half up), each in exact operations.

A copy of the raytracer's plain PyTorch version of the Kerr-Schild model
and loop, operation for operation: the flow is chaotic near the shadow's
edge, so an algebraically equal regrouping (even `(4 a^2) (y y)` against
`((4 a^2) y) y`) moves visible pixels. Geometric units, M = rs / 2,
a = a* M, spin axis +Y:

    r(q):   r^4 - (rho^2 - a^2) r^2 - a^2 y^2 = 0,   rho^2 = |q|^2
    f     = 2 M r^3 / (r^4 + a^2 y^2)
    l     = ((r x + a z) / (r^2 + a^2),  y / r,  (r z - a x) / (r^2 + a^2))
    dq/dl = p - f S l,   dp_i/dl = 1/2 (d_i f) S^2 + f S (d_i l_j) p_j,   S = 1 + l.p

It differs from that version in bookkeeping only, none of which moves a
bit: each 3-vector is held as three planes; a quantity the step computes
twice from the same operands (the Kerr-Schild radius of the termination
test and of the first right-hand side; everything but S of the second,
which sees the same q) is computed once; and the loop steps only the rays
still running: every COMPACT_EVERY steps the finished rays are scattered
back and the running ones gathered. `trace(compact_every=0)` is the masked
loop over every ray. The disk's shading, the star field and the packing
are reference/schwarzschild.py's and common.py's. It imports no module of
the program. `render` with control=True computes the same frame in
bfloat16, the precision below the float32 that the configuration states.
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
from .schwarzschild import (
    KERNEL_LUT_STEPS,
    LUT_STEPS,
    blackbody_lut_np,
    disk_emission,
    shade_disk_fast,
)

EPS = 1e-12
COMPACT_EVERY = 8  # steps between two gathers of the running rays


class Metric:
    """The spin's constants, each computed once as the model computes it
    inline: rs and spin are 0-d tensors on the rays' device."""

    def __init__(self, rs, spin):
        m = rs * 0.5
        self.rs = rs
        self.a = spin * m
        self.a2 = self.a * self.a
        self.four_a2 = 4.0 * self.a2
        self.two_m = 2.0 * m
        self.four_m_a2 = (4.0 * m) * self.a2
        # the capture radius's horizon r_+ = M (1 + sqrt(1 - a*^2)), a* in [0, 0.999]
        a_star = torch.clamp(spin, 0.0, 0.999)
        self.r_plus = m * (1.0 + sqrt_rn(1.0 - a_star * a_star))


def ks_r2(x, y, z, k: Metric):
    """(r^2 of the Kerr-Schild radius, rho^2 = |q|^2)."""
    rho2 = x * x + y * y + z * z
    b = rho2 - k.a2
    disc = sqrt_rn(b * b + k.four_a2 * (y * y))
    return torch.clamp_min(0.5 * (b + disc), EPS), rho2


def _geometry(x, y, z, r2, k: Metric):
    """What dq/dl and dp/dl share at q: (r, W = r^4 + a^2 y^2, 1/W, r^3,
    f, r^2 + a^2, 1/(r^2 + a^2), 1/r, l)."""
    r = sqrt_rn(r2)
    y2 = y * y
    w = r2 * r2 + k.a2 * y2
    inv_w = 1.0 / w
    r3 = r2 * r
    f = k.two_m * r3 * inv_w
    bb = r2 + k.a2
    inv_bb = 1.0 / bb
    lx = (r * x + k.a * z) * inv_bb
    inv_r = 1.0 / r
    ly = y * inv_r
    lz = (r * z - k.a * x) * inv_bb
    return r, w, inv_w, r3, f, bb, inv_bb, inv_r, (lx, ly, lz)


def _dq(f, l, p):
    """dq/dl = p - f S l and f S, S = 1 + l.p."""
    lx, ly, lz = l
    px, py, pz = p
    s = 1.0 + lx * px + ly * py + lz * pz
    fs = f * s
    return (px - fs * lx, py - fs * ly, pz - fs * lz), s, fs


def _dp(x, y, z, p, r2, k: Metric):
    """(f, l, dp/dl) at (q, p); r2 is ks_r2's at q."""
    px, py, pz = p
    r, w, inv_w, r3, f, bb, inv_bb, inv_r, l = _geometry(x, y, z, r2, k)
    lx, _, lz = l

    # dr/dq_i = r (r^2 q_i + a^2 y delta_iy) / W
    r_w = r * inv_w
    drx = r_w * r2 * x
    dry = r_w * bb * y
    drz = r_w * r2 * z

    # df/dq_i = 2M [(3 r^2 W - 4 r^6) dr_i - 2 a^2 y r^3 delta_iy] / W^2
    iw2 = inv_w * inv_w
    g1 = k.two_m * (3.0 * r2 * w - 4.0 * r3 * r3) * iw2
    g2 = k.four_m_a2 * r3 * iw2
    dfx = g1 * drx
    dfy = g1 * dry - g2 * y
    dfz = g1 * drz

    # dl_j/dq_i
    two_r_invbb = 2.0 * r * inv_bb
    inv_r2 = inv_r * inv_r
    tx, ty, tz = two_r_invbb * drx, two_r_invbb * dry, two_r_invbb * drz
    dlx_x = (x * drx + r) * inv_bb - lx * tx
    dlx_y = (x * dry) * inv_bb - lx * ty
    dlx_z = (x * drz + k.a) * inv_bb - lx * tz
    my_ir2 = -y * inv_r2
    dly_x = my_ir2 * drx
    dly_y = inv_r - y * inv_r2 * dry
    dly_z = my_ir2 * drz
    dlz_x = (z * drx - k.a) * inv_bb - lz * tx
    dlz_y = (z * dry) * inv_bb - lz * ty
    dlz_z = (z * drz + r) * inv_bb - lz * tz

    _, s, fs = _dq(f, l, p)
    hs2 = 0.5 * s * s
    dp = (hs2 * dfx + fs * (dlx_x * px + dly_x * py + dlz_x * pz),
          hs2 * dfy + fs * (dlx_y * px + dly_y * py + dlz_y * pz),
          hs2 * dfz + fs * (dlx_z * px + dly_z * py + dlz_z * pz))
    return f, l, dp


def init_momentum(x, y, z, d, k: Metric):
    """Null covariant momentum, rescaled to E = -p_t = 1, for a photon at
    q with unit coordinate direction d."""
    dx, dy, dz = d
    a2 = k.a2
    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    r2 = torch.clamp_min(0.5 * (b + sqrt_rn(b * b + k.four_a2 * y * y)), EPS)
    r = sqrt_rn(r2)
    w = r2 * r2 + a2 * y * y
    f = k.rs * r2 * r / w  # 2M = rs
    bb = r2 + a2
    lx = (r * x + k.a * z) / bb
    ly = y / r
    lz = (r * z - k.a * x) / bb
    c = lx * dx + ly * dy + lz * dz
    disc = sqrt_rn(torch.clamp_min(1.0 - f * (1.0 - c * c), EPS))
    ut = (f * c + disc) / torch.clamp_min(1.0 - f, 1e-6)
    fl = f * (ut + c)  # f (l_u u^u)
    e_inv = 1.0 / torch.clamp_min(ut - fl, EPS)  # E = u^t - f (l.u)
    return ((dx + fl * lx) * e_inv, (dy + fl * ly) * e_inv, (dz + fl * lz) * e_inv)


def final_direction(x, y, z, p, k: Metric, *, fast: bool):
    """The shading direction dq/dl normalised: by a correctly rounded
    rsqrt in the fast tier, by the clamped root in the exact."""
    r2, _ = ks_r2(x, y, z, k)
    geometry = _geometry(x, y, z, r2, k)
    (dqx, dqy, dqz), _, _ = _dq(geometry[4], geometry[8], p)
    d2 = dqx * dqx + dqy * dqy + dqz * dqz
    if fast:
        inv = rsqrt(d2)
        return dqx * inv, dqy * inv, dqz * inv
    n = sqrt_rn(torch.clamp_min(d2, EPS))
    return dqx / n, dqy / n, dqz / n


def intersect(old, new, r_isco, r_outer, *, fast: bool):
    """The step's crossing of y = 0 inside the annulus -> (hit, hit point):
    in the exact tier t = -oy / (ny - oy) and the root of the hit point's
    |q|^2, whose interpolated y is kept; in the fast tier t by a
    reciprocal, y = 0 and the annulus tested in r^2."""
    (ox, oy, oz), (nx, ny, nz) = old, new
    crosses = oy * ny < 0.0
    if fast:
        den = torch.where(crosses, ny - oy, torch.ones_like(ny))
        tt = -oy * torch.reciprocal(den)
        hx = ox + tt * (nx - ox)
        hz = oz + tt * (nz - oz)
        hr2 = hx * hx + hz * hz
        hit = crosses & (hr2 >= r_isco * r_isco) & (hr2 <= r_outer * r_outer)
        return hit, (hx, torch.zeros_like(hx), hz)
    denom = ny - oy
    t = -oy / torch.where(crosses, denom, torch.ones_like(denom))
    hx, hy, hz = ox + t * (nx - ox), oy + t * (ny - oy), oz + t * (nz - oz)
    r = sqrt_rn(hx * hx + hy * hy + hz * hz)
    return crosses & (r >= r_isco) & (r <= r_outer), (hx, hy, hz)


class Loop:
    """The loop's constants, on the rays' device in their dtype."""

    def __init__(self, scene: dict, renderer: dict, trace_c: dict, device, dtype, fast: bool):
        if renderer["integrator"] != "euler" or renderer["adaptive"]:
            raise ValueError("the Kerr reference integrates by Euler at a fixed dt; got "
                             f"{renderer['integrator']}, adaptive={renderer['adaptive']}")
        rs = on_device(scene["schwarzschild_radius"], device, dtype)
        self.k = Metric(rs, on_device(scene["spin"], device, dtype))
        self.fast, self.disk = fast, renderer["disk"]
        self.bh = on_device(scene["black_hole_position"], device, dtype)
        self.dt = on_device(renderer["dt"], device, dtype)
        self.escape_r = on_device(trace_c["escape_radius"], device, dtype)
        # capture_factor multiplies the outer horizon r_+, not r_s
        self.r_capture = trace_c["capture_factor"] * self.k.r_plus
        self.esc2 = self.escape_r * self.escape_r
        self.cap2 = self.r_capture * self.r_capture
        self.r_isco = trace_c["disk_r_isco_factor"] * rs
        self.r_outer = trace_c["disk_r_outer_factor"] * rs

    def step(self, state, i: int):
        """Step i of the masked loop on the rays of `state` (x, y, z, px,
        py, pz, status, steps): the running ones are tested, and those
        neither escaped nor captured take one semi-implicit Euler step."""
        x, y, z, px, py, pz, status, steps = state
        k = self.k
        active = status == STATUS_RUNNING
        r2, rho2 = ks_r2(x, y, z, k)
        steps = torch.where(active, i + 1, steps)
        if self.fast:
            escaped = active & (rho2 > self.esc2)
            captured = active & ~escaped & (r2 < self.cap2)
        else:
            escaped = active & (sqrt_rn(rho2) > self.escape_r)
            captured = active & ~escaped & (sqrt_rn(r2) < self.r_capture)
        stepping = active & ~escaped & ~captured

        # semi-implicit: p first, then q with the updated p; both right-hand
        # sides see the same q, so the second needs only S at the new p
        f, l, dp = _dp(x, y, z, (px, py, pz), r2, k)
        p2 = tuple(pc + dpc * self.dt for pc, dpc in zip((px, py, pz), dp))
        dq2, _, _ = _dq(f, l, p2)
        new_q = tuple(qc + dqc * self.dt for qc, dqc in zip((x, y, z), dq2))

        if self.disk:
            hit, hit_q = intersect((x, y, z), new_q, self.r_isco, self.r_outer, fast=self.fast)
            hit = hit & stepping
            new_q = tuple(torch.where(hit, h, n) for h, n in zip(hit_q, new_q))
            status = torch.where(hit, STATUS_DISK, status)

        q = tuple(torch.where(stepping, n, o) for n, o in zip(new_q, (x, y, z)))
        p = tuple(torch.where(stepping, n, o) for n, o in zip(p2, (px, py, pz)))
        status = torch.where(escaped, STATUS_ESCAPED, status)
        status = torch.where(captured, STATUS_CAPTURED, status)
        return (*q, *p, status, steps)


def trace(origins, dirs, scene: dict, renderer: dict, trace_c: dict, *, fast: bool,
          compact_every: int = COMPACT_EVERY):
    """Integrate every ray to termination -> (final position relative to
    the black hole with y = 0 on a disk hit, unit shading direction, each
    (..., 3); status; steps). The masked loop runs until no ray is running
    or max_steps is spent; with compact_every > 0 only the running rays
    are stepped, gathered every compact_every steps."""
    dev, dtype = dirs.device, dirs.dtype
    loop = Loop(scene, renderer, trace_c, dev, dtype, fast)
    k = loop.k
    shape = dirs.shape[:-1]
    q = (origins - loop.bh).reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    d = d / sqrt_rn(dot(d, d))[..., None]
    x, y, z = (q[:, j].contiguous() for j in range(3))
    p = init_momentum(x, y, z, tuple(d[:, j].contiguous() for j in range(3)), k)
    n = x.shape[0]
    full = [x, y, z, *p, torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev)]
    work, idx = full, None
    for i in range(scene["max_steps"]):
        if compact_every and i % compact_every == 0:
            running = work[6] == STATUS_RUNNING
            if idx is not None:
                done = (~running).nonzero().squeeze(1)
                for t, w in zip(full, work):
                    t[idx[done]] = w[done]
            keep = running.nonzero().squeeze(1)
            idx = keep if idx is None else idx[keep]
            work = [w[keep] for w in work]
            if idx.numel() == 0:
                break
        elif not compact_every and not bool((work[6] == STATUS_RUNNING).any()):
            break
        work = loop.step(work, i)
    if idx is not None:
        for t, w in zip(full, work):
            t[idx] = w
    else:
        full = work
    x, y, z, px, py, pz, status, steps = full
    vel = final_direction(x, y, z, (px, py, pz), k, fast=fast)
    if loop.disk:
        y = torch.where(status == STATUS_DISK, torch.zeros_like(y), y)
    # the final position as the program returns it (q + bh), made relative
    # again as its shading makes it
    hit = torch.stack([(c + b) - b for c, b in zip((x, y, z), loop.bh)], dim=-1)
    return (hit.reshape(*shape, 3), torch.stack(vel, dim=-1).reshape(*shape, 3),
            status.reshape(shape), steps.reshape(shape))


def shade(hit, vel, status, camera, cell, *, seed: int, fast: bool):
    """The packed frame of a trace: the star field along `vel`, the disk's
    emission where the ray hit it (the in-kernel shading in the fast tier,
    the epilogue's in the exact), captured rays black."""
    device, dtype = vel.device, vel.dtype
    scene, trace_c = cell.config["scene"], cell.config["trace"]
    r, g, b = star_field(vel[..., 0], vel[..., 1], vel[..., 2], seed)
    if cell.config["renderer"]["disk"]:
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
        r, g, b = (torch.where(on_disk, dc, c) for dc, c in zip(disk, (r, g, b)))
    captured = status == STATUS_CAPTURED
    zero = torch.zeros((), dtype=dtype, device=device)
    r, g, b = (torch.where(captured, zero, c) for c in (r, g, b))
    return pack_rgba8(r, g, b, half_up=fast)


def render(cell, camera, *, seed: int, device, control: bool = False, rows=None):
    """The packed int32 frame (or the band of `rows`) of `camera` and the
    rays' step counts. `cell` carries the configuration ("scene",
    "renderer", "trace") and the traffic's tier (its renderer's
    "fast_math")."""
    dtype = torch.bfloat16 if control else F32
    scene = cell.config["scene"]
    fast = bool(cell.traffic.get("renderer", {}).get("fast_math", False))
    origins, dirs = generate_rays(camera, scene["width"], scene["height"], scene["fov"], device,
                                  dtype, rows)
    hit, vel, status, steps = trace(origins, dirs, scene, cell.config["renderer"],
                                    cell.config["trace"], fast=fast)
    return shade(hit, vel, status, camera, cell, seed=seed, fast=fast), steps
