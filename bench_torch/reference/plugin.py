"""Plain reference of plugin physics: null rays under a user's acceleration,
integrated by the exact tier's semi-implicit Euler loop, then the staged
exact epilogue (the analytic star field, passthrough, rounding half to
even), packed RGBA.

A physics plugin is a Python file defining `acceleration(rel, vel, r, r2,
rs, spin)` on component planes -> (ax, ay, az), and optionally
`CAPTURE_FACTOR`, the capture radius in units of r_s (1.05 without it).
The configuration names the file (renderer.custom_physics, from the root
of the checkout) and pins its sha256 (plugin_sha256); the file is loaded
by importlib and called on plain tensors. The loop is
reference/schwarzschild.py's exact Euler loop with the acceleration
swapped, in the oracle's operation order: r2 is formed as r * r; r and r2
are the rays' planes, rs and spin 0-d tensors of the data's dtype on its
device, so that a plugin computes on them as the raytracer's plain version
does (a host number where a tensor was would be divided by as a multiply
by its reciprocal on CUDA).

It imports no module of the program. `render` with control=True computes
the same frame in bfloat16, the precision below the float32 that the
configuration states.
"""

from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path

import torch

from .common import (
    F32,
    STATUS_CAPTURED,
    STATUS_ESCAPED,
    STATUS_RUNNING,
    dot,
    generate_rays,
    on_device,
    pack_rgba8,
    sqrt_rn,
    star_field,
)

REPO = Path(__file__).resolve().parents[2]
DEFAULT_CAPTURE_FACTOR = 1.05


def load(cell):
    """The configuration's plugin module, checked against the digest it
    pins."""
    path = REPO / cell.config["renderer"]["custom_physics"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cell.config["plugin_sha256"]:
        raise ValueError(f"{path} has sha256 {digest}, the configuration pins "
                         f"{cell.config['plugin_sha256']}")
    spec = importlib.util.spec_from_file_location(f"bench_plugin_{digest[:16]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def acceleration(mod, rel, vel, r, rs, spin):
    """The plugin's acceleration as (..., 3), every component broadcast to
    the rays' shape."""
    out = mod.acceleration((rel[..., 0], rel[..., 1], rel[..., 2]),
                           (vel[..., 0], vel[..., 1], vel[..., 2]), r, r * r, rs, spin)
    return torch.stack([torch.broadcast_to(torch.as_tensor(a, dtype=rel.dtype, device=rel.device),
                                           rel.shape[:-1]) for a in out], dim=-1)


def trace(mod, origins, dirs, scene: dict, renderer: dict, trace_c: dict):
    """Integrate every ray to termination -> (unit direction, status,
    steps). Rays are updated under a mask until none is running or
    max_steps is spent (wgsl:138-171)."""
    if renderer["integrator"] != "euler" or renderer["adaptive"] or renderer["disk"]:
        raise ValueError("the plugin reference integrates by Euler at a fixed dt, with no disk")
    dev, dtype = dirs.device, dirs.dtype
    rs = on_device(scene["schwarzschild_radius"], dev, dtype)
    spin = on_device(scene["spin"], dev, dtype)
    bh = on_device(scene["black_hole_position"], dev, dtype)
    dt = on_device(renderer["dt"], dev, dtype)
    escape_r = on_device(trace_c["escape_radius"], dev, dtype)
    r_capture = rs * on_device(getattr(mod, "CAPTURE_FACTOR", DEFAULT_CAPTURE_FACTOR), dev,
                               dtype)
    pos = origins
    vel = dirs / sqrt_rn(dot(dirs, dirs))[..., None]
    shape = pos.shape[:-1]
    status = torch.zeros(shape, dtype=torch.int32, device=dev)
    steps = torch.zeros(shape, dtype=torch.int32, device=dev)
    i = 0
    while i < scene["max_steps"] and bool((status == STATUS_RUNNING).any()):
        active = status == STATUS_RUNNING
        rel = pos - bh
        dist = sqrt_rn(dot(rel, rel))
        steps = torch.where(active, i + 1, steps)
        escaped = active & (dist > escape_r)
        captured = active & ~escaped & (dist < r_capture)
        stepping = active & ~escaped & ~captured
        new_vel = vel + acceleration(mod, rel, vel, dist, rs, spin) * dt
        new_rel = rel + new_vel * dt
        # torch.sqrt, as the raytracer's plain version takes this one root
        new_vel = new_vel / torch.sqrt(dot(new_vel, new_vel))[..., None]
        m3 = stepping[..., None]
        pos = torch.where(m3, new_rel + bh, pos)
        vel = torch.where(m3, new_vel, vel)
        status = torch.where(escaped, STATUS_ESCAPED, status)
        status = torch.where(captured, STATUS_CAPTURED, status)
        i += 1
    return vel, status, steps


def render(cell, camera, *, seed: int, device, control: bool = False, rows=None):
    """The packed int32 frame (or the band of `rows`) of `camera` and the
    rays' step counts, in the exact tier. `cell` carries the configuration
    ("scene", "renderer", "trace", "plugin_sha256") and the traffic."""
    if cell.traffic.get("renderer", {}).get("fast_math", False):
        raise ValueError("the plugin reference computes the exact tier only")
    dtype = torch.bfloat16 if control else F32
    scene = cell.config["scene"]
    mod = load(cell)
    origins, dirs = generate_rays(camera, scene["width"], scene["height"], scene["fov"], device,
                                  dtype, rows)
    vel, status, steps = trace(mod, origins, dirs, scene, cell.config["renderer"],
                               cell.config["trace"])
    r, g, b = star_field(vel[..., 0], vel[..., 1], vel[..., 2], seed)
    captured = status == STATUS_CAPTURED
    zero = torch.zeros((), dtype=dtype, device=device)
    r, g, b = (torch.where(captured, zero, c) for c in (r, g, b))
    return pack_rgba8(r, g, b, half_up=False), steps
