"""Plain reference of the neural surrogate's frames (the Schwarzschild net):
ray generation, the reduced ray coordinates (r0, psi), the 16 features,
the tanh MLP at the default tier (every matrix operand rounded to bf16,
products and sums in fp32, each hidden tanh output rounded to bf16, the
head in fp32), the analytic deflection envelope, the rotation in the ray's
plane, the star field, captured rays (a positive logit) black, packed RGBA
rounded half up.

A copy of the raytracer's plain version of its neural kernel, cut to the
Schwarzschild net. It imports no module of the program and reads the
weights from the benchmark's own copy of the net (the traffic's "asset").
`render` with control=True rounds the operands to fp8 (e4m3) instead of
bf16, the precision below the one the configuration states.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .common import F32, pack_rgba8, rsqrt, sqrt_rn, star_field, view_constants

BC_FACTOR = 2.598076211  # (3 sqrt(3) / 2): the critical impact parameter over rs
BENCH_DIR = Path(__file__).resolve().parents[1]


def load_net(path) -> list:
    """(W (in, out), b) fp32 pairs of a surrogate saved by the raytracer's
    save_params."""
    with np.load(path) as z:
        return [(z[f"w{i}"].astype(np.float32), z[f"b{i}"].astype(np.float32))
                for i in range(int(z["n_layers"]))]


def mlp(layers, feats, rnd):
    """The tanh MLP with every operand rounded by `rnd`, sums in fp32 (TF32
    off), each hidden tanh output rounded."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = rnd(feats)
        for i, (w, b) in enumerate(layers):
            x = torch.matmul(x, rnd(w)) + b
            if i < len(layers) - 1:
                x = rnd(torch.tanh(x))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return x


def fourier_octaves(c, s):
    out = []
    for _ in range(4):
        s, c = 2.0 * s * c, c * c - s * s
        out += [s, c]
    return out


def render(cell, camera, *, seed: int, device, control: bool = False, rows=None):
    """The packed int32 frame (or the band of `rows`) of `camera`; no step
    counts (the surrogate integrates nothing)."""
    scene = cell.config["scene"]
    width, height = scene["width"], scene["height"]
    low = torch.float8_e4m3fn if control else torch.bfloat16

    def rnd(t):
        return t.to(low).to(F32)

    wf, hf, aspect, fovf = view_constants(width, height, scene["fov"])
    host = [*camera.position, *camera.forward, *camera.right, *camera.up,
            *torch.tensor(scene["black_hole_position"], dtype=F32),
            torch.tensor(scene["schwarzschild_radius"], dtype=F32), fovf, wf, hf, aspect]
    p = torch.stack([torch.as_tensor(v, dtype=F32).reshape(()) for v in host]).to(device)
    cam, fwd, right, up, bh = (p[i:i + 3] for i in (0, 3, 6, 9, 12))
    rs, fovf, wf, hf, aspect = p[15], p[16], p[17], p[18], p[19]
    r0_, r1_ = rows or (0, height)

    u = (torch.arange(width, dtype=F32, device=device)[None, :] / wf - 0.5) * 2.0 * aspect
    v = (torch.arange(r0_, r1_, device=device).to(F32)[:, None] / hf - 0.5) * -2.0
    uf, vf = u * fovf, v * fovf
    d = [fwd[i] + right[i] * uf + up[i] * vf for i in range(3)]
    inv = rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dx, dy, dz = (di * inv for di in d)

    rel = [cam[i] - bh[i] for i in range(3)]
    r0 = sqrt_rn(rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2])
    ux, uy, uz = (ri / r0 for ri in rel)
    c = dx * ux + dy * uy + dz * uz
    wx, wy, wz = dx - c * ux, dy - c * uy, dz - c * uz
    s_raw = sqrt_rn(wx * wx + wy * wy + wz * wz)
    s_inv = 1.0 / torch.clamp_min(s_raw, 1e-12)
    whx, why, whz = wx * s_inv, wy * s_inv, wz * s_inv
    s = torch.clamp(s_raw, 0.0, 1.0)

    ones = torch.ones_like(c)
    r0s = r0 * s
    t = r0s / (BC_FACTOR * rs) - 1.0
    feats = [(rs / r0) * ones, c, s, torch.clamp(BC_FACTOR * rs / (r0s + 1e-6), 0.0, 4.0),
             (0.25 * rs) * ones, (0.25 * torch.log(r0)) * ones,
             0.2 * torch.log(torch.abs(t) + 1e-3), torch.tanh(8.0 * t), *fourier_octaves(c, s)]
    layers = [(torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
              for w, b in load_net(BENCH_DIR / cell.traffic["asset"])]
    h = r1_ - r0_
    out = mlp(layers, torch.stack(feats, dim=-1).reshape(h * width, -1), rnd)
    out = out.reshape(h, width, -1)

    spike = torch.log1p(1.0 / (torch.abs(t) + 2e-2)) * (1.0 / (1.0 + torch.exp(-(-8.0 * c))))
    e_d = (rs / r0) * s * (0.25 + spike)
    delta = out[..., 0] * e_d
    cd, sd = torch.cos(delta), torch.sin(delta)
    cos_phi, sin_phi = c * cd - s * sd, s * cd + c * sd
    vx = cos_phi * ux + sin_phi * whx
    vy = cos_phi * uy + sin_phi * why
    vz = cos_phi * uz + sin_phi * whz
    vinv = rsqrt(vx * vx + vy * vy + vz * vz)
    r, g, b = star_field(vx * vinv, vy * vinv, vz * vinv, seed)
    live = (out[..., -1] <= 0.0).to(F32)
    return pack_rgba8(r * live, g * live, b * live, half_up=True), None
