"""Plain reference of the Kerr neural surrogate's frames (the Kerr net:
22 -> hidden -> 3, tanh): ray generation, the ray plane's basis (u the
radial unit, w the in-plane tangent, n = u x w), the 22 features (the
Schwarzschild net's 16, then a*, xi = a* n_y, a* u_y, a* w_y and the
criticality pair at tk, the distance from the critical impact parameter
shifted by xi), the tanh MLP at the default tier (every matrix operand
rounded to bf16, products and sums in fp32, each hidden tanh output rounded
to bf16, the head in fp32), the envelopes of the deflection delta and the
tilt chi, the rotation

    v_out = cos(chi) [cos(psi + delta) u + sin(psi + delta) w] + sin(chi) n,

the star field, captured rays (a positive logit) black, packed RGBA
rounded half up.

A copy of the raytracer's plain version of its neural kernel
(models/neural_kerr.py's equations in that version's order of operations),
cut to the Kerr net. It imports no module of the program and reads the
weights from the benchmark's own copy of the net (the traffic's "asset").
It departs from that version in bookkeeping only:
  * n's components are the cross product's, taken where they are used;
  * the first layer's 22 inputs are not padded to 32 (the kernel's zero
    rows add nothing to a sum);
  * a whole frame is computed in bands of BAND_ROWS rows, so that a 4K
    frame's hidden activations fit beside the program's (a 256-wide fp32
    activation of 270 x 3840 pixels is 1.06 GB; of the frame, 8.5 GB).
    Every operation but the MLP's products is per pixel, and a product's
    sums run over one pixel's inputs; the band height is fixed, so the
    matrix library sees the same shapes in every run.
`render` with control=True rounds the operands to fp8 (e4m3) instead of
bf16, the precision below the one the configuration states.
"""

from __future__ import annotations

import torch

from .common import F32, pack_rgba8, rsqrt, sqrt_rn, star_field, view_constants
from .neural_schwarzschild import BC_FACTOR, BENCH_DIR, fourier_octaves, load_net, mlp

BAND_ROWS = 270


def bc_factor_kerr(xi):
    """The critical impact parameter over rs at xi = a* n_y: with p = -xi,
    b_c / M = 2 + sqrt(1 - p) h(p), h the degree-6 fit in nested form."""
    p = -xi
    h = 3.196512167 + p * (
        -0.406504577 + p * (
            -0.102461550 + p * (
                -0.006447487 + p * (
                    0.033141079 + p * (
                        -0.081345290 + p * (-0.090476836)
                    )
                )
            )
        )
    )
    return (2.0 + sqrt_rn(torch.clamp_min(1.0 + xi, 0.0)) * h) * 0.5


def criticality_kerr(r0, rs, s, xi):
    """tk = r0 s / (b_c(xi) rs sqrt(max(1 - rs / r0, 0.04))) - 1."""
    red = sqrt_rn(torch.clamp_min(1.0 - rs / r0, 0.04))
    return r0 * s / (bc_factor_kerr(xi) * rs * red) - 1.0


def _band(p, layers, rnd, seed: int, width: int, rows: tuple, device):
    """The packed rows [rows[0], rows[1]) of the frame whose camera, scene
    and view constants `p` holds."""
    cam, fwd, right, up, bh = (p[i:i + 3] for i in (0, 3, 6, 9, 12))
    rs, spin, fovf, wf, hf, aspect = p[15], p[16], p[17], p[18], p[19], p[20]
    r0_, r1_ = rows

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
    ny = uz * whx - ux * whz
    xi = spin * ny
    tk = criticality_kerr(r0, rs, s, xi)
    feats = [(rs / r0) * ones, c, s, torch.clamp(BC_FACTOR * rs / (r0s + 1e-6), 0.0, 4.0),
             (0.25 * rs) * ones, (0.25 * torch.log(r0)) * ones,
             0.2 * torch.log(torch.abs(t) + 1e-3), torch.tanh(8.0 * t), *fourier_octaves(c, s),
             spin * ones, xi, (spin * uy) * ones, spin * why,
             0.2 * torch.log(torch.abs(tk) + 1e-3), torch.tanh(8.0 * tk)]
    h = r1_ - r0_
    out = mlp(layers, torch.stack(feats, dim=-1).reshape(h * width, -1), rnd)
    out = out.reshape(h, width, -1)

    spike = torch.log1p(1.0 / (torch.abs(tk) + 2e-2)) * (1.0 / (1.0 + torch.exp(-(-8.0 * c))))
    e_d = (rs / r0) * s * (0.25 + spike)
    delta = out[..., 0] * e_d
    chi = out[..., 1] * (e_d * (torch.abs(spin) + 1e-3))
    cd, sd = torch.cos(delta), torch.sin(delta)
    cos_phi, sin_phi = c * cd - s * sd, s * cd + c * sd
    cc, sc = torch.cos(chi), torch.sin(chi)
    nx = uy * whz - uz * why
    nz = ux * why - uy * whx
    a, b = cc * cos_phi, cc * sin_phi
    vx = a * ux + b * whx + sc * nx
    vy = a * uy + b * why + sc * ny
    vz = a * uz + b * whz + sc * nz
    vinv = rsqrt(vx * vx + vy * vy + vz * vz)
    r, g, b = star_field(vx * vinv, vy * vinv, vz * vinv, seed)
    live = (out[..., -1] <= 0.0).to(F32)
    return pack_rgba8(r * live, g * live, b * live, half_up=True)


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
            torch.tensor(scene["schwarzschild_radius"], dtype=F32),
            torch.tensor(scene["spin"], dtype=F32), fovf, wf, hf, aspect]
    p = torch.stack([torch.as_tensor(v, dtype=F32).reshape(()) for v in host]).to(device)
    layers = [(torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
              for w, b in load_net(BENCH_DIR / cell.traffic["asset"])]
    r0_, r1_ = rows or (0, height)
    bands = [_band(p, layers, rnd, seed, width, (a, min(a + BAND_ROWS, r1_)), device)
             for a in range(r0_, r1_, BAND_ROWS)]
    return torch.cat(bands), None
