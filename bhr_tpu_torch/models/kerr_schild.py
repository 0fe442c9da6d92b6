"""Kerr spacetime in Cartesian Kerr-Schild coordinates: exact null
geodesics by Hamiltonian integration, registered as model "kerr" (PyTorch
port of bhr_tpu/models/kerr_schild.py).

Geometric units, M = rs/2, a = a* M, spin axis +Y:

    g^{uv}  = eta^{uv} - f l^u l^v
    r(q):     r^4 - (rho^2 - a^2) r^2 - a^2 y^2 = 0,   rho^2 = x^2+y^2+z^2
    f       = 2 M r^3 / (r^4 + a^2 y^2)
    l_vec   = ((r x + a z)/(r^2+a^2),  y/r,  (r z - a x)/(r^2+a^2))
    H(q, p) = 1/2 (|p|^2 - 1 - f S^2),  S = 1 + l.p   (E = -p_t = 1)
    dq/dl   = p - f S l
    dp_i/dl = 1/2 (d_i f) S^2 + f S (d_i l_j) p_j

Every expression tree is the oracle's, operation for operation: the flow is
chaotic near the shadow's edge, so algebraically equal regroupings (even
`4 a2 (y y)` against `4 a2 y y`, which the oracle writes in different
functions) amplify their 1-ulp differences into visible per-pixel noise.
csrc/trace_ray.cuh transcribes the same trees. `rs` and `spin` are fp32
tensors on the state's device; every division divides by a device tensor,
so the plain version rounds on the card as on the CPU.

q, p and d are (..., 3).
"""

from __future__ import annotations

import torch

from ..core.math import dot, rsqrt, sqrt_rn
from .kerr import capture_radius, horizon_radius  # shared: 1.05 r_+

__all__ = [
    "aux",
    "derivs",
    "hamiltonian",
    "init_momentum",
    "final_direction",
    "capture_radius",
    "horizon_radius",
    "ks_radius",
]

_EPS = 1e-12


def _split(v):
    return v[..., 0], v[..., 1], v[..., 2]


def _spin_a(rs, spin):
    """(M, a) = (rs/2, a* M)."""
    m = rs * 0.5
    return m, spin * m


def ks_r2(q, rs, spin):
    """(r^2 of the Kerr-Schild radius, rho^2 = |q|^2) (pallas_trace.py
    ks_r2): the termination radii before their square roots."""
    _, a = _spin_a(rs, spin)
    a2 = a * a
    x, y, z = _split(q)
    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    disc = sqrt_rn(b * b + 4.0 * a2 * (y * y))
    return torch.clamp_min(0.5 * (b + disc), _EPS), rho2


def ks_radius(q, rs, spin):
    """The Kerr-Schild radial coordinate r (|q| when a* = 0)."""
    return sqrt_rn(ks_r2(q, rs, spin)[0])


def aux(q, rs, spin):
    """Shared quantities: (r, f, l_vec) at position q (relative to the BH)."""
    m, a = _spin_a(rs, spin)
    x, y, z = _split(q)
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    r2 = 0.5 * (b + sqrt_rn(b * b + 4.0 * a * a * y * y))
    r2 = torch.clamp_min(r2, _EPS)
    r = sqrt_rn(r2)
    w = torch.clamp_min(r2 * r2 + a * a * y * y, _EPS)  # r^4 + a^2 y^2
    f = 2.0 * m * r2 * r / w
    bb = r2 + a * a
    lx = (r * x + a * z) / bb
    ly = y / r
    lz = (r * z - a * x) / bb
    return r, f, torch.stack([lx, ly, lz], dim=-1)


def derivs(q, p, rs, spin):
    """Hamiltonian right-hand side (dq/dl, dp/dl) with p_t = -1
    (bhr_tpu/models/kerr_schild.py:85-177 and pallas_trace.py ks_all)."""
    m, a = _spin_a(rs, spin)
    a2 = a * a
    x, y, z = _split(q)
    px, py, pz = _split(p)

    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    disc = sqrt_rn(b * b + 4.0 * a2 * (y * y))
    r2 = torch.clamp_min(0.5 * (b + disc), _EPS)
    r = sqrt_rn(r2)
    y2 = y * y
    w = r2 * r2 + a2 * y2
    inv_w = 1.0 / w
    r3 = r2 * r
    f = (2.0 * m) * r3 * inv_w
    bb = r2 + a2
    inv_bb = 1.0 / bb
    lx = (r * x + a * z) * inv_bb
    inv_r = 1.0 / r
    ly = y * inv_r
    lz = (r * z - a * x) * inv_bb

    # dr/dq_i = r (r^2 q_i + a^2 y delta_iy) / W
    r_w = r * inv_w
    drx = r_w * r2 * x
    dry = r_w * bb * y  # r2 y + a2 y = (r2 + a2) y
    drz = r_w * r2 * z

    # df/dq_i = 2M [(3 r^2 W - 4 r^6) dr_i - 2 a^2 y r^3 delta_iy] / W^2
    g1 = (2.0 * m) * (3.0 * r2 * w - 4.0 * r3 * r3) * (inv_w * inv_w)
    g2 = (4.0 * m) * a2 * r3 * (inv_w * inv_w)
    dfx = g1 * drx
    dfy = g1 * dry - g2 * y
    dfz = g1 * drz

    # dl_j/dq_i
    two_r_invbb = 2.0 * r * inv_bb
    inv_r2 = inv_r * inv_r
    dlx_x = (x * drx + r) * inv_bb - lx * (two_r_invbb * drx)
    dlx_y = (x * dry) * inv_bb - lx * (two_r_invbb * dry)
    dlx_z = (x * drz + a) * inv_bb - lx * (two_r_invbb * drz)
    dly_x = -y * inv_r2 * drx
    dly_y = inv_r - y * inv_r2 * dry
    dly_z = -y * inv_r2 * drz
    dlz_x = (z * drx - a) * inv_bb - lz * (two_r_invbb * drx)
    dlz_y = (z * dry) * inv_bb - lz * (two_r_invbb * dry)
    dlz_z = (z * drz + r) * inv_bb - lz * (two_r_invbb * drz)

    s = 1.0 + lx * px + ly * py + lz * pz  # l^u p_u with p_t = -1
    fs = f * s

    dq = torch.stack([px - fs * lx, py - fs * ly, pz - fs * lz], dim=-1)
    hs2 = 0.5 * s * s
    dp = torch.stack(
        [
            hs2 * dfx + fs * (dlx_x * px + dly_x * py + dlz_x * pz),
            hs2 * dfy + fs * (dlx_y * px + dly_y * py + dlz_y * pz),
            hs2 * dfz + fs * (dlx_z * px + dly_z * py + dlz_z * pz),
        ],
        dim=-1,
    )
    return dq, dp


def hamiltonian(q, p, rs, spin):
    """H = 1/2 g^{uv} p_u p_v with p_t = -1; zero along null geodesics."""
    _, f, l = aux(q, rs, spin)
    s = 1.0 + dot(l, p)
    return 0.5 * (dot(p, p) - 1.0 - f * s * s)


def init_momentum(q, d, rs, spin):
    """Null covariant momentum, rescaled to E = -p_t = 1, for a photon at q
    with unit coordinate direction d (pallas_trace.py ks_init_p)."""
    _, a = _spin_a(rs, spin)
    a2 = a * a
    x, y, z = _split(q)
    dx, dy, dz = _split(d)
    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    r2 = torch.clamp_min(0.5 * (b + sqrt_rn(b * b + 4.0 * a2 * y * y)), _EPS)
    r = sqrt_rn(r2)
    w = r2 * r2 + a2 * y * y
    f = rs * r2 * r / w  # 2M = rs
    bb = r2 + a2
    lx = (r * x + a * z) / bb
    ly = y / r
    lz = (r * z - a * x) / bb
    c = lx * dx + ly * dy + lz * dz
    disc = sqrt_rn(torch.clamp_min(1.0 - f * (1.0 - c * c), _EPS))
    ut = (f * c + disc) / torch.clamp_min(1.0 - f, 1e-6)
    big_l = ut + c  # l_u u^u
    fl = f * big_l
    e_inv = 1.0 / torch.clamp_min(ut - fl, _EPS)  # E = u^t - f (l.u)
    return torch.stack(
        [(dx + fl * lx) * e_inv, (dy + fl * ly) * e_inv, (dz + fl * lz) * e_inv], dim=-1
    )


def final_direction(q, p, rs, spin):
    """Coordinate direction dq/dl, normalised: the shading direction."""
    dq, _ = derivs(q, p, rs, spin)
    n = sqrt_rn(torch.clamp_min(dot(dq, dq), _EPS))
    return dq / n[..., None]


def final_direction_fast(q, p, rs, spin):
    """The fast tier's shading direction (pallas_trace.py ks_direction):
    dq * rsqrt(dq . dq), with a correctly rounded rsqrt."""
    dq, _ = derivs(q, p, rs, spin)
    return dq * rsqrt(dot(dq, dq))[..., None]
