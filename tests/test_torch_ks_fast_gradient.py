"""The fast Kerr-Schild step's algebra (csrc/trace_ray.cuh, FAST = true), on
the CPU in float64: dp = (s^2 / 2) grad f + f s grad(l.p) taken through the
Kerr-Schild r, with no 3x3 Jacobian of l, against the oracle's form in
models/kerr_schild.derivs, and the SFU form of the radii's roots.

The kernel cannot run here; this transcribes its fast ks_radii, ks_geom and
ks_terms operation for operation, with the SFU's rsqrt and rcp taken
exactly, so a wrong sign or a missing term shows before any card time.
"""

import numpy as np
import pytest
import torch

from bhr_tpu_torch.models import kerr_schild as tks

RS = 2.0
N = 100_000
REL = 1e-10


def _fast_terms(q, p, rs, spin):
    """(dq, dp, scale) as the fast tier forms them: ks_radii<true>,
    ks_geom<true> and ks_terms(KsGeom<true>), in float64. scale is dp's
    size before s = 1 + l.p cancels: the largest over components of
    (S^2 / 2) |d_i f| + |f| S |d_i (l.p)| with S = 1 + sum_j |l_j p_j|."""
    m = rs * 0.5
    a = spin * m
    a2 = a * a
    x, y, z = q.unbind(-1)
    px, py, pz = p.unbind(-1)
    # ks_radii<true>: disc = disc2 rsqrt(max(disc2, 1e-30)), 1/r = rsqrt(r^2)
    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    y2 = y * y
    disc2 = b * b + 4.0 * a2 * y2
    disc = disc2 * torch.rsqrt(torch.clamp_min(disc2, 1e-30))
    r2 = torch.clamp_min(0.5 * (b + disc), 1e-12)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    w = r2 * r2 + a2 * y2
    bb = r2 + a2
    inv_w = 1.0 / w
    inv_bb = 1.0 / bb
    # ks_geom<true>
    r3 = r2 * r
    inv_w2 = inv_w * inv_w
    f = (2.0 * m) * r3 * inv_w
    lx = (r * x + a * z) * inv_bb
    ly = y * inv_r
    lz = (r * z - a * x) * inv_bb
    g1 = (2.0 * m) * r2 * (3.0 * (a2 * y2) - r2 * r2) * inv_w2
    g2y = ((4.0 * m) * a2) * r3 * inv_w2 * y
    r_w = r * inv_w
    drx, dry, drz = r2 * x, bb * y, r2 * z
    # ks_terms(KsGeom<true>)
    uxz = lx * px + lz * pz
    uy = ly * py
    s = 1.0 + uxz + uy
    fs = f * s
    hs2 = 0.5 * s * s
    dq = torch.stack([px - fs * lx, py - fs * ly, pz - fs * lz], -1)
    p1 = x * px + z * pz
    u_r = (p1 - 2.0 * r * uxz) * inv_bb - uy * inv_r
    kk = (hs2 * g1 + fs * u_r) * r_w
    fs_bb = fs * inv_bb
    dp = torch.stack([kk * drx + fs_bb * (r * px - a * pz),
                      kk * dry + fs * (py * inv_r) - hs2 * g2y,
                      kk * drz + fs_bb * (r * pz + a * px)], -1)
    grad_r = torch.stack([drx, dry, drz], -1) * r_w[..., None]
    grad_f = g1[..., None] * grad_r - torch.stack([0 * y, g2y, 0 * y], -1)
    grad_u = u_r[..., None] * grad_r + torch.stack([(r * px - a * pz) * inv_bb, py * inv_r,
                                                    (r * pz + a * px) * inv_bb], -1)
    s_size = 1.0 + (lx * px).abs() + uy.abs() + (lz * pz).abs()
    scale = (0.5 * s_size[..., None] ** 2 * grad_f.abs()
             + (f * s_size)[..., None] * grad_u.abs()).amax(-1)
    return dq, dp, scale


def _at_radius(r, theta, phi, a):
    """Points of Kerr-Schild radius r: x^2 + z^2 = (r^2 + a^2) sin^2 theta,
    y = r cos theta."""
    st = torch.sin(theta)
    return torch.stack([(r * torch.cos(phi) + a * torch.sin(phi)) * st, r * torch.cos(theta),
                        (r * torch.sin(phi) - a * torch.cos(phi)) * st], -1)


def _points(region, spin, gen):
    """N seeded points of a region of the loop's domain, float64."""
    m = RS * 0.5
    a = spin * m
    u = lambda *s: torch.rand(*s, generator=gen, dtype=torch.float64)
    r_plus = m + (m * m - a * a) ** 0.5
    phi = 2 * np.pi * u(N)
    if region == "far":  # out to the escape radius
        r = 10.0 + 90.0 * u(N)
        theta = np.pi * u(N)
    elif region == "near":  # just outside the capture radius 1.05 r_+
        r = r_plus * (1.05 + 0.5 * u(N))
        theta = np.pi * u(N)
    else:  # |y| << 1: the disk's plane, 1e-9 .. 1e-3 off it, either side
        r = r_plus * 1.05 + 20.0 * u(N)
        off = 10.0 ** (-9.0 + 6.0 * u(N)) * torch.where(u(N) < 0.5, -1.0, 1.0)
        theta = torch.arccos(off / r)
    return _at_radius(r, theta, phi, a)


@pytest.mark.parametrize("spin", [0.0, 0.9])
@pytest.mark.parametrize("region", ["far", "near", "plane"])
def test_fast_gradient_through_r_equals_the_oracles_derivs(region, spin, monkeypatch):
    """The fast tier's dq and dp equal models/kerr_schild.derivs within
    1e-10, at 1e5 seeded points with random momenta (derivs in float64, its
    roots taken in float64). dq's error is relative to its largest
    component, dp's to its size before s = 1 + l.p cancels: where s is
    near 0, the two forms round s differently by ~1e-16 and dp scales with
    s and s^2 (at one point of the plane |dp| is 4e-8, and the oracle's own
    float64 error there is 3e-10 of |dp| by 50-digit arithmetic, the fast
    form's 3e-11)."""
    monkeypatch.setattr(tks, "sqrt_rn", torch.sqrt)  # float64 roots, not fp32's
    gen = torch.Generator().manual_seed(17 + int(spin * 10) + {"far": 0, "near": 1,
                                                                "plane": 2}[region] * 100)
    q = _points(region, spin, gen)
    p = torch.randn(N, 3, generator=gen, dtype=torch.float64)
    rs = torch.tensor(RS, dtype=torch.float64)
    sp = torch.tensor(spin, dtype=torch.float64)
    want_dq, want_dp = tks.derivs(q, p, rs, sp)
    got_dq, got_dp, dp_scale = _fast_terms(q, p, rs, sp)
    for got, want, scale in ((got_dq, want_dq, want_dq.abs().amax(-1)),
                             (got_dp, want_dp, dp_scale)):
        rel = ((got - want).abs().amax(-1) / scale).max().item()
        assert rel <= REL, (region, spin, rel)
    # the points lie where the region says
    r = tks.ks_radius(q, rs, sp)
    assert torch.isfinite(got_dp).all() and (r >= 1.05 * (RS / 2) * (1 + (1 - spin**2) ** 0.5)
                                             - 1e-9).all()


def test_sfu_disc_root_is_zero_on_the_ring():
    """disc2 rsqrt(max(disc2, 1e-30)) in float32 with the SFU's rsqrt taken
    exactly: the root of disc2 away from the ring, 0 (not 0 * inf = NaN)
    where disc2 = 0, on the ring y = 0, |q| = a."""
    disc2 = np.array([0.0, 1e-38, 1e-20, 0.81, 4.0, 1e8], np.float32)
    rsqrt = (1.0 / np.sqrt(np.maximum(disc2, np.float32(1e-30)).astype(np.float64))).astype(
        np.float32)
    disc = disc2 * rsqrt
    assert disc[0] == 0.0 and np.isfinite(disc).all()
    np.testing.assert_allclose(disc[2:], np.sqrt(disc2[2:].astype(np.float64)), rtol=2e-7)
    assert disc[1] < 1e-18  # a radius below the clamp of r^2 (1e-12) either way
