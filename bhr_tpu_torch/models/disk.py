"""Thin accretion disk: geometry, relativistic shading, blackbody LUT
(PyTorch port of bhr_tpu/models/disk.py; reference formulation:
docs/ROADMAP.md:285-470).

An equatorial thin disk in the y = 0 plane between r_isco = 3 r_s and
r_outer = 10 r_s, Keplerian velocity field, Doppler x gravitational
g-factor, temperature T(r) = T_isco (r / r_isco)^-3/4, a blackbody colour
LUT, and beaming I_obs = I_emit / g^3.

Every division has a tensor divisor on the data's device: on CUDA, PyTorch
turns division by a host scalar into a multiply by its reciprocal, which
rounds differently from the oracle's true division.

`shade_disk_planes` is the plain version of the fast kernel's in-kernel
disk (bhr_tpu/ops/pallas_trace.py `_shade_disk`), on component planes with
the 128-entry LUT of `kernel_lut_np`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.math import dot, on_device, rsqrt, sqrt_rn

# Default geometry in units of r_s (docs/ROADMAP.md:330-333).
R_ISCO_FACTOR = 3.0
R_OUTER_FACTOR = 10.0
T_ISCO = 10000.0  # Kelvin (docs/ROADMAP.md:402)
LUT_T_MIN = 1000.0
LUT_T_MAX = 30000.0
LUT_STEPS = 512
KERNEL_LUT_STEPS = 128  # the fast kernel's LUT (pallas_trace.py:1723)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DiskParams:
    """Dynamic disk configuration: fp32 scalar tensors."""

    r_isco: torch.Tensor
    r_outer: torch.Tensor
    t_isco: torch.Tensor

    @classmethod
    def for_scene(cls, rs) -> "DiskParams":
        """The disk of a black hole of Schwarzschild radius `rs`, on rs's
        device."""
        rs = torch.as_tensor(rs, dtype=_F32)
        return cls(r_isco=R_ISCO_FACTOR * rs, r_outer=R_OUTER_FACTOR * rs,
                   t_isco=on_device(T_ISCO, rs.device))


def intersect_equatorial(old_pos, new_pos, r_isco, r_outer):
    """Segment vs y = 0 plane crossing within the disk annulus, in the
    oracle's form: t = -oy / (ny - oy), the annulus tested on the sqrt'd
    radius of the hit point (docs/ROADMAP.md:293-313). Returns
    (hit_mask, hit_pos)."""
    oy = old_pos[..., 1]
    ny = new_pos[..., 1]
    crosses = oy * ny < 0.0
    denom = ny - oy
    t = -oy / torch.where(crosses, denom, torch.ones_like(denom))
    hit_pos = old_pos + t[..., None] * (new_pos - old_pos)
    r = sqrt_rn(dot(hit_pos, hit_pos))
    hit = crosses & (r >= r_isco) & (r <= r_outer)
    return hit, hit_pos


def intersect_equatorial_fast(old_pos, new_pos, r_isco, r_outer):
    """The fast tier's crossing test (pallas_trace.py:1068-1075): t by a
    reciprocal, the hit point in the x-z plane (y = 0), the annulus tested
    in r^2 space. Exact operations here; the kernel's reciprocal is
    approximate. Returns (hit_mask, hit_pos)."""
    oy = old_pos[..., 1]
    ny = new_pos[..., 1]
    crosses = oy * ny < 0.0
    den = torch.where(crosses, ny - oy, torch.ones_like(ny))
    tt = -oy * torch.reciprocal(den)
    hx = old_pos[..., 0] + tt * (new_pos[..., 0] - old_pos[..., 0])
    hz = old_pos[..., 2] + tt * (new_pos[..., 2] - old_pos[..., 2])
    hr2 = hx * hx + hz * hz
    hit = crosses & (hr2 >= r_isco * r_isco) & (hr2 <= r_outer * r_outer)
    return hit, torch.stack([hx, torch.zeros_like(hx), hz], dim=-1)


def keplerian_velocity(hit_pos, rs):
    """Keplerian orbital velocity at a disk point (ROADMAP.md:360-370):
    speed beta = sqrt(M / r) (M = rs / 2, clipped below 0.9), tangent
    (z, 0, -x) / |(z, 0, -x)|."""
    r = sqrt_rn(dot(hit_pos, hit_pos))[..., None]
    m = torch.as_tensor(rs, dtype=_F32) * 0.5
    beta = sqrt_rn(torch.clamp(m / r, 0.0, 0.81))
    x = hit_pos[..., 0:1]
    z = hit_pos[..., 2:3]
    tangent = torch.cat([z, torch.zeros_like(x), -x], dim=-1)
    norm = sqrt_rn(dot(tangent, tangent))[..., None]
    tangent = tangent / torch.clamp_min(norm, 1e-20)
    return beta * tangent


def redshift_factor(hit_pos, ray_direction, observer_r, rs):
    """Combined Doppler x gravitational g-factor (ROADMAP.md:374-397)."""
    r_disk = sqrt_rn(dot(hit_pos, hit_pos))
    v = keplerian_velocity(hit_pos, rs)
    beta = sqrt_rn(dot(v, v))
    v_hat = v / torch.clamp_min(beta[..., None], 1e-20)
    d = ray_direction / sqrt_rn(dot(ray_direction, ray_direction))[..., None]
    cos_theta = dot(v_hat, d)
    doppler = (1.0 - beta * cos_theta) / sqrt_rn(1.0 - beta * beta)
    grav_emit = sqrt_rn(torch.clamp(1.0 - rs / torch.maximum(r_disk, 1.001 * rs), 1e-4, 1.0))
    grav_obs = sqrt_rn(torch.clamp(1.0 - rs / torch.maximum(observer_r, 1.001 * rs), 1e-4,
                                      1.0))
    return doppler * (grav_emit / grav_obs)


def disk_temperature(r, r_isco, t_isco):
    """T(r) = T_isco (r / r_isco)^(-3/4) (ROADMAP.md:400-404)."""
    return t_isco * torch.pow(torch.clamp_min(r / r_isco, 1e-6), -0.75)


def _cie_xyz_bar(wl_nm):
    """Wyman-Sloan-Shirley analytic fit to the CIE 1931 colour matching
    functions (bhr_tpu/models/disk.py:132-147)."""

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        t = (x - mu) / s
        return np.exp(-0.5 * t * t)

    x = (
        1.056 * g(wl_nm, 599.8, 37.9, 31.0)
        + 0.362 * g(wl_nm, 442.0, 16.0, 26.7)
        - 0.065 * g(wl_nm, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(wl_nm, 568.8, 46.9, 40.5) + 0.286 * g(wl_nm, 530.9, 16.3, 31.1)
    z = 1.217 * g(wl_nm, 437.0, 11.8, 36.0) + 0.681 * g(wl_nm, 459.0, 26.0, 13.8)
    return x, y, z


@functools.lru_cache(maxsize=4)
def blackbody_lut_np(t_min=LUT_T_MIN, t_max=LUT_T_MAX, steps=LUT_STEPS) -> np.ndarray:
    """(steps, 3) float32 linear-sRGB blackbody colours for temperatures in
    [t_min, t_max], on the host: Planck spectrum -> CIE XYZ -> linear sRGB,
    negative channels clipped, each colour normalised to max channel 1.
    The same numpy computation as bhr_tpu/models/disk.py:151-175."""
    wl = np.linspace(380e-9, 780e-9, 200)
    wl_nm = wl * 1e9
    xbar, ybar, zbar = _cie_xyz_bar(wl_nm)
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    temps = np.linspace(t_min, t_max, steps)
    with np.errstate(over="ignore"):
        b = (2 * h * c**2 / wl**5) / (np.expm1(h * c / (wl * kb * temps[:, None])))
    xyz = np.stack([b @ xbar, b @ ybar, b @ zbar], axis=-1)
    m = np.array(
        [
            [3.2406, -1.5372, -0.4986],
            [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570],
        ]
    )
    rgb = xyz @ m.T
    rgb = np.clip(rgb, 0.0, None)
    peak = np.maximum(rgb.max(axis=-1, keepdims=True), 1e-12)
    rgb = rgb / peak
    return rgb.astype(np.float32)


def blackbody_lut(t_min=LUT_T_MIN, t_max=LUT_T_MAX, steps=LUT_STEPS, *, device="cpu"):
    """The (steps, 3) fp32 blackbody LUT as a tensor on `device`."""
    return torch.from_numpy(blackbody_lut_np(t_min, t_max, steps).copy()).to(device)


@functools.lru_cache(maxsize=1)
def kernel_lut_np() -> np.ndarray:
    """The fast kernel's LUT: channel-major fp32[3 * 128]
    (pallas_trace.py:1726-1735)."""
    lut = blackbody_lut_np(steps=KERNEL_LUT_STEPS)
    return np.ascontiguousarray(lut.T.reshape(-1)).astype(np.float32)


def temperature_to_color(t, lut=None, t_min=LUT_T_MIN, t_max=LUT_T_MAX):
    """Linear LUT sample, clamped to the table (ROADMAP.md:440-447)."""
    if lut is None:
        lut = blackbody_lut(device=t.device)
    steps = lut.shape[0]
    x = (t - t_min) / on_device(t_max - t_min, t.device) * (steps - 1)
    x = torch.clamp(x, 0.0, steps - 1.0)
    i0 = torch.floor(x).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, steps - 1)
    f = (x - i0.to(_F32))[..., None]
    return lut[i0] * (1.0 - f) + lut[i1] * f


SELECT_LUT_STEPS = 64  # temperature_to_color_select's coarse table


@functools.lru_cache(maxsize=1)
def select_lut_np() -> tuple[np.ndarray, np.ndarray]:
    """The tables of `temperature_to_color_select`: the 512-entry curve
    resampled to 64 uniform knots (np.interp, as bhr_tpu resamples it),
    then per segment i its start colour, summed in fp32 in bhr_tpu's order
    (lut[0] + d_0 + ... + d_{i-1}), and its delta d_i. Both (63, 3) fp32."""
    lut = blackbody_lut_np()
    xs = np.linspace(0, LUT_STEPS - 1, SELECT_LUT_STEPS)
    coarse = np.stack([np.interp(xs, np.arange(LUT_STEPS), lut[:, c]) for c in range(3)],
                      axis=-1).astype(np.float32)
    deltas = np.diff(coarse, axis=0)
    starts = np.empty_like(deltas)
    acc = coarse[0].copy()
    for i in range(SELECT_LUT_STEPS - 1):
        starts[i] = acc
        acc = acc + deltas[i]  # fp32, one rounding a segment
    return starts, deltas


@functools.lru_cache(maxsize=8)
def _select_lut_on(device: torch.device):
    """select_lut_np's tables on `device`, copied there once: a copy from
    host memory in every frame would make the host wait for the device."""
    return tuple(torch.from_numpy(a).to(device) for a in select_lut_np())


def temperature_to_color_select(t, t_min=LUT_T_MIN, t_max=LUT_T_MAX):
    """The blackbody colour of bhr_tpu's multires epilogue
    (bhr_tpu/models/disk.py:temperature_to_color_select, its `lut="select"`):
    the piecewise-linear curve through 64 knots resampled from the
    512-entry table, which lies within 1.5 levels of `temperature_to_color`.

    bhr_tpu evaluates it without a gather, as lut[0] + sum_i d_i clamp(x -
    i, 0, 1) over all 63 segments. Every term before x's segment adds d_i
    and every one after it adds 0, so the sum is start_i + d_i (x - i) with
    start_i the fp32 prefix sum: the same value from two indexed reads,
    which is what a gather costs here."""
    starts, deltas = _select_lut_on(t.device)
    steps = SELECT_LUT_STEPS
    x = (t - t_min) / on_device(t_max - t_min, t.device) * (steps - 1)
    x = torch.clamp(x, 0.0, steps - 1.0)
    i0 = torch.clamp_max(torch.floor(x).to(torch.int64), steps - 2)
    w = torch.clamp(x - i0.to(_F32), 0.0, 1.0)[..., None]
    return starts[i0] + deltas[i0] * w


def disk_emission(hit_pos, ray_direction, observer_r, rs, params: DiskParams, lut=None):
    """Observed disk colour at a hit point (ROADMAP.md:451-459):
    T_obs = T_emit / g, I_obs = I_emit / g^3, with a radial falloff so the
    outer edge fades. (..., 3) fp32 linear colour. `lut` is the (512, 3)
    table, or the string "select" for the multires epilogue's curve
    (`temperature_to_color_select`)."""
    r = sqrt_rn(dot(hit_pos, hit_pos))
    g = redshift_factor(hit_pos, ray_direction, observer_r, rs)
    g = torch.clamp_min(g, 1e-3)
    t_emit = disk_temperature(r, params.r_isco, params.t_isco)
    t_obs = t_emit / g
    if isinstance(lut, str) and lut == "select":
        color = temperature_to_color_select(t_obs)
    else:
        color = temperature_to_color(t_obs, lut)
    beaming = 1.0 / (g * g * g)
    edge = torch.clamp((params.r_outer - r) / (params.r_outer - params.r_isco), 0.0, 1.0)
    rel_t = t_obs / on_device(T_ISCO, t_obs.device)
    intensity = beaming * (rel_t * rel_t) * edge
    return color * torch.clamp(intensity, 0.0, 4.0)[..., None]


def shade_disk_planes(hx, hz, vel, rs, r_isco, r_outer, t_isco, observer_r, lut):
    """The fast kernel's in-kernel disk emission on component planes
    (pallas_trace.py:1216-1278), in exact operations where the kernel uses
    approximate rsqrt and reciprocal.

    hx/hz: the hit point's x and z relative to the black hole; vel (..., 3)
    the unit ray direction; rs, r_isco, r_outer, t_isco, observer_r fp32
    scalar tensors on the planes' device; lut the channel-major
    fp32[3 * n] table of `kernel_lut_np`. T ~ r^-3/4 is computed as
    rsqrt(x) * rsqrt(sqrt(x)), and the LUT is read by an indexed lerp.
    Returns (r, g, b) planes.
    """
    dr2 = hx * hx + hz * hz
    inv_dr = rsqrt(torch.clamp_min(dr2, 1e-12))
    dr = dr2 * inv_dr
    m = rs * 0.5
    beta2 = torch.clamp(m * inv_dr, 0.0, 0.81)
    beta = sqrt_rn(beta2)
    cos_t = (hz * vel[..., 0] - hx * vel[..., 2]) * inv_dr
    doppler = (1.0 - beta * cos_t) * rsqrt(1.0 - beta2)
    grav_emit = sqrt_rn(torch.clamp(
        1.0 - rs * torch.reciprocal(torch.maximum(dr, 1.001 * rs)), 1e-4, 1.0))
    grav_obs = sqrt_rn(torch.clamp(1.0 - rs / torch.maximum(observer_r, 1.001 * rs), 1e-4,
                                      1.0))
    gfac = torch.clamp_min(doppler * (grav_emit / grav_obs), 1e-3)
    inv_g = torch.reciprocal(gfac)
    x = torch.clamp_min(dr * (1.0 / r_isco), 1e-6)
    t_emit = t_isco * (rsqrt(x) * rsqrt(sqrt_rn(x)))
    t_obs = t_emit * inv_g
    beaming = inv_g * inv_g * inv_g
    rel_t = t_obs * (1.0 / T_ISCO)
    edge = torch.clamp((r_outer - dr) * (1.0 / (r_outer - r_isco)), 0.0, 1.0)
    intensity = torch.clamp(beaming * rel_t * rel_t * edge, 0.0, 4.0)
    n = lut.shape[0] // 3
    t_cl = torch.clamp((t_obs - LUT_T_MIN) * ((n - 1) / (LUT_T_MAX - LUT_T_MIN)), 0.0,
                       float(n - 1))
    i0f = torch.floor(t_cl)
    frac = t_cl - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    color = []
    for c in range(3):
        c0 = lut[c * n + i0]
        c1 = lut[c * n + i1]
        color.append((c0 + frac * (c1 - c0)) * intensity)
    return tuple(color)
