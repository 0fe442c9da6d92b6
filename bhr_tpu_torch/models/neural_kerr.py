"""Neural geodesic surrogate for Kerr spacetime, the inference half
(PyTorch port of bhr_tpu/models/neural_kerr.py, whose module docstring
explains the reduction; spin axis +Y).

A Kerr ray reduces to r0, psi, the spin axis in the ray-plane basis
(uy, wy, ny) and (rs, a*). The net adds a spin block and the criticality
pair at the xi-shifted critical impact parameter to the Schwarzschild
features, and predicts three heads: the in-plane deflection delta, the
out-of-plane tilt chi and the capture logit,

    v_out = cos(chi) [cos(psi + delta) u + sin(psi + delta) w] + sin(chi) n.

Precision tiers as in models/neural.py.
"""

from __future__ import annotations

import torch

from ..core.math import cross, dot, sqrt_rn
from .neural import (
    _BC_FACTOR,
    envelope,
    fourier_octaves,
    load_npz,
    mlp_apply,
    plane_basis,
    rotate_in_plane,
    sigmoid,
)

KERR_FEATURE_VERSION = 2
N_FEATURES_KERR = 22
# +Y is the spin axis everywhere in the framework (models/kerr_schild.py)
_SPIN_AXIS = (0.0, 1.0, 0.0)

_F32 = torch.float32


def load_params(path):
    """Load a Kerr surrogate saved by bhr_tpu's save_params; returns
    (NeuralSurrogate, meta)."""
    return load_npz(path, "kerr_feature_version", KERR_FEATURE_VERSION, "Kerr-surrogate")


def bc_factor_kerr(xi) -> torch.Tensor:
    """Critical impact parameter over rs as a function of xi = a* ny
    (bhr_tpu/models/neural_kerr.py:125-163): the prograde-ness is p = -xi,
    and b_c / M = 2 + sqrt(1 - p) h(p) with h the degree-6 fit, evaluated
    in the same nested order; returned as b_c / rs."""
    xi = torch.as_tensor(xi, dtype=_F32)
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


def redshift_factor(r0, rs) -> torch.Tensor:
    """sqrt(1 - rs/r0), clamped to sqrt(0.04) (neural_kerr.py:166-177)."""
    r0 = torch.as_tensor(r0, dtype=_F32)
    rs = torch.as_tensor(rs, dtype=_F32, device=r0.device)
    return sqrt_rn(torch.clamp_min(1.0 - rs / r0, 0.04))


def reduce_ray(origins, directions, bh_pos) -> dict:
    """(..., 3) origins and directions -> the reduced coordinates and the
    plane basis (neural_kerr.py:180-201): r0, c, s, uy, wy, ny and u_hat,
    w_hat, n_hat = u_hat x w_hat."""
    r0, u_hat, c, w_hat, s = plane_basis(origins, directions, bh_pos)
    n_hat = cross(u_hat, w_hat)
    return dict(r0=r0, c=c, s=s, uy=u_hat[..., 1], wy=w_hat[..., 1], ny=n_hat[..., 1],
                u_hat=u_hat, w_hat=w_hat, n_hat=n_hat)


def criticality_kerr(r0, rs, s, xi) -> torch.Tensor:
    """tk = r0 s / (b_c(xi) rs redshift) - 1."""
    return r0 * s / (bc_factor_kerr(xi) * rs * redshift_factor(r0, rs)) - 1.0


def ray_features_kerr(r0, rs, spin, c, s, uy, wy, ny) -> torch.Tensor:
    """(..., N_FEATURES_KERR) inputs (neural_kerr.py:204-240): the
    Schwarzschild map, then spin, xi = spin ny, spin uy, spin wy and the
    criticality pair (f_log_k, f_sign_k) at tk."""
    r0 = torch.as_tensor(r0, dtype=_F32)
    rs = torch.as_tensor(rs, dtype=_F32, device=r0.device).broadcast_to(r0.shape)
    spin = torch.as_tensor(spin, dtype=_F32, device=r0.device).broadcast_to(r0.shape)
    mu = rs / r0
    q = torch.clamp(_BC_FACTOR * rs / (r0 * s + 1e-6), 0.0, 4.0)
    t = r0 * s / (_BC_FACTOR * rs) - 1.0
    f_log = 0.2 * torch.log(torch.abs(t) + 1e-3)
    f_sign = torch.tanh(8.0 * t)
    xi = spin * ny
    tk = criticality_kerr(r0, rs, s, xi)
    f_log_k = 0.2 * torch.log(torch.abs(tk) + 1e-3)
    f_sign_k = torch.tanh(8.0 * tk)
    return torch.stack([mu, c, s, q, 0.25 * rs, 0.25 * torch.log(r0), f_log, f_sign,
                        *fourier_octaves(c, s), spin, xi, spin * uy, spin * wy, f_log_k,
                        f_sign_k], dim=-1)


def kerr_envelopes(r0, rs, spin, s, c, ny):
    """(E_delta, E_chi), the fp32 magnitude envelopes of the two heads
    (neural_kerr.py:243-263): models/neural.delta_envelope's form at the
    xi-shifted tk; E_chi carries an extra |a*| + 1e-3."""
    r0 = torch.as_tensor(r0, dtype=_F32)
    rs = torch.as_tensor(rs, dtype=_F32, device=r0.device)
    spin = torch.as_tensor(spin, dtype=_F32, device=r0.device)
    s = torch.as_tensor(s, dtype=_F32)
    c = torch.as_tensor(c, dtype=_F32)
    tk = criticality_kerr(r0, rs, s, spin * torch.as_tensor(ny, dtype=_F32))
    e = envelope(r0, rs, s, c, tk)
    return e, e * (torch.abs(spin) + 1e-3)


def predict_plane_kerr(params, r0, rs, spin, c, s, uy, wy, ny, *, dtype=_F32,
                       precision="default"):
    """Reduced-coordinate prediction -> (delta, chi, capture probability)."""
    out = mlp_apply(params, ray_features_kerr(r0, rs, spin, c, s, uy, wy, ny), dtype=dtype,
                    precision=precision)
    e_d, e_c = kerr_envelopes(r0, rs, spin, s, c, ny)
    return e_d * out[..., 0], e_c * out[..., 1], sigmoid(out[..., 2])


def predict_directions_kerr(params, origins, directions, bh_pos, rs, spin, *, dtype=_F32,
                            precision="default"):
    """Full 3-D prediction (neural_kerr.py:279-298): (final unit direction
    (..., 3), captured bool (...,))."""
    red = reduce_ray(origins, directions, bh_pos)
    delta, chi, p_cap = predict_plane_kerr(
        params, red["r0"], rs, spin, red["c"], red["s"], red["uy"], red["wy"], red["ny"],
        dtype=dtype, precision=precision,
    )
    cos_phi, sin_phi = rotate_in_plane(red["c"], red["s"], delta)
    cc, sc = torch.cos(chi), torch.sin(chi)
    v = ((cc * cos_phi)[..., None] * red["u_hat"] + (cc * sin_phi)[..., None] * red["w_hat"]
         + sc[..., None] * red["n_hat"])
    v = v / sqrt_rn(dot(v, v))[..., None]
    return v, p_cap > 0.5
