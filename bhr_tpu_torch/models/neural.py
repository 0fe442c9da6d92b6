"""Neural geodesic surrogate, the inference half (PyTorch port of
bhr_tpu/models/neural.py; its module docstring explains the symmetry
reduction, the features and the envelope).

A Schwarzschild ray reduces to (r0, rs, psi): the net maps 16 bounded
features of them to an O(1) deflection coefficient and a capture logit,
and the fp32 analytic envelope `delta_envelope` carries the deflection's
magnitude. The weights are bhr_tpu's trained assets, copied into
bhr_tpu_torch/assets/ and read with numpy. Training, datasets and
distillation are not ported (ROADMAP queue A, item 16).

Precision tiers. bhr_tpu's tiers name the TPU matrix unit's pass count
(`models/neural.py:242-259` there); the port gives each the arithmetic it
has on the TPU, in the CUDA kernel (csrc/neural_mlp.cu), its plain version
and the staged route alike:

* ``default``: every matrix operand (features, weights, hidden
  activations) rounded to bf16, products and sums in fp32, the bias added
  in fp32; each hidden layer's tanh output is rounded to bf16 before the
  next layer, the head's output stays fp32. This is what the TPU computes
  at `precision=None` for either `neural_dtype`, and the point the
  bf16-trained weights were trained at.
* ``highest``: fp32 operands and fp32 fused multiply-adds, no TF32
  anywhere (TF32 keeps 10 mantissa bits): `mlp_apply` turns
  `torch.backends.cuda.matmul.allow_tf32` off around its products.
* ``high``: bhr_tpu sends it to its staged path; the port computes it as
  ``highest`` there (on the CPU bhr_tpu computes both in fp32 too).
* ``auto`` (renderer only): resolved from the asset's `train_precision`
  (bhr_tpu/renderer.py:539-553).

A `neural_dtype` of bfloat16 rounds the staged route's operands to bf16 at
every tier, as on the TPU.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..core.math import dot, sqrt_rn

FEATURE_VERSION = 3
N_FEATURES = 16
# GR critical impact parameter b_c = (3 sqrt(3) / 2) rs, a feature's
# normalizer only.
_BC_FACTOR = 2.598076211
PRECISION_TIERS = ("default", "high", "highest")
ASSETS_DIR = Path(__file__).resolve().parents[1] / "assets"

_F32 = torch.float32


# ---------------------------------------------------------------------------
# parameters


def model_of(params) -> str:
    """The feature map a net was trained on, from its shapes: 16 inputs and
    2 outputs is the Schwarzschild net, 22 and 3 the Kerr net
    (bhr_tpu/ops/neural_pallas.py:_model_of)."""
    n_in = params[0][0].shape[0]
    n_out = params[-1][0].shape[1]
    if (n_in, n_out) == (16, 2):
        return "schwarzschild"
    if (n_in, n_out) == (22, 3):
        return "kerr"
    raise ValueError(
        f"unrecognized surrogate shape: in={n_in}, out={n_out} (expected 16/2 Schwarzschild "
        "or 22/3 Kerr)"
    )


class NeuralSurrogate(nn.Module):
    """A tanh MLP's (W (in, out), b (out,)) pairs, held as fp32 buffers.

    Indexing and iteration give the pairs, as bhr_tpu's tuple of pairs
    does. `model` is "schwarzschild" (16 -> ... -> 2) or "kerr"
    (22 -> ... -> 3).
    """

    def __init__(self, layers):
        super().__init__()
        layers = list(layers)
        if len(layers) < 2:
            raise ValueError("a surrogate needs at least one hidden layer")
        for i, (w, b) in enumerate(layers):
            w, b = (x.to(_F32) if torch.is_tensor(x) else torch.tensor(np.asarray(x, np.float32))
                    for x in (w, b))
            if w.ndim != 2 or b.shape != (w.shape[1],):
                raise ValueError(f"layer {i}: W {tuple(w.shape)} and b {tuple(b.shape)} "
                                 "do not make an (in, out) layer")
            if i and w.shape[0] != layers_out:
                raise ValueError(f"layer {i} takes {w.shape[0]} inputs, layer {i - 1} "
                                 f"gives {layers_out}")
            layers_out = w.shape[1]
            self.register_buffer(f"w{i}", w.contiguous())
            self.register_buffer(f"b{i}", b.contiguous())
        self.n_layers = len(layers)
        self.model = model_of(self)
        self._kernel_operands = {}

    def __len__(self) -> int:
        return self.n_layers

    def __getitem__(self, i):
        i = range(self.n_layers)[i]
        return getattr(self, f"w{i}"), getattr(self, f"b{i}")

    def __iter__(self):
        return (self[i] for i in range(self.n_layers))

    @property
    def widths(self) -> tuple[int, ...]:
        """The hidden layers' widths."""
        return tuple(w.shape[1] for w, _ in list(self)[:-1])

    def _apply(self, fn, *args, **kwargs):
        self._kernel_operands = {}  # prepared operands belong to the old buffers
        return super()._apply(fn, *args, **kwargs)


def load_npz(path, version_key: str, version: int, what: str):
    """(NeuralSurrogate on the CPU, meta dict of numpy values) from an npz
    saved by bhr_tpu's save_params, whose `version_key` must be `version`."""
    with np.load(path) as z:
        if version_key not in z.files:
            raise ValueError(f"weights at {path} are not a {what} asset (no {version_key} field)")
        if int(z[version_key]) != version:
            raise ValueError(f"weights at {path} use {version_key} {int(z[version_key])}, "
                             f"code expects {version}")
        n = int(z["n_layers"])
        params = NeuralSurrogate((z[f"w{i}"], z[f"b{i}"]) for i in range(n))
        meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
    return params, meta


def load_params(path):
    """Load a Schwarzschild surrogate saved by bhr_tpu's save_params;
    returns (NeuralSurrogate, meta). Kerr assets load through
    models/neural_kerr.load_params."""
    return load_npz(path, "feature_version", FEATURE_VERSION, "Schwarzschild-surrogate")


# ---------------------------------------------------------------------------
# features + forward pass


def ray_features(r0, rs, cos_psi, sin_psi) -> torch.Tensor:
    """(..., N_FEATURES) network inputs from the reduced ray coordinates
    (bhr_tpu/models/neural.py:144-204): mu, cos, sin, the clipped inverse
    impact parameter q, rs/4, log(r0)/4, the signed log-distance from the
    critical impact parameter and its soft sign, and four Fourier octaves
    of psi by double-angle recurrences."""
    r0 = torch.as_tensor(r0, dtype=_F32)
    rs = torch.as_tensor(rs, dtype=_F32, device=r0.device).broadcast_to(r0.shape)
    c = torch.as_tensor(cos_psi, dtype=_F32)
    s = torch.as_tensor(sin_psi, dtype=_F32)
    mu = rs / r0
    q = torch.clamp(_BC_FACTOR * rs / (r0 * s + 1e-6), 0.0, 4.0)
    t = r0 * s / (_BC_FACTOR * rs) - 1.0
    f_log = 0.2 * torch.log(torch.abs(t) + 1e-3)
    f_sign = torch.tanh(8.0 * t)
    return torch.stack([mu, c, s, q, 0.25 * rs, 0.25 * torch.log(r0), f_log, f_sign,
                        *fourier_octaves(c, s)], dim=-1)


def fourier_octaves(c, s) -> list[torch.Tensor]:
    """[s2, c2, s4, c4, s8, c8, s16, c16]: sin and cos of 2, 4, 8 and 16
    psi from (cos psi, sin psi) by the double-angle recurrences."""
    out = []
    for _ in range(4):
        s, c = 2.0 * s * c, c * c - s * s
        out += [s, c]
    return out


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), written out so that the CUDA kernel, which
    computes the same expression with expf, gives the same bits."""
    return 1.0 / (1.0 + torch.exp(-x))


def delta_envelope(r0, rs, sin_psi, cos_psi) -> torch.Tensor:
    """The analytic deflection-magnitude envelope E
    (bhr_tpu/models/neural.py:207-226), fp32 throughout:
    (rs/r0) sin(psi) (1/4 + log1p(1 / (|t| + 0.02)) sigmoid(-8 cos psi))."""
    r0 = torch.as_tensor(r0, dtype=_F32)
    rs = torch.as_tensor(rs, dtype=_F32, device=r0.device)
    s = torch.as_tensor(sin_psi, dtype=_F32)
    c = torch.as_tensor(cos_psi, dtype=_F32)
    t = r0 * s / (_BC_FACTOR * rs) - 1.0
    return envelope(r0, rs, s, c, t)


def envelope(r0, rs, s, c, t) -> torch.Tensor:
    """(rs/r0) s (1/4 + log1p(1 / (|t| + 0.02)) sigmoid(-8 c)) for the
    criticality coordinate t (Schwarzschild's t, or Kerr's xi-shifted tk)."""
    spike = torch.log1p(1.0 / (torch.abs(t) + 2e-2)) * sigmoid(-8.0 * c)
    return (rs / r0) * s * (0.25 + spike)


def tier(precision) -> str:
    """A precision tier's name: None is "default"."""
    precision = "default" if precision is None else precision
    if precision not in PRECISION_TIERS:
        raise ValueError(f"precision must be one of {PRECISION_TIERS} or None, got {precision!r}")
    return precision


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest bf16 (ties to even), held in fp32."""
    return x.to(torch.bfloat16).to(_F32)


@contextlib.contextmanager
def fp32_matmul():
    """torch.matmul in full fp32: TF32 off for the block (it would round
    fp32 operands to 10 mantissa bits), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mlp_apply(params, feats: torch.Tensor, *, dtype=_F32, precision="default") -> torch.Tensor:
    """Forward pass (bhr_tpu/models/neural.py:236-277) -> (..., n_out) fp32.

    At the ``default`` tier, or with `dtype` bfloat16, every matrix operand
    is rounded to bf16 and multiplied in fp32 (products of two bf16 values
    are exact in fp32), and each hidden tanh output is rounded to bf16;
    at ``high`` and ``highest`` the chain is fp32. Sums go to
    torch.matmul, which orders them its own way. See the module docstring.
    """
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    bf16 = tier(precision) == "default" or dtype == torch.bfloat16
    rnd = bf16_round if bf16 else (lambda t: t)
    layers = list(params)
    x = rnd(feats.to(_F32))
    with fp32_matmul():
        for i, (w, b) in enumerate(layers):
            x = torch.matmul(x, rnd(w.to(_F32))) + b
            if i < len(layers) - 1:
                x = rnd(torch.tanh(x))
    return x


def predict_plane(params, r0, rs, cos_psi, sin_psi, *, dtype=_F32, precision="default"):
    """Reduced-coordinate prediction -> (delta, capture probability)."""
    out = mlp_apply(params, ray_features(r0, rs, cos_psi, sin_psi), dtype=dtype,
                    precision=precision)
    delta = delta_envelope(r0, rs, sin_psi, cos_psi) * out[..., 0]
    return delta, sigmoid(out[..., 1])


def plane_basis(origins, directions, bh_pos):
    """(d unit, r0, u_hat, c, w_hat, s) of bhr_tpu's predict_directions:
    the radial unit u_hat, cos psi = d . u_hat, the in-plane tangent w_hat
    (guarded for radial rays, s ~ 0) and s = |d - c u_hat| clipped to 1."""
    d = torch.as_tensor(directions, dtype=_F32)
    d = d / sqrt_rn(dot(d, d))[..., None]
    rel = torch.as_tensor(origins, dtype=_F32) - torch.as_tensor(bh_pos, dtype=_F32,
                                                                  device=d.device)
    r0 = sqrt_rn(dot(rel, rel))
    u_hat = rel / r0[..., None]
    c = dot(d, u_hat)
    w_vec = d - c[..., None] * u_hat
    s_raw = sqrt_rn(dot(w_vec, w_vec))
    w_hat = w_vec / torch.clamp_min(s_raw, 1e-12)[..., None]
    return r0, u_hat, c, w_hat, torch.clamp(s_raw, 0.0, 1.0)


def rotate_in_plane(c, s, delta):
    """(cos, sin) of psi + delta by angle addition."""
    cd, sd = torch.cos(delta), torch.sin(delta)
    return c * cd - s * sd, s * cd + c * sd


def predict_directions(params, origins, directions, bh_pos, rs, *, dtype=_F32,
                       precision="default"):
    """Full 3-D prediction (bhr_tpu/models/neural.py:293-326): (final unit
    direction (..., 3), captured bool (...,))."""
    r0, u_hat, c, w_hat, s = plane_basis(origins, directions, bh_pos)
    delta, p_cap = predict_plane(params, r0, rs, c, s, dtype=dtype, precision=precision)
    cos_phi, sin_phi = rotate_in_plane(c, s, delta)
    v = cos_phi[..., None] * u_hat + sin_phi[..., None] * w_hat
    v = v / sqrt_rn(dot(v, v))[..., None]
    return v, p_cap > 0.5
