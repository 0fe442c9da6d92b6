"""Equirectangular skybox sampling and frame packing (PyTorch port of
bhr_tpu/ops/sampling.py).

The samplers reproduce the wgpu sampler the reference binds for the skybox
(reference: src/lib.rs:414-421): address mode Repeat in U (the panorama
wraps at the seam), ClampToEdge in V, texel centres at (i + 0.5) / N, on an
Rgba8Unorm texture (texels are k/255). They run as plain PyTorch on the
direction planes' device, after the trace kernel: rays need the skybox only
at termination.

The texture is one packed RGBA word per texel, R | G<<8 | B<<16 | A<<24,
and so is the frame; both are int32 tensors with the bits of bhr_tpu's
uint32 words (PyTorch's uint32 lacks shifts and adds on the CPU).
`unpack_frame` views a frame as uint8 (..., H, W, 4); on a little-endian
machine that is the byte order of jax.lax.bitcast_convert_type.

Texture tiers, as bhr_tpu's: "bilinear" (4 texel reads, the oracle's lerp
tree), "nearest" (1 read), "luma" (bilinear luminance from a corner-packed
luma table, chroma nearest on a subsampled screen grid), and the
subsampled / checkerboard reconstructions of either plain filter. bhr_tpu's
corner-packed bilinear layouts and its index scramble are TPU gather-count
devices with bit-identical results (its tests/test_sampling.py:78-141) and
are not ported: here a gather is an indexed load.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import direction_to_equirectangular_uv, on_device, rsqrt
from .resample import shift, subsample, upsample_bilinear
from .trace import STATUS_CAPTURED, STATUS_DISK

_INV255 = float(np.float32(1.0 / 255.0))


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def pack_rgba8_planes(r, g, b, alpha: float = 1.0, *, half_up: bool = False) -> torch.Tensor:
    """fp32 color planes in [0,1] -> packed RGBA int32 plane.

    Rounds clip(c, 0, 1) * 255 half to even, like jnp.round; `half_up=True`
    rounds half up, floor(x + 0.5), as the fast tier's in-kernel quantizer
    does (bhr_tpu/ops/pallas_trace.py:1306-1312).
    """
    def q(c):
        x = torch.clamp(c, 0.0, 1.0) * 255.0
        x = torch.floor(x + 0.5) if half_up else torch.round(x)
        return x.to(torch.int64)

    a = int(round(alpha * 255.0)) << 24
    return _to_int32_bits(q(r) | (q(g) << 8) | (q(b) << 16) | a)


def unpack_frame(packed: torch.Tensor) -> torch.Tensor:
    """Packed int32 (..., H, W) frame -> uint8 (..., H, W, 4) RGBA view."""
    return packed.contiguous().view(torch.uint8).view(*packed.shape, 4)


def quantize_rgba8(rgb: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """fp32 (..., 3) in [0,1] -> uint8 (..., 4) RGBA (rgba8unorm: round to
    nearest even of clamp(v, 0, 1) * 255; reference alpha 1.0, wgsl:214)."""
    q = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    a = torch.full(q.shape[:-1] + (1,), int(round(alpha * 255.0)), dtype=torch.uint8, device=q.device)
    return torch.cat([q, a], dim=-1)


# ---- textures -------------------------------------------------------------------


def pack_texture_rgba8(texture, *, device=None) -> torch.Tensor:
    """fp32 (H, W, C) k/255 texture (numpy or tensor) -> packed RGBA int32
    (H, W) on `device` (default: where the texture is), word-equal to
    bhr_tpu's uint32 plane. A 3-channel texture gets alpha 255."""
    t = torch.as_tensor(texture, dtype=torch.float32)
    if device is not None:
        t = t.to(device)
    q = torch.round(torch.clamp(t, 0.0, 1.0) * 255.0).to(torch.int64)
    a = q[..., 3] if t.shape[-1] > 3 else torch.full_like(q[..., 0], 255)
    return _to_int32_bits(q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (a << 24))


def _byte(word: torch.Tensor, shift_bits: int) -> torch.Tensor:
    """Byte `shift_bits` / 8 of packed words as fp32 k/255 (the arithmetic
    shift's sign bits are masked away)."""
    return ((word >> shift_bits) & 0xFF).to(torch.float32) * _INV255


def _unpack_rgb(word: torch.Tensor):
    return _byte(word, 0), _byte(word, 8), _byte(word, 16)


def _equirect_uv(dx, dy, dz):
    """Direction planes -> equirect (u, v) in [0, 1] (wgsl:93-98). The
    divisors are tensors on the planes' device: CUDA turns division by a
    host scalar into a multiply by its reciprocal."""
    inv = rsqrt(dx * dx + dy * dy + dz * dz)
    u = 0.5 + torch.atan2(dz, dx) / on_device(6.28318530718, dx.device)
    v = 0.5 - torch.asin(torch.clamp(dy * inv, -1.0, 1.0)) / on_device(3.14159265359, dx.device)
    return u, v


def _footprint(u, v, w: int, h: int):
    """The bilinear footprint of (u, v): (x0, y0 unclamped, fx, fy)."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    return torch.remainder(x0f.to(torch.int64), w), y0f.to(torch.int64), x - x0f, y - y0f


def _nearest_index(u, v, w: int, h: int) -> torch.Tensor:
    """Flat texel index of wgpu's FilterMode::Nearest."""
    xn = torch.remainder(torch.floor(u * w).to(torch.int64), w)
    yn = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    return yn * w + xn


def _lerp2d(t00, t10, t01, t11, fx, fy):
    """The oracle's bilinear expression tree."""
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_bilinear(texture: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a float (H, W, C) texture, Repeat-U / Clamp-V."""
    h, w = texture.shape[0], texture.shape[1]
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    x1 = torch.remainder(x0 + 1, w)
    y0 = torch.clamp(y0f, 0, h - 1)
    y1 = torch.clamp(y0f + 1, 0, h - 1)
    return _lerp2d(texture[y0, x0], texture[y0, x1], texture[y1, x0], texture[y1, x1],
                   fx[..., None], fy[..., None])


def sample_equirect(texture: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Bilinear equirectangular sample of a float (H, W, C) k/255 texture
    at fp32 (..., 3) directions -> (..., C): the oracle the packed samplers
    are tested against (bhr_tpu/ops/sampling.py:26-34)."""
    uv = direction_to_equirectangular_uv(directions)
    return sample_bilinear(texture, uv[..., 0], uv[..., 1])


def sample_equirect_packed(packed_texture: torch.Tensor, dx, dy, dz, filter: str = "bilinear"):
    """(r, g, b) planes of a packed int32 (H, W) equirect texture sampled
    at the direction planes dx, dy, dz (bhr_tpu/ops/sampling.py:155-210 on
    the plain packed layout): filter "bilinear" reads the four corner
    texels and blends them in the oracle's order, "nearest" reads one."""
    if filter not in ("bilinear", "nearest"):
        raise ValueError(f"filter must be bilinear or nearest, got {filter!r}")
    h, w = packed_texture.shape
    u, v = _equirect_uv(dx, dy, dz)
    flat = packed_texture.reshape(-1)
    if filter == "nearest":
        return _unpack_rgb(flat[_nearest_index(u, v, w, h)])
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    x1 = torch.remainder(x0 + 1, w)
    y0w = torch.clamp(y0f, 0, h - 1) * w
    y1w = torch.clamp(y0f + 1, 0, h - 1) * w
    c00 = _unpack_rgb(flat[y0w + x0])
    c10 = _unpack_rgb(flat[y0w + x1])
    c01 = _unpack_rgb(flat[y1w + x0])
    c11 = _unpack_rgb(flat[y1w + x1])
    return tuple(_lerp2d(c00[k], c10[k], c01[k], c11[k], fx, fy) for k in range(3))


def _valid_weight(status: torch.Tensor) -> torch.Tensor:
    """1 where a ray's direction can be interpolated: not captured and not
    on the disk (those directions are frozen or belong to the disk)."""
    return ((status != STATUS_CAPTURED) & (status != STATUS_DISK)).to(torch.float32)


def _safe_inverse(den: torch.Tensor) -> torch.Tensor:
    """1 / den where den > 0, else 0."""
    return (1.0 / torch.clamp_min(den, 1e-6)) * (den > 0.0).to(torch.float32)


def sample_equirect_packed_subsampled(packed_texture, vx, vy, vz, status, sub: int,
                                      filter: str = "bilinear"):
    """Texture background sampled on a 1/`sub`-resolution direction grid
    and bilinearly upsampled (bhr_tpu/ops/sampling.py:359-402).

    Corner-aligned: low sample (i, j) uses the exact direction of full
    pixel (i * sub, j * sub), so those pixels keep their full-resolution
    colour bit for bit. Captured and disk samples are excluded from the
    interpolation by a weight plane, so the shadow's edge gets no colour
    halo; a pixel whose whole support is invalid shades black."""
    out_shape = vx.shape
    r, g, b = sample_equirect_packed(packed_texture, *(subsample(p, sub) for p in (vx, vy, vz)),
                                     filter=filter)
    w = subsample(_valid_weight(status), sub)
    inv = _safe_inverse(upsample_bilinear(w, sub, out_shape))
    return tuple(upsample_bilinear(c * w, sub, out_shape) * inv for c in (r, g, b))


def luma_pack_texture(packed: torch.Tensor):
    """Packed (H, W) texture -> the "luma" tier's tables, word-equal to
    bhr_tpu's (bhr_tpu/ops/sampling.py:405-442): (corner-packed luma
    (H + 1, W), chroma (H, W)), both int32.

    Luma L = round(mean(R, G, B)); word (row, x) of the luma table holds
    the four bilinear corner texels of L for a footprint whose top-left is
    (row - 1, x), Repeat-U and Clamp-V baked in (row 0 is the top edge).
    Chroma is (R - L, G - L, B - L) as three 9-bit biased ints."""
    r, g, b = _unpack_rgb(packed)
    li = torch.round((r + g + b) * float(np.float32(255.0 / 3.0))).to(torch.int64)
    h = packed.shape[0]
    c = li & 0xFF
    right = torch.roll(c, -1, dims=1)
    down = torch.cat([c[1:], c[h - 1:h]], dim=0)
    down_right = torch.roll(down, -1, dims=1)
    core = c | (right << 8) | (down << 16) | (down_right << 24)
    top = c[0:1] | (right[0:1] << 8) | (c[0:1] << 16) | (right[0:1] << 24)
    luma_cp = torch.cat([top, core], dim=0)

    def chan(x):
        return torch.round(x * 255.0).to(torch.int64) - li + 256  # 9-bit biased

    chroma = chan(r) | (chan(g) << 9) | (chan(b) << 18)
    return _to_int32_bits(luma_cp), chroma.to(torch.int32)


def sample_equirect_packed_luma(tex_pair, vx, vy, vz, status, chroma_sub: int = 2):
    """The "luma" tier's sampler (bhr_tpu/ops/sampling.py:453-520): exact
    bilinear luminance per pixel from the corner-packed luma table, plus
    nearest chroma on a corner-aligned 1/chroma_sub screen grid, upsampled
    with captured and disk samples excluded. Returns (r, g, b) planes."""
    luma_cp, chroma = tex_pair
    h = luma_cp.shape[0] - 1
    w = luma_cp.shape[1]
    out_shape = vx.shape
    u, v = _equirect_uv(vx, vy, vz)
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    word = luma_cp.reshape(-1)[torch.clamp(y0f + 1, 0, h) * w + x0]
    luma = _lerp2d(_byte(word, 0), _byte(word, 8), _byte(word, 16), _byte(word, 24), fx, fy)

    sub = max(int(chroma_sub), 1)
    us, vs = (subsample(p, sub) if sub > 1 else p for p in (u, v))
    cword = chroma.reshape(-1)[_nearest_index(us, vs, w, h)]

    def cchan(sh):
        return (((cword >> sh) & 0x1FF) - 256).to(torch.float32) * _INV255

    if sub == 1:
        return tuple(luma + cchan(sh) for sh in (0, 9, 18))
    wt = subsample(_valid_weight(status), sub)
    inv = _safe_inverse(upsample_bilinear(wt, sub, out_shape))
    return tuple(luma + upsample_bilinear(cchan(sh) * wt, sub, out_shape) * inv
                 for sh in (0, 9, 18))


def sample_equirect_packed_checkerboard(packed_texture, vx, vy, vz, status,
                                        filter: str = "bilinear"):
    """Texture background sampled for half the pixels, in a checkerboard
    (bhr_tpu/ops/sampling.py:537-671): pixels with (i + j) even sample the
    texture with their own direction and keep that colour bit for bit;
    each hole takes the mean of its valid distance-1 neighbours (captured
    and disk samples excluded by weight)."""
    h, w = vx.shape
    rgb_e = sample_equirect_packed(packed_texture, *(subsample(p, 2, 0) for p in (vx, vy, vz)),
                                   filter=filter)
    rgb_o = sample_equirect_packed(packed_texture, *(subsample(p, 2, 1) for p in (vx, vy, vz)),
                                   filter=filter)
    valid = _valid_weight(status)
    w_e = subsample(valid, 2, 0)
    w_o = subsample(valid, 2, 1)

    def weave(ce, co):
        """Even-set and odd-set planes -> (h, w) with zeros at the holes."""
        full = torch.zeros((h, w), dtype=torch.float32, device=ce.device)
        full[0::2, 0::2] = ce
        full[1::2, 1::2] = co
        return full

    def cross_sum(p):
        return shift(p, -1, 0) + shift(p, 1, 0) + shift(p, -1, 1) + shift(p, 1, 1)

    inv = _safe_inverse(cross_sum(weave(w_e, w_o)))
    ii = torch.arange(h, device=vx.device)[:, None]
    jj = torch.arange(w, device=vx.device)[None, :]
    hole = ((ii + jj) & 1).to(torch.float32)
    out = []
    for k in range(3):
        n4 = cross_sum(weave(rgb_e[k] * w_e, rgb_o[k] * w_o))
        out.append(weave(rgb_e[k], rgb_o[k]) * (1.0 - hole) + hole * n4 * inv)
    return tuple(out)
