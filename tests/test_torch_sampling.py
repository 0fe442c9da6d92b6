"""The port's texture samplers (bhr_tpu_torch/ops/sampling.py) against
bhr_tpu/ops/sampling.py: the same packed texture and the same direction
planes through both packages, for the bilinear, nearest, luma, subsampled
and checkerboard tiers.

Bars. atan2 and asin differ by an ulp between XLA's CPU lowering and
PyTorch's, so a direction near a texel's edge may pick the neighbouring
footprint: colours are held, not indices. Every channel agrees within the
tier's tolerance on >= 99.5% of samples, and the rest within one texel's
contrast (the largest difference between 4-neighbour texels, which bounds
what a neighbouring footprint can change). The tolerance is 1e-6 for the
nearest tiers. A tier that interpolates multiplies u's ulp by the
texture's width before it becomes a blend weight (fx = u W - floor(..)),
so an ulp of u (6e-8) moves a colour of this 64-wide random texture by up
to 4e-6: those tiers are held to 1e-5 (measured: 95% within 1e-6, all
within 6.1e-6). On directions built to sit on texel centres nearest is
bhr_tpu's exactly and the texel's own value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu_torch as T
from bhr_tpu.ops import sampling as js
from bhr_tpu_torch.ops import sampling as ts
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, STATUS_DISK, STATUS_ESCAPED

TH, TW = 32, 64
SH, SW = 40, 56  # the direction planes' "screen"
CLOSE, CLOSE_LERP, CLOSE_MIN = 1e-6, 1e-5, 0.995


def _tol(name):
    return CLOSE if name.startswith("nearest") else CLOSE_LERP


FILTERS = ["bilinear", "nearest", "luma", "bilinear-sub2", "bilinear-sub3", "nearest-sub2",
           "bilinear-checker", "nearest-checker", "luma-sub3"]


def _texture(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (TH, TW, 4)).astype(np.float32) / 255.0


def _contrast(tex):
    """The largest channel difference between 4-neighbour texels."""
    dx = np.abs(tex - np.roll(tex, 1, axis=1)).max()
    dy = np.abs(tex[1:] - tex[:-1]).max()
    return float(max(dx, dy))


def _smooth_directions(seed=1):
    """A smooth (SH, SW) field of unit directions, like a deflection field,
    with the U seam and both poles inside it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, SH), np.linspace(-1, 1, SW), indexing="ij")
    lon = np.pi * (xx * 1.2 + 0.15 * np.sin(3 * yy)) + rng.uniform(-0.2, 0.2)
    lat = 0.5 * np.pi * np.clip(yy * 1.1, -1, 1)
    d = np.stack([np.cos(lat) * np.cos(lon), np.sin(lat), np.cos(lat) * np.sin(lon)], -1)
    d[0, :3] = [0.0, 1.0, 0.0]   # the poles themselves
    d[-1, :3] = [0.0, -1.0, 0.0]
    d[5, 5] = [-1.0, 0.0, 0.0]   # the seam: atan2(+-0, -1)
    d[5, 6] = [-1.0, 0.0, -1e-7]
    return d.astype(np.float32)


def _status(seed=2):
    rng = np.random.default_rng(seed)
    st = np.full((SH, SW), STATUS_ESCAPED, np.int32)
    st[12:26, 20:38] = STATUS_CAPTURED  # a shadow
    st[30:33, 5:50] = STATUS_DISK
    st[rng.random((SH, SW)) < 0.02] = 0  # a few exhausted rays
    return st


def _both(name, tex, d, st):
    """(port colours, bhr_tpu colours) as (..., 3) arrays for tier `name`."""
    filt, _, sub = name.partition("-")
    packed_j = js.pack_texture_rgba8(tex)
    packed_t = ts.pack_texture_rgba8(tex)
    tj = [jnp.asarray(d[..., k]) for k in range(3)]
    tt = [torch.from_numpy(np.ascontiguousarray(d[..., k])) for k in range(3)]
    sj, st_t = jnp.asarray(st), torch.from_numpy(st)
    if filt == "luma":
        cs = int(sub[3:]) if sub else 2
        want = js.sample_equirect_packed_luma(js.luma_pack_texture(packed_j), *tj, sj,
                                              chroma_sub=cs)
        got = ts.sample_equirect_packed_luma(ts.luma_pack_texture(packed_t), *tt, st_t,
                                             chroma_sub=cs)
    elif sub == "checker":
        want = js.sample_equirect_packed_checkerboard(packed_j, *tj, sj, filter=filt)
        got = ts.sample_equirect_packed_checkerboard(packed_t, *tt, st_t, filter=filt)
    elif sub:
        want = js.sample_equirect_packed_subsampled(packed_j, *tj, sj, int(sub[3:]), filter=filt)
        got = ts.sample_equirect_packed_subsampled(packed_t, *tt, st_t, int(sub[3:]),
                                                   filter=filt)
    else:
        want = js.sample_equirect_packed(packed_j, *tj, filter=filt)
        got = ts.sample_equirect_packed(packed_t, *tt, filter=filt)
    return (np.stack([g.numpy() for g in got], -1), np.stack([np.asarray(w) for w in want], -1))


@pytest.mark.parametrize("name", FILTERS)
def test_sampler_matches_jax(name):
    tex = _texture()
    got, want = _both(name, tex, _smooth_directions(), _status())
    diff = np.abs(got - want).max(-1)
    assert (diff <= _tol(name)).mean() >= CLOSE_MIN, (diff <= _tol(name)).mean()
    assert diff.max() <= _contrast(tex) + CLOSE, diff.max()
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", ["bilinear", "nearest"])
def test_sampler_matches_jax_on_random_directions(name):
    rng = np.random.default_rng(5)
    d = rng.standard_normal((SH, SW, 3)).astype(np.float32)
    d *= rng.uniform(0.5, 2.0, (SH, SW, 1)).astype(np.float32)  # the samplers normalise
    tex = _texture(3)
    got, want = _both(name, tex, d, _status())
    diff = np.abs(got - want).max(-1)
    assert (diff <= _tol(name)).mean() >= CLOSE_MIN
    assert diff.max() <= _contrast(tex) + CLOSE


def _texel_centre_directions():
    """One direction per texel of a (TH, TW) map, through the texel's
    centre (u, v) = ((x + 0.5) / W, (y + 0.5) / H)."""
    u = (np.arange(TW) + 0.5) / TW
    v = (np.arange(TH) + 0.5) / TH
    lon = (u[None, :] - 0.5) * 2 * np.pi
    lat = (0.5 - v[:, None]) * np.pi
    return np.stack([np.cos(lat) * np.cos(lon), np.sin(lat) * np.ones_like(lon),
                     np.cos(lat) * np.sin(lon)], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["bilinear", "nearest", "luma"])
def test_texel_centres_are_exact(name):
    """At a texel's centre every tier returns that texel (luma with
    chroma_sub 1 here): nearest exactly, the interpolating tiers within
    the rounding of a footprint weight that is 0 or 1."""
    tex = _texture(7)
    d = _texel_centre_directions()
    st = np.full((TH, TW), STATUS_ESCAPED, np.int32)
    if name == "luma":
        tj = [jnp.asarray(d[..., k]) for k in range(3)]
        tt = [torch.from_numpy(np.ascontiguousarray(d[..., k])) for k in range(3)]
        want = np.stack([np.asarray(c) for c in js.sample_equirect_packed_luma(
            js.luma_pack_texture(js.pack_texture_rgba8(tex)), *tj, jnp.asarray(st),
            chroma_sub=1)], -1)
        got = np.stack([c.numpy() for c in ts.sample_equirect_packed_luma(
            ts.luma_pack_texture(ts.pack_texture_rgba8(tex)), *tt, torch.from_numpy(st),
            chroma_sub=1)], -1)
    else:
        got, want = _both(name, tex, d, st)
    # a centre is 0.5 texel from every footprint edge in nearest, and on a
    # footprint corner in the interpolating tiers, whose weight is 1 up to
    # the rounding of the fp32 direction and of u W (2e-5 here)
    tol = 0.0 if name == "nearest" else 2e-5
    np.testing.assert_allclose(got, tex[..., :3], rtol=0, atol=tol + 1e-7)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(name))
    if name == "nearest":
        np.testing.assert_array_equal(got, want)


def test_packed_bilinear_matches_the_float_oracle():
    """The packed 4-read bilinear equals the float-texture oracle
    sample_equirect (the wgpu sampler's definition) on the same
    directions, up to the oracle's own sqrt-normalised uv."""
    tex = _texture(9)
    d = _smooth_directions(4)
    packed = ts.pack_texture_rgba8(tex)
    got = torch.stack(ts.sample_equirect_packed(packed, *torch.from_numpy(d).unbind(-1)), -1)
    want = ts.sample_equirect(torch.from_numpy(tex), torch.from_numpy(d))[..., :3]
    diff = (got - want).abs().amax(-1).numpy()
    assert (diff <= 1e-5).mean() >= CLOSE_MIN and diff.max() <= _contrast(tex) + 1e-5
    want_j = np.asarray(js.sample_equirect(jnp.asarray(tex), jnp.asarray(d)))[..., :3]
    dj = np.abs(want.numpy() - want_j).max(-1)
    assert (dj <= 1e-5).mean() >= CLOSE_MIN


def test_uv_mapping_matches_jax():
    d = _smooth_directions(6)
    got = T.direction_to_equirectangular_uv(torch.from_numpy(d)).numpy()
    from bhr_tpu.core.math import direction_to_equirectangular_uv as j_uv

    np.testing.assert_allclose(got, np.asarray(j_uv(jnp.asarray(d))), rtol=0, atol=2e-7)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("name", ["bilinear-sub2", "bilinear-checker", "luma"])
def test_no_capture_halo(name):
    """Captured and disk samples are excluded from the interpolation
    (bhr_tpu tests/test_sampling.py:410): on a constant texture every
    pixel with a valid sample in its support keeps the texture's colour
    exactly -- no black bleed around the shadow -- and a pixel without one
    is 0."""
    tex = np.full((TH, TW, 4), 200 / 255.0, np.float32)
    st = _status()
    got, want = _both(name, tex, _smooth_directions(), st)
    np.testing.assert_allclose(got, want, rtol=0, atol=CLOSE)
    value = np.float32(200) * np.float32(1.0 / 255.0)
    lit = got.max(-1) > 0
    np.testing.assert_allclose(got[lit], value, rtol=0, atol=2e-6)
    escaped = (st != STATUS_CAPTURED) & (st != STATUS_DISK)
    if name == "luma":  # the luminance is per pixel: every pixel is lit
        assert lit.all()
    else:  # every pixel whose own sample is valid and sampled is lit
        sub = 2
        own = np.zeros_like(escaped)
        own[::sub, ::sub] = escaped[::sub, ::sub]
        if name.endswith("checker"):
            ii, jj = np.indices(st.shape)
            own = ((ii + jj) % 2 == 0)  # sampled pixels keep their colour, valid or not
        assert lit[own].all()


@pytest.mark.parametrize("sub", [2, 3])
def test_subsampled_keeps_phase_zero_pixels(sub):
    """Low sample (i, j) uses the direction of full pixel (i sub, j sub),
    so those pixels keep their full-resolution colour bit for bit."""
    tex = _texture(11)
    d = torch.from_numpy(_smooth_directions(8))
    st = torch.full((SH, SW), STATUS_ESCAPED, dtype=torch.int32)
    packed = ts.pack_texture_rgba8(tex)
    full = ts.sample_equirect_packed(packed, *d.unbind(-1))
    low = ts.sample_equirect_packed_subsampled(packed, *d.unbind(-1), st, sub)
    for f, lo in zip(full, low):
        torch.testing.assert_close(lo[::sub, ::sub], f[::sub, ::sub], rtol=0, atol=0)
    chk = ts.sample_equirect_packed_checkerboard(packed, *d.unbind(-1), st)
    ii, jj = np.indices((SH, SW))
    even = torch.from_numpy((ii + jj) % 2 == 0)
    for f, c in zip(full, chk):
        torch.testing.assert_close(c[even], f[even], rtol=0, atol=0)


def test_unknown_filter_raises():
    packed = ts.pack_texture_rgba8(_texture())
    z = torch.ones(2, 2)
    with pytest.raises(ValueError, match="filter"):
        ts.sample_equirect_packed(packed, z, z, z, filter="trilinear")
