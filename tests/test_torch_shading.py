"""Shading stage of bhr_tpu_torch against bhr_tpu on identical inputs: the
analytic star field, its integer hash, frame packing and the planar
shading epilogue."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.ops import sampling as jsamp
from bhr_tpu.ops import shading as jshade
from bhr_tpu.ops import starfield as jstar
from bhr_tpu_torch.ops import sampling as tsamp
from bhr_tpu_torch.ops import shading as tshade
from bhr_tpu_torch.ops import starfield as tstar

W, H, STEPS = 48, 32, 200


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _directions(n=100_000, seed=11):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d *= rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)  # not unit: the field normalises
    d[:6] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 1, 1]],
                     np.float32)  # x_major / y_major tie-breaks
    return d


def _correctly_rounded_rsqrt(x):
    return jnp.asarray((1.0 / np.sqrt(np.asarray(x, np.float64))).astype(np.float32))


def _torch_field(d, seed):
    return tstar.procedural_background(*(torch.from_numpy(d[:, k].copy()) for k in range(3)),
                                       seed=seed)


@pytest.mark.parametrize("seed", [2020, 7])
def test_procedural_background_matches_jax(seed, monkeypatch):
    """The port against bhr_tpu's star field evaluated op by op (eager, so
    XLA fuses and contracts nothing), with one op swapped: JAX's CPU
    rsqrt is not correctly rounded (an ulp off on ~14% of inputs), while
    the port's rsqrt is, as the exact-tier kernel's __frsqrt_rn is."""
    d = _directions()
    monkeypatch.setattr(jax.lax, "rsqrt", _correctly_rounded_rsqrt)
    want = jstar.procedural_background(*(jnp.asarray(d[:, k]) for k in range(3)), seed=seed)
    got = _torch_field(d, seed)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (d.shape[0],)
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-6, rtol=0)
    # the field is not empty: some directions land on bright stars
    assert max(float(c.max()) for c in got) > 0.5


def test_procedural_background_matches_unmodified_jax():
    """Against the unmodified function: bit-equal wherever JAX's rsqrt is
    correctly rounded. Elsewhere its ulp in the normalised direction moves
    the in-face coordinate by ~48 ulp, which a star's steep falloff
    (1 - 18 d^2)^4 amplifies to at most ~1e-4."""
    d = _directions()
    want = jstar.procedural_background(*(jnp.asarray(d[:, k]) for k in range(3)))
    got = _torch_field(d, 2020)
    n2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    same_rsqrt = np.asarray(jax.lax.rsqrt(jnp.asarray(n2))) == np.asarray(
        _correctly_rounded_rsqrt(n2))
    assert same_rsqrt.mean() > 0.8
    for g, w in zip(got, want):
        diff = np.abs(_np(g) - np.asarray(w))
        assert diff[same_rsqrt].max() == 0.0
        assert diff.max() <= 1e-4


def test_hash_matches_jax_uint32():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jax.jit(jstar._hash)(x))
    got = tstar._hash(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_np(got).astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(_np(tstar._unit(got)), np.asarray(jstar._unit(want)))


@pytest.mark.parametrize("seed", [0, 1, 2020, 2**31 + 5, 10**12])
def test_seed_term_matches_jax(seed):
    assert tstar.seed_term(seed) == int(jnp.uint32(seed * 2654435761 & 0xFFFFFFFF))


def _planes(n=(H, W), seed=4):
    rng = np.random.RandomState(seed)
    planes = rng.uniform(-0.2, 1.2, (3, *n)).astype(np.float32)
    # exact half-level ties, where the two rounding rules part
    planes[:, 0, :8] = (np.arange(8, dtype=np.float32) + 0.5) / 255.0
    return planes


def test_pack_and_unpack_match_jax():
    planes = _planes()
    want = np.asarray(jsamp.pack_rgba8_planes(*planes))
    got = tsamp.pack_rgba8_planes(*(torch.from_numpy(p) for p in planes))
    assert got.dtype == torch.int32 and got.shape == (H, W)
    np.testing.assert_array_equal(_np(got).view(np.uint32), want)
    np.testing.assert_array_equal(_np(tsamp.unpack_frame(got)),
                                  np.asarray(jsamp.unpack_frame(jnp.asarray(want))))
    assert (_np(tsamp.unpack_frame(got))[..., 3] == 255).all()


def test_pack_half_up_rounds_ties_up():
    ties = torch.tensor([0.5, 1.5, 2.5, 254.5]) / 255.0
    x = torch.clamp(ties, 0.0, 1.0) * 255.0
    half_up = tsamp.unpack_frame(tsamp.pack_rgba8_planes(ties, ties, ties, half_up=True))
    even = tsamp.unpack_frame(tsamp.pack_rgba8_planes(ties, ties, ties))
    assert half_up[:, 0].tolist() == torch.floor(x + 0.5).int().tolist()
    assert even[:, 0].tolist() == torch.round(x).int().tolist()


def test_quantize_rgba8_matches_jax():
    rgb = np.moveaxis(_planes(), 0, -1).copy()
    want = np.asarray(jsamp.quantize_rgba8(jnp.asarray(rgb)))
    got = tsamp.quantize_rgba8(torch.from_numpy(rgb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), want)


def test_shade_planes_packed_matches_jax():
    """One shared TraceResult (the JAX oracle's) through both epilogues
    gives the same packed frame, bit for bit."""
    cam = J.Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene = J.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    origins, dirs = J.generate_rays(cam, W, H, scene.fov)
    res = J.trace_rays(origins, dirs, scene.black_hole_position, scene.schwarzschild_radius,
                       scene.spin, STEPS)
    want = np.asarray(jshade.shade_planes_packed(
        res, functools.partial(jstar.procedural_background, seed=2020), STEPS))
    tres = T.TraceResult(*(torch.from_numpy(np.array(getattr(res, f))) for f in (
        "final_pos", "final_vel", "status", "steps")))
    got = tshade.shade_planes_packed(
        tres, functools.partial(tstar.procedural_background, seed=2020), STEPS)
    np.testing.assert_array_equal(_np(got).view(np.uint32), want)
    black = (_np(tsamp.unpack_frame(got))[..., :3] == 0).all(-1)
    assert 0.2 < black.mean() < 0.8  # the shadow and the sky are both in view


@pytest.mark.parametrize(
    "kw",
    [dict(debug_mode=1), dict(disk=True), dict(lut=True), dict(tonemap=lambda c: c * 0.5)],
    ids=["debug", "disk", "lut", "tonemap"],
)
def test_shade_planes_packed_branches(kw):
    """The epilogue's branches beyond the star field (they raised before
    this slice; tests/test_torch_disk.py holds each against bhr_tpu): the
    debug view is the step heatmap, a disk ray takes the emission of
    models/disk.disk_emission with the given LUT (the default 512-entry
    table when `lut` is None), and a tonemap is applied to every plane."""
    res = T.TraceResult(
        torch.tensor([[[8.0, 0.0, 0.0], [0.0, 0.0, 9.0]]]),
        torch.tensor([[[0.0, 0.6, 0.8], [0.6, 0.0, 0.8]]]),
        torch.tensor([[3, 1]], dtype=torch.int32), torch.tensor([[7, 10]], dtype=torch.int32))
    bg = functools.partial(tstar.procedural_background, seed=2020)
    plain = tshade.shade_planes_packed(res, bg, 10)
    if "debug_mode" in kw:
        got = tshade.shade_planes_packed(res, bg, 10, **kw)
        rgb = T.ops.heatmap.steps_to_color(res.steps, 10)
        torch.testing.assert_close(got, tsamp.pack_rgba8_planes(*rgb.unbind(-1)))
        return
    if "tonemap" in kw:
        got = tshade.shade_planes_packed(res, bg, 10, **kw)
        r, g, b = bg(*res.final_vel.unbind(-1))
        torch.testing.assert_close(got, tsamp.pack_rgba8_planes(r * 0.5, g * 0.5, b * 0.5))
        return
    params = T.models.disk.DiskParams.for_scene(torch.tensor(2.0))
    lut = T.models.disk.blackbody_lut() if "lut" in kw else None
    got = tshade.shade_planes_packed(res, bg, 10, bh_pos=torch.zeros(3), rs=torch.tensor(2.0),
                                     camera_position=torch.tensor([0.0, 3.0, 20.0]),
                                     disk_params=params, blackbody_lut=lut)
    emission = T.models.disk.disk_emission(res.final_pos, res.final_vel,
                                           torch.tensor(409.0).sqrt(), torch.tensor(2.0),
                                           params)
    want = tsamp.pack_rgba8_planes(*emission[0, 0])
    assert int(got[0, 0]) == int(want) and int(got[0, 1]) == int(plain[0, 1])
