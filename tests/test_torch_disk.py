"""The accretion disk (models/disk.py), the tonemaps (ops/display.py), the
step heatmap (ops/heatmap.py) and the shading epilogue's disk, debug and
tonemap branches (ops/shading.py) against bhr_tpu on identical numpy
inputs, and the port's disk frame against tests/golden/disk_64.png."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import disk as jdisk
from bhr_tpu.ops import display as jdisplay
from bhr_tpu.ops import heatmap as jheat
from bhr_tpu.ops import pallas_trace as jpt
from bhr_tpu.ops import shading as jshade
from bhr_tpu.ops import starfield as jstar
from bhr_tpu_torch.io import image as timage
from bhr_tpu_torch.models import disk as tdisk
from bhr_tpu_torch.ops import display as tdisplay
from bhr_tpu_torch.ops import heatmap as theat
from bhr_tpu_torch.ops import shading as tshade
from bhr_tpu_torch.ops import starfield as tstar

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_blackbody_luts_equal_jax():
    """The port's numpy copy of the LUT builder gives bhr_tpu's tables bit
    for bit: the staged epilogue's 512 entries and the fast kernel's
    channel-major 128."""
    np.testing.assert_array_equal(tdisk.blackbody_lut_np(), jdisk.blackbody_lut_np())
    assert tdisk.blackbody_lut_np().shape == (512, 3)
    np.testing.assert_array_equal(_np(tdisk.blackbody_lut()), np.asarray(jdisk.blackbody_lut()))
    np.testing.assert_array_equal(tdisk.kernel_lut_np(), jpt._disk_lut_smem_np())
    assert tdisk.kernel_lut_np().shape == (3 * tdisk.KERNEL_LUT_STEPS,)


def test_disk_params_for_scene_match_jax():
    j = jdisk.DiskParams.for_scene(jnp.float32(2.0))
    t = tdisk.DiskParams.for_scene(torch.tensor(2.0))
    for f in ("r_isco", "r_outer", "t_isco"):
        assert float(getattr(t, f)) == float(getattr(j, f))
        assert getattr(t, f).dtype == torch.float32


def _segments(n=20000, seed=3):
    rng = np.random.RandomState(seed)
    old = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    new = (old + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    old[:, 1] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    new[:, 1] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    old[:4, 1] = [0.0, 0.1, -0.1, 0.0]  # touching the plane does not cross it
    new[:4, 1] = [0.1, 0.0, 0.0, 0.0]
    return old, new


def test_intersect_equatorial_matches_jax():
    """The oracle's form, exactly; and the fast form (t by a reciprocal,
    r^2 test of x and z) classifies the same segments but for crossings
    within rounding of an annulus edge."""
    old, new = _segments()
    r_isco, r_outer = np.float32(6.0), np.float32(20.0)
    jhit, jpos = jdisk.intersect_equatorial(jnp.asarray(old), jnp.asarray(new), r_isco, r_outer)
    thit, tpos = tdisk.intersect_equatorial(torch.from_numpy(old), torch.from_numpy(new),
                                            torch.tensor(r_isco), torch.tensor(r_outer))
    np.testing.assert_array_equal(_np(thit), np.asarray(jhit))
    m = np.asarray(jhit)
    assert 0.05 < m.mean() < 0.95 and not m[:4].any()
    np.testing.assert_allclose(_np(tpos)[m], np.asarray(jpos)[m], rtol=0, atol=1e-5)
    fhit, fpos = tdisk.intersect_equatorial_fast(torch.from_numpy(old), torch.from_numpy(new),
                                                 torch.tensor(r_isco), torch.tensor(r_outer))
    assert (_np(fhit) == m).mean() >= 0.999
    assert (_np(fpos)[:, 1] == 0.0).all()
    np.testing.assert_allclose(_np(fpos)[m][:, [0, 2]], np.asarray(jpos)[m][:, [0, 2]], atol=1e-5)


def _disk_points(n=20000, seed=4):
    rng = np.random.RandomState(seed)
    r = rng.uniform(6.0, 20.0, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    hit = np.stack([r * np.cos(phi), np.zeros(n), r * np.sin(phi)], -1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return hit, d.astype(np.float32)


def test_disk_emission_matches_jax():
    """Keplerian velocity, the g-factor, T(r), the LUT sample and the
    emission, each against bhr_tpu: rtol 2e-6 (a few ulps; pow, sqrt and
    the LUT lerp are evaluated by two libraries), colours within 2e-6."""
    hit, d = _disk_points()
    rs, obs = np.float32(2.0), np.float32(20.223748)
    jp = jdisk.DiskParams.for_scene(rs)
    tp = tdisk.DiskParams.for_scene(torch.tensor(rs))
    jh, jd = jnp.asarray(hit), jnp.asarray(d)
    th, td = torch.from_numpy(hit), torch.from_numpy(d)
    trs, tobs = torch.tensor(rs), torch.tensor(obs)

    def close(got, want, rtol=2e-6, atol=0.0):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)

    close(tdisk.keplerian_velocity(th, trs), jdisk.keplerian_velocity(jh, rs), atol=1e-7)
    close(tdisk.redshift_factor(th, td, tobs, trs), jdisk.redshift_factor(jh, jd, obs, rs))
    r = np.linalg.norm(hit, axis=-1).astype(np.float32)
    close(tdisk.disk_temperature(torch.from_numpy(r), tp.r_isco, tp.t_isco),
          jdisk.disk_temperature(jnp.asarray(r), jp.r_isco, jp.t_isco))
    temps = np.linspace(500.0, 35000.0, 4001, dtype=np.float32)
    close(tdisk.temperature_to_color(torch.from_numpy(temps)),
          jdisk.temperature_to_color(jnp.asarray(temps)), rtol=0, atol=2e-6)
    got = tdisk.disk_emission(th, td, tobs, trs, tp, tdisk.blackbody_lut())
    want = jdisk.disk_emission(jh, jd, obs, rs, jp, jdisk.blackbody_lut())
    assert got.shape == (hit.shape[0], 3) and float(got.max()) > 0.5
    close(got, want, rtol=1e-5, atol=2e-6)


def test_shade_disk_planes_tracks_disk_emission():
    """The fast kernel's plane form (rsqrt-based T(r), 128-entry table,
    indexed lerp) is the staged disk_emission in other words: after
    quantization the two agree within 1 level on >= 99% of points and
    within 3 everywhere (the 128-entry table against the 512-entry one)."""
    hit, d = _disk_points()
    rs = torch.tensor(2.0)
    p = tdisk.DiskParams.for_scene(rs)
    obs = torch.tensor(20.223748)
    th, td = torch.from_numpy(hit), torch.from_numpy(d)
    staged = tdisk.disk_emission(th, td, obs, rs, p, tdisk.blackbody_lut())
    planes = tdisk.shade_disk_planes(th[:, 0], th[:, 2], td, rs, p.r_isco, p.r_outer, p.t_isco,
                                     obs, torch.from_numpy(tdisk.kernel_lut_np()))
    q = lambda c: torch.round(torch.clamp(c, 0, 1) * 255)  # noqa: E731
    diff = torch.stack([(q(a) - q(staged[:, k])).abs() for k, a in enumerate(planes)], -1)
    diff = diff.amax(-1)
    assert (diff <= 1).float().mean() >= 0.99 and int(diff.max()) <= 3


def test_tonemaps_and_quad_match_jax():
    x = np.concatenate([np.linspace(-0.5, 2.0, 20001), [0.0031308, 0.5, 1.0]]).astype(np.float32)
    assert sorted(tdisplay.TONEMAPS) == sorted(jdisplay.TONEMAPS)
    for name, fn in tdisplay.TONEMAPS.items():
        got = fn(torch.from_numpy(x))
        want = jdisplay.TONEMAPS[name](jnp.asarray(x))
        # srgb's pow(c, 1/2.4) is evaluated by two libraries: 2 ulps
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-7, atol=1e-7)
    assert [v.position for v in tdisplay.QUAD_VERTICES] == [
        v.position for v in jdisplay.QUAD_VERTICES]


def test_steps_to_color_matches_jax():
    steps = np.arange(0, 501, dtype=np.int32)
    for max_steps in (500, 200, 7):
        got = theat.steps_to_color(torch.from_numpy(steps), max_steps)
        want = jheat.steps_to_color(jnp.asarray(steps), max_steps)
        assert got.dtype == torch.float32 and got.shape == (501, 3)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1.2e-7)


def _jax_result(cam, disk, max_steps=200, w=48, h=32, integrator="rk4"):
    jc = J.Camera.new(*cam)
    js = J.SceneParams(screen_width=w, screen_height=h, max_steps=max_steps)
    origins, dirs = J.generate_rays(jc, w, h, js.fov)
    res = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius, js.spin,
                       max_steps, J.TraceConfig(integrator=integrator, adaptive=True, disk=disk))
    tres = T.TraceResult(*(torch.from_numpy(np.array(getattr(res, f))) for f in (
        "final_pos", "final_vel", "status", "steps")))
    return jc, js, res, tres


@pytest.mark.parametrize(
    "branch", ["debug", "disk", "reinhard", "srgb", "disk_srgb"])
def test_shade_planes_packed_branches_match_jax(branch):
    """One shared TraceResult (the JAX oracle's, rk4 with adaptive dt and
    the disk from the golden disk camera) through both epilogues: the
    debug heatmap, the disk's emission and the tonemaps. Packed words are
    bit-equal on >= 99% of pixels and within 1 level everywhere (a few
    ulps in pow, sqrt and the heatmap's multiply-add flip a half-level
    rounding here and there)."""
    cam = ([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    disk = "disk" in branch
    jc, js, res, tres = _jax_result(cam, disk=True)
    tm_name = {"reinhard": "reinhard", "srgb": "srgb", "disk_srgb": "srgb"}.get(branch)
    jkw = dict(debug_mode=1 if branch == "debug" else 0, bh_pos=js.black_hole_position,
               rs=js.schwarzschild_radius, camera_position=jc.position)
    tkw = dict(debug_mode=jkw["debug_mode"], bh_pos=torch.zeros(3), rs=torch.tensor(2.0),
               camera_position=torch.tensor(np.asarray(jc.position)))
    if disk:
        jkw.update(disk_params=jdisk.DiskParams.for_scene(js.schwarzschild_radius),
                   blackbody_lut=jdisk.blackbody_lut())
        tkw.update(disk_params=tdisk.DiskParams.for_scene(torch.tensor(2.0)),
                   blackbody_lut=tdisk.blackbody_lut())
    if tm_name:
        jkw["tonemap"] = jdisplay.TONEMAPS[tm_name]
        tkw["tonemap"] = tdisplay.TONEMAPS[tm_name]
    want = np.asarray(jshade.shade_planes_packed(
        res, functools.partial(jstar.procedural_background, seed=2020), 200, **jkw))
    got = _np(tshade.shade_planes_packed(
        tres, functools.partial(tstar.procedural_background, seed=2020), 200, **tkw))
    assert got.dtype == np.int32 and got.shape == want.shape
    same = got.view(np.uint32) == want
    g = got.view(np.uint8).reshape(*got.shape, 4).astype(int)
    w = want.view(np.uint8).reshape(*want.shape, 4).astype(int)
    assert same.mean() >= 0.99 and np.abs(g - w).max() <= 1, (same.mean(), np.abs(g - w).max())
    if disk:
        is_disk = np.asarray(res.status) == 3
        assert is_disk.mean() > 0.2 and (g[is_disk][:, :3].max(-1) > 0).mean() > 0.9


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_golden_disk_port(fast):
    """The port's disk renderer (Euler, fixed dt) against
    the oracle's golden image, under the rule of tests/test_golden.py:20-54:
    at most 0.5% of pixels off by more than 1 level. The exact tier goes
    through the staged path, the fast tier through the monolithic disk."""
    r = T.BlackHoleRenderer(64, 64, device="cpu", disk=True, fast_math=fast)
    cam = T.Camera.new([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    frame = r.render_frame(cam, T.SceneParams(screen_width=64, screen_height=64, max_steps=400))
    golden = timage.read_png(os.path.join(GOLDEN_DIR, "disk_64.png")).astype(np.int32)
    got = frame.numpy().astype(np.int32)
    assert got.shape == golden.shape == (64, 64, 4)
    bad = (np.abs(got - golden).max(-1) > 1).mean()
    assert bad <= 0.005, f"{bad:.4%} of pixels differ by more than 1 level"
