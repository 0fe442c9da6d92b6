"""bhr_tpu_torch data model and ray-gen against bhr_tpu on identical inputs:
vector math, Camera, SceneParams, generate_rays, orbit_camera and the
kernel's 32-float parameter vector."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.core import math as jmath
from bhr_tpu.ops.pallas_trace import build_params as jax_build_params
from bhr_tpu_torch.core import math as tmath
from bhr_tpu_torch.ops import trace_kernel

CAMERAS = [
    ([0.0, 5.0, 15.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ([-3.5, 1.25, 22.0], [0.5, -0.25, 0.0], [0.1, 1.0, 0.2]),
]


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_camera_close(tc, jc, atol):
    for field in ("position", "forward", "right", "up"):
        np.testing.assert_allclose(_np(getattr(tc, field)), _np(getattr(jc, field)),
                                   atol=atol, err_msg=field)


def _twin_camera(jc):
    return T.camera_from_numpy(*(np.asarray(x) for x in (jc.position, jc.forward, jc.right,
                                                          jc.up)))


@pytest.mark.parametrize("fn", ["dot", "cross", "normalize"])
def test_vector_math_matches_jax(fn):
    rng = np.random.RandomState(1)
    a = rng.randn(1000, 3).astype(np.float32)
    b = rng.randn(1000, 3).astype(np.float32)
    a[0] = 0.0  # normalize's zero-length guard
    if fn == "normalize":
        got, want = tmath.normalize(torch.from_numpy(a)), jmath.normalize(jnp.asarray(a))
    else:
        got = getattr(tmath, fn)(torch.from_numpy(a), torch.from_numpy(b))
        want = getattr(jmath, fn)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def test_scene_defaults_match_jax():
    js, ts = J.SceneParams(), T.SceneParams()
    for name in ("black_hole_position", "schwarzschild_radius", "fov", "spin"):
        np.testing.assert_array_equal(_np(getattr(ts, name)), np.asarray(getattr(js, name)))
    for name in ("screen_width", "screen_height", "max_steps", "debug_mode"):
        assert getattr(ts, name) == getattr(js, name)
    assert (T.DEFAULT_DT, T.ESCAPE_RADIUS, T.CAPTURE_FACTOR) == (
        J.core.scene.DEFAULT_DT, J.core.scene.ESCAPE_RADIUS, J.core.scene.CAPTURE_FACTOR)
    assert (T.DEBUG_NONE, T.DEBUG_STEPS) == (J.core.scene.DEBUG_NONE,
                                             J.core.scene.DEBUG_STEPS)


@pytest.mark.parametrize("cam", CAMERAS, ids=["default", "side", "tilted"])
def test_camera_new_matches_jax(cam):
    _assert_camera_close(T.Camera.new(*cam), J.Camera.new(*cam), atol=1e-6)
    _assert_camera_close(T.Camera.look_at(*cam), J.Camera.look_at(*cam), atol=1e-6)


def test_camera_default_matches_jax():
    _assert_camera_close(T.Camera.default(), J.Camera.default(), atol=1e-6)


@pytest.mark.parametrize("t", [0.0, 1.0 / 60.0, 0.75, 7.5, 21.0])
def test_orbit_camera_matches_jax(t):
    _assert_camera_close(T.orbit_camera(t), J.orbit_camera(t), atol=1e-6)
    _assert_camera_close(T.orbit_camera(t, radius=22.0, height=-3.0, rotation_speed=0.7),
                         J.orbit_camera(t, radius=22.0, height=-3.0, rotation_speed=0.7),
                         atol=1e-6)


@pytest.mark.parametrize("size", [(48, 32), (37, 23), (64, 64)])
@pytest.mark.parametrize("cam", CAMERAS[:2], ids=["default", "side"])
def test_generate_rays_matches_jax(size, cam):
    w, h = size
    jc = J.Camera.new(*cam)
    jo, jd = J.generate_rays(jc, w, h, jnp.float32(math.pi / 3.0))
    to, td = T.generate_rays(_twin_camera(jc), w, h, torch.tensor(math.pi / 3.0))
    assert td.shape == (h, w, 3) and td.dtype == torch.float32
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=3e-7)
    np.testing.assert_array_equal(_np(to), np.asarray(jo))


@pytest.mark.parametrize(
    "cam,scene_kw,bands",
    [
        (CAMERAS[0], dict(), dict()),
        (CAMERAS[1], dict(screen_width=1920, screen_height=1080), dict(row0=540, col0=0)),
        (CAMERAS[2], dict(schwarzschild_radius=0.5, fov=1.1, spin=0.3,
                          black_hole_position=[0.25, -0.5, 1.0], screen_width=160,
                          screen_height=96, max_steps=200), dict(row0=3, col0=5, stride=2)),
    ],
    ids=["default", "hd-band", "custom"],
)
def test_build_params_matches_jax(cam, scene_kw, bands):
    jc = J.Camera.new(*cam)
    jkw = {k: (jnp.asarray(v, jnp.float32) if not isinstance(v, int) else v)
           for k, v in scene_kw.items()}
    js = J.SceneParams(**jkw)
    ts = T.scene_from_numpy(*(np.asarray(getattr(js, f)) for f in (
        "black_hole_position", "schwarzschild_radius", "fov", "spin")),
        js.screen_width, js.screen_height, js.max_steps)
    want = np.asarray(jax_build_params(jc, js, J.TraceConfig(), **bands))
    got = trace_kernel.build_params(_twin_camera(jc), ts, T.TraceConfig(), **bands)
    assert got.shape == (32,) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=0)


def test_from_numpy_round_trips_jax_fields():
    jc, js = J.Camera.default(), J.SceneParams(screen_width=64, screen_height=48, max_steps=7)
    tc = _twin_camera(jc)
    _assert_camera_close(tc, jc, atol=0)
    ts = T.scene_from_numpy(js.black_hole_position, js.schwarzschild_radius, js.fov, js.spin,
                            js.screen_width, js.screen_height, js.max_steps, js.debug_mode)
    assert (ts.width, ts.height, ts.max_steps, ts.debug_mode) == (64, 48, 7, 0)
    assert ts.schwarzschild_radius.dtype == torch.float32
    np.testing.assert_array_equal(_np(ts.fov), np.asarray(js.fov))
