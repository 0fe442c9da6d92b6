"""The plain PyTorch oracle (bhr_tpu_torch.ops.trace.trace_rays and its
integrator and model) against bhr_tpu's XLA oracle on identical inputs.

Two separately compiled programs differ by an ulp here and there (FMA
contraction, reduction order), and the geodesic flow near the photon
sphere amplifies that, so whole-trace comparisons use the chaos-aware bars
of tests/test_pallas_parity.py:46-61: status and steps agree on >= 99.5%
of pixels, and the final direction is within 1e-4 on >= 99.5% of the
matched, non-captured pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import schwarzschild as jschw
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu_torch.models import schwarzschild as tschw
from bhr_tpu_torch.ops import geodesic as tgeo
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, STATUS_ESCAPED, STATUS_RUNNING

W, H, STEPS = 48, 32, 120
CAMERAS = {
    "default": ([0.0, 5.0, 15.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    "side": ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rays(cam, max_steps=STEPS, **scene_kw):
    """The same primary rays for both packages: JAX generates them, and the
    port traces the identical numpy arrays."""
    jc = J.Camera.new(*CAMERAS[cam])
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=max_steps,
                       **{k: jnp.float32(v) for k, v in scene_kw.items()})
    origins, dirs = J.generate_rays(jc, W, H, js.fov)
    return js, np.array(origins), np.array(dirs)  # writable copies for torch.from_numpy


def _trace_both(js, origins, dirs, model):
    want = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius,
                        js.spin, js.max_steps, J.TraceConfig(model=model))
    got = T.trace_rays(torch.from_numpy(origins), torch.from_numpy(dirs),
                       torch.from_numpy(np.array(js.black_hole_position)),
                       float(js.schwarzschild_radius), float(js.spin), js.max_steps,
                       T.TraceConfig(model=model))
    return got, want


def _assert_match_chaotic(got, want, frac=0.995, vel_atol=1e-4):
    sg, sw = _np(got.status), _np(want.status)
    same = (sg == sw) & (_np(got.steps) == _np(want.steps))
    assert same.mean() >= frac, f"status/steps agree on only {same.mean():.4f}"
    m = same & (sw != STATUS_CAPTURED)
    vd = np.abs(_np(got.final_vel) - _np(want.final_vel)).max(-1)
    ok = vd[m] <= vel_atol
    assert ok.mean() >= frac, f"vel close on only {ok.mean():.4f} (max {vd[m].max()})"


@pytest.mark.parametrize("steps", [STEPS, 300])
@pytest.mark.parametrize("cam", sorted(CAMERAS))
@pytest.mark.parametrize("model", ["schwarzschild", "flat"], ids=["euler", "flat"])
def test_trace_rays_matches_jax(model, cam, steps):
    kw = dict(schwarzschild_radius=0.0) if model == "flat" else {}
    got, want = _trace_both(*_rays(cam, max_steps=steps, **kw), model)
    for name in ("final_pos", "final_vel"):
        assert getattr(got, name).shape == (H, W, 3)
    assert got.status.dtype == torch.int32 and got.steps.dtype == torch.int32
    _assert_match_chaotic(got, want)
    if model == "schwarzschild" and steps == 300:
        # from r = 15.8 the shadow's rays are captured after ~137 steps;
        # the sky's rays would need ~850 steps to escape, so they run out
        status = _np(got.status)
        assert (status == STATUS_CAPTURED).any() and (status == STATUS_RUNNING).any()
        assert not (status == STATUS_ESCAPED).any()


def test_trace_rays_weak_field_tight():
    """Weak lensing, short integration: no chaotic boundary, so the two
    oracles agree on every pixel."""
    got, want = _trace_both(*_rays("default", max_steps=60, schwarzschild_radius=0.25),
                            "schwarzschild")
    np.testing.assert_array_equal(_np(got.status), np.asarray(want.status))
    np.testing.assert_array_equal(_np(got.steps), np.asarray(want.steps))
    np.testing.assert_allclose(_np(got.final_vel), np.asarray(want.final_vel), atol=1e-5)


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_max_steps_zero_raygen_matches_jax(cam):
    """max_steps=0: the loop never runs, so the port's generate_rays +
    trace_rays normalisation is compared alone, to fp32 ulps."""
    jc = J.Camera.new(*CAMERAS[cam])
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=0)
    jo, jd = J.generate_rays(jc, W, H, js.fov)
    want = J.trace_rays(jo, jd, js.black_hole_position, js.schwarzschild_radius, js.spin, 0)
    tc = T.camera_from_numpy(*(np.asarray(x) for x in (jc.position, jc.forward, jc.right,
                                                        jc.up)))
    to, td = T.generate_rays(tc, W, H, T.SceneParams().fov)
    got = T.trace_rays(to, td, torch.zeros(3), 2.0, 0.0, 0)
    np.testing.assert_allclose(_np(got.final_vel), np.asarray(want.final_vel), atol=3e-7)
    np.testing.assert_array_equal(_np(got.status), np.asarray(want.status))
    assert (_np(got.status) == STATUS_RUNNING).all() and (_np(got.steps) == 0).all()


def _random_state(n=4096, seed=3):
    rng = np.random.RandomState(seed)
    rel = rng.randn(n, 3).astype(np.float32)
    rel *= (rng.uniform(2.2, 90.0, n) / np.linalg.norm(rel, axis=-1))[:, None].astype(np.float32)
    vel = rng.randn(n, 3).astype(np.float32)
    vel /= np.linalg.norm(vel, axis=-1, keepdims=True)
    return rel.astype(np.float32), vel.astype(np.float32)


def test_schwarzschild_acceleration_and_metric_match_jax():
    rel, vel = _random_state()
    r = np.sqrt((rel * rel).sum(-1)).astype(np.float32)
    rs = np.float32(2.0)
    want = jschw.acceleration(jnp.asarray(rel), jnp.asarray(vel), jnp.asarray(r), rs)
    got = tschw.acceleration(torch.from_numpy(rel), torch.from_numpy(vel), torch.from_numpy(r),
                             torch.tensor(rs))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-9)
    for fn in ("g_tt", "g_rr"):
        np.testing.assert_allclose(
            _np(getattr(tschw, fn)(torch.from_numpy(r), torch.tensor(rs))),
            np.asarray(getattr(jschw, fn)(jnp.asarray(r), rs)), rtol=1e-6)
    assert float(tschw.capture_radius(torch.tensor(rs))) == float(jschw.capture_radius(rs))


@pytest.mark.parametrize("model", ["schwarzschild", "flat"])
def test_euler_step_matches_jax(model):
    rel, vel = _random_state(seed=5)
    r = np.sqrt((rel * rel).sum(-1)).astype(np.float32)
    rs = np.float32(2.0)
    want = jgeo.euler_step(jgeo.model_acceleration(model), jnp.asarray(rel), jnp.asarray(vel),
                           jnp.asarray(r), rs, np.float32(0.0), 0.1)
    got = tgeo.euler_step(tgeo.model_acceleration(model), torch.from_numpy(rel),
                          torch.from_numpy(vel), torch.from_numpy(r), torch.tensor(rs),
                          torch.tensor(0.0), 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_folded_euler_step_tracks_literal_step():
    """The fast tier's folded update is the same physics as the literal
    Euler step, reassociated: the two agree to fp32 rounding."""
    rel, vel = _random_state(seed=7)
    rel_t, vel_t = torch.from_numpy(rel), torch.from_numpy(vel)
    r = torch.sqrt(T.core.math.dot(rel_t, rel_t))
    rs = torch.tensor(2.0)
    lit_rel, lit_vel = tgeo.euler_step(tgeo.model_acceleration("schwarzschild"), rel_t, vel_t, r,
                                       rs, torch.tensor(0.0), 0.1)
    lit_vel = T.normalize(lit_vel)
    fold_rel, fold_vel = tgeo.euler_step_folded(rel_t, vel_t, rs, 0.1)
    torch.testing.assert_close(fold_rel, lit_rel, rtol=0, atol=2e-5)
    torch.testing.assert_close(fold_vel, lit_vel, rtol=0, atol=2e-6)


def test_fast_tier_trace_tracks_exact_tier():
    """trace_rays(fast_math=True) (r^2-space termination, folded update)
    classifies the same rays as the exact oracle, up to the chaotic rim."""
    js, origins, dirs = _rays("default")
    args = (torch.from_numpy(origins), torch.from_numpy(dirs), torch.zeros(3), 2.0, 0.0, STEPS)
    _assert_match_chaotic(T.trace_rays(*args, fast_math=True), T.trace_rays(*args), frac=0.99)
