"""rk4, leapfrog, adaptive dt, the flat model and the disk crossing of the
port against bhr_tpu on identical numpy inputs: the integrator steps
(ops/geodesic.py), the plain oracle trace_rays in both tiers, and the
staged trace (ops/trace_kernel.trace_image, which runs its plain version
on the CPU) against pallas_trace_image in interpret mode, K4
(track_steps=False) and K5 (track_steps=True).

Bars: single steps of two separately compiled programs agree to fp32
rounding (XLA on the CPU contracts some multiply-adds into FMAs). Whole
traces use the chaos-aware bars of tests/test_pallas_parity.py:46-61:
status and steps agree on >= 99.5% of pixels, and the final direction is
within 1e-4 on >= 99.5% of the matched, non-captured ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu.ops.pallas_trace import pallas_trace_image
from bhr_tpu_torch.ops import geodesic as tgeo
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, STATUS_DISK, STATUS_RUNNING

W, H, STEPS = 48, 32, 150
CAMERAS = {
    "side": ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    "disk": ([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),  # tests/test_golden.py:50
}
FRAC = 0.995


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_state(n=4096, seed=3):
    rng = np.random.RandomState(seed)
    rel = rng.randn(n, 3).astype(np.float32)
    rel *= (rng.uniform(2.2, 90.0, n) / np.linalg.norm(rel, axis=-1))[:, None].astype(np.float32)
    vel = rng.randn(n, 3).astype(np.float32)
    vel /= np.linalg.norm(vel, axis=-1, keepdims=True)
    return rel.astype(np.float32), vel.astype(np.float32)


def _assert_match_chaotic(got, want, steps=True, frac=FRAC, vel_atol=1e-4):
    sg, sw = _np(got.status), _np(want.status)
    same = sg == sw
    if steps:
        same &= _np(got.steps) == _np(want.steps)
    assert same.mean() >= frac, f"status/steps agree on only {same.mean():.4f}"
    m = same & (sw != STATUS_CAPTURED)
    vd = np.abs(_np(got.final_vel) - _np(want.final_vel)).max(-1)
    ok = vd[m] <= vel_atol
    assert ok.mean() >= frac, f"vel close on only {ok.mean():.4f} (max {vd[m].max()})"
    return same


# ---- single steps -------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("model", ["schwarzschild", "flat"])
@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_step_matches_jax(integrator, model, adaptive):
    """One step of each integrator on 4096 random states, with a scalar dt
    or the per-ray adaptive dt: rtol 1e-6, atol 1e-6 (one or two ulps of
    the fp32 state)."""
    rel, vel = _random_state(seed=5)
    r = np.sqrt((rel * rel).sum(-1)).astype(np.float32)
    rs = np.float32(2.0)
    if adaptive:
        jdt = jgeo.adaptive_dt(jnp.asarray(r), rs, 0.1)
        tdt = tgeo.adaptive_dt(torch.from_numpy(r), torch.tensor(rs), torch.tensor(0.1))
        np.testing.assert_allclose(_np(tdt), np.asarray(jdt), rtol=1e-6, atol=0)
    else:
        jdt, tdt = 0.1, 0.1
    want = jgeo.STEP_FNS[integrator](jgeo.model_acceleration(model), jnp.asarray(rel),
                                     jnp.asarray(vel), jnp.asarray(r), rs, np.float32(0.0), jdt)
    got = tgeo.STEP_FNS[integrator](tgeo.model_acceleration(model), torch.from_numpy(rel),
                                    torch.from_numpy(vel), torch.from_numpy(r), torch.tensor(rs),
                                    torch.tensor(0.0), tdt)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == rel.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_fast_forms_track_literal_steps(integrator):
    """The fast tier's folded steps are the literal steps reassociated (and
    clamped only where one_m < 0.02, inside the capture radius): the unit
    velocities agree to 3e-6 and positions to 2e-5, with a scalar and a
    per-ray dt."""
    rel, vel = _random_state(seed=7)
    rel_t, vel_t = torch.from_numpy(rel), torch.from_numpy(vel)
    r = torch.sqrt(T.core.math.dot(rel_t, rel_t))
    rs = torch.tensor(2.0)
    for dt in (torch.tensor(0.1), tgeo.adaptive_dt(r, rs, torch.tensor(0.1))):
        lit_rel, lit_vel = tgeo.STEP_FNS[integrator](tgeo.model_acceleration("schwarzschild"),
                                                     rel_t, vel_t, r, rs, torch.tensor(0.0), dt)
        fast_rel, fast_vel = tgeo.FAST_STEP_FNS[integrator](rel_t, vel_t, rs, dt)
        torch.testing.assert_close(fast_rel, lit_rel, rtol=0, atol=2e-5)
        torch.testing.assert_close(fast_vel, T.normalize(lit_vel), rtol=0, atol=3e-6)


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_fast_forms_in_flat_space_are_straight_lines(integrator):
    rel, vel = _random_state(seed=9)
    rel_t, vel_t = torch.from_numpy(rel), torch.from_numpy(vel)
    new_rel, new_vel = tgeo.FAST_STEP_FNS[integrator](rel_t, vel_t, torch.tensor(0.0),
                                                      torch.tensor(0.1), True)
    torch.testing.assert_close(new_rel, rel_t + vel_t * 0.1, rtol=0, atol=0)
    torch.testing.assert_close(new_vel, vel_t, rtol=0, atol=1.2e-7)


# ---- whole traces -------------------------------------------------------------


def _rays(cam, max_steps=STEPS):
    jc = J.Camera.new(*CAMERAS[cam])
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=max_steps)
    origins, dirs = J.generate_rays(jc, W, H, js.fov)
    return jc, js, np.array(origins), np.array(dirs)


def _port_camera(jc):
    return T.camera_from_numpy(*(np.asarray(x) for x in (jc.position, jc.forward, jc.right,
                                                          jc.up)))


TRACE_CONFIGS = [
    (integ, adaptive, model, disk)
    for integ in ("euler", "rk4", "leapfrog")
    for adaptive in (False, True)
    for model, disk in (("schwarzschild", False), ("schwarzschild", True), ("flat", False))
]


@pytest.mark.parametrize(
    "integ,adaptive,model,disk", TRACE_CONFIGS,
    ids=[f"{i}-{'adaptive' if a else 'fixed'}-{m}{'-disk' if d else ''}"
         for i, a, m, d in TRACE_CONFIGS])
def test_trace_rays_matches_jax_oracle(integ, adaptive, model, disk):
    """The exact tier against bhr_tpu's trace_rays on the same rays: the
    chaos-aware bars, and final positions within 1e-3 (a few hundred
    multiply-adds that XLA may contract differently) on >= 99.5% of the
    matched, non-captured pixels."""
    _, js, origins, dirs = _rays("disk" if disk else "side")
    want = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius,
                        js.spin, STEPS, J.TraceConfig(integrator=integ, adaptive=adaptive,
                                                      model=model, disk=disk))
    got = T.trace_rays(torch.from_numpy(origins), torch.from_numpy(dirs), torch.zeros(3), 2.0,
                       0.0, STEPS, T.TraceConfig(integrator=integ, adaptive=adaptive,
                                                 model=model, disk=disk))
    assert got.final_pos.shape == (H, W, 3) and got.status.dtype == torch.int32
    same = _assert_match_chaotic(got, want)
    m = same & (_np(want.status) != STATUS_CAPTURED)
    pd = np.abs(_np(got.final_pos) - np.asarray(want.final_pos)).max(-1)
    assert (pd[m] <= 1e-3).mean() >= FRAC
    status = _np(got.status)
    if disk:
        assert (status == STATUS_DISK).mean() > 0.2  # the disk is in view
        # a disk ray stops on the plane y = 0 (the black hole's y)
        assert (_np(got.final_pos)[status == STATUS_DISK][:, 1] == 0.0).all()
    else:
        assert (status == STATUS_RUNNING).any()


KERNEL_CONFIGS = {
    "euler-adaptive-disk": ("disk", dict(integrator="euler", adaptive=True, disk=True)),
    "rk4-adaptive-disk": ("disk", dict(integrator="rk4", adaptive=True, disk=True)),
    "leapfrog-adaptive-disk": ("disk", dict(integrator="leapfrog", adaptive=True, disk=True)),
    "rk4-fixed-disk": ("disk", dict(integrator="rk4", disk=True)),
    "leapfrog-flat": ("side", dict(integrator="leapfrog", model="flat")),
}


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("name", sorted(KERNEL_CONFIGS))
def test_trace_image_matches_pallas_kernels(name, fast):
    """trace_image (the planes kernel's plain version on the CPU) against
    pallas_trace_image in interpret mode, among them the BASELINE config 4
    shape (rk4, adaptive dt, the disk): status and direction against K4,
    status and step counts against K5. K4 writes no step counts (zeros);
    the port counts them always."""
    cam, cfg = KERNEL_CONFIGS[name]
    jc, js, _, _ = _rays(cam)
    ts = T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    got = trace_kernel.trace_image(_port_camera(jc), ts, T.TraceConfig(**cfg), fast_math=fast,
                                   device="cpu")
    k4 = pallas_trace_image(jc, js, J.TraceConfig(**cfg), fast_math=fast, interpret=True,
                            track_steps=False)
    assert (np.asarray(k4.steps) == 0).all()
    _assert_match_chaotic(got, k4, steps=False)
    k5 = pallas_trace_image(jc, js, J.TraceConfig(**cfg), fast_math=fast, interpret=True,
                            track_steps=True)
    same = (_np(got.status) == np.asarray(k5.status)) & (_np(got.steps) == np.asarray(k5.steps))
    assert same.mean() >= FRAC, f"status/steps agree with K5 on {same.mean():.4f}"
    assert 1 <= int(got.steps.min()) and int(got.steps.max()) <= STEPS


def test_jax_k4_exact_disk_test_departs_from_the_oracle():
    """bhr_tpu's K4 exact tier tests the disk annulus in r^2 space of x and
    z and takes t = -oy * (1 / den) (pallas_trace.py:1069-1075); the oracle
    and the port test the sqrt'd radius of the interpolated point with
    t = -oy / den. Here, from the golden disk camera at 48x32x150 with
    rk4 and adaptive dt, the two JAX programs disagree on the status of
    0 of 1536 pixels, and the port agrees with the oracle on every pixel:
    the forms part only for crossings within an ulp of an annulus edge."""
    jc, js, origins, dirs = _rays("disk")
    cfg = dict(integrator="rk4", adaptive=True, disk=True)
    oracle = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius,
                          js.spin, STEPS, J.TraceConfig(**cfg))
    k4 = pallas_trace_image(jc, js, J.TraceConfig(**cfg), interpret=True, track_steps=False)
    port = T.trace_rays(torch.from_numpy(origins), torch.from_numpy(dirs), torch.zeros(3), 2.0,
                        0.0, STEPS, T.TraceConfig(**cfg))
    so = np.asarray(oracle.status)
    k4_disagree = (np.asarray(k4.status) != so).sum()
    assert k4_disagree == 0, f"K4 and the oracle disagree on {k4_disagree} pixels"
    np.testing.assert_array_equal(_np(port.status), so)


def test_jax_k4_captures_rays_that_cross_the_horizon_on_their_last_step():
    """bhr_tpu's K4 derives status from the final geometry after the loop
    (r^2 < capture^2, pallas_trace.py:1178-1182), so a ray whose last
    allowed step takes it inside the capture radius is CAPTURED there, and
    black in a K1 frame. The oracle's loop never tests it again: it stays
    RUNNING and takes the sky's colour (ops/trace.py:165-202), and so does
    K5's. The port follows the oracle. Here, rk4 at fixed dt from the side
    camera at 48x32x150, that is 8 of 1536 rays, all at r ~ 1.935 < 2.1 after
    step 150; K5 and the port agree with the oracle on every ray."""
    jc, js, origins, dirs = _rays("side")
    cfg = dict(integrator="rk4")
    oracle = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius,
                          js.spin, STEPS, J.TraceConfig(**cfg))
    so = np.asarray(oracle.status)
    k4 = np.asarray(pallas_trace_image(jc, js, J.TraceConfig(**cfg), interpret=True,
                                       track_steps=False).status)
    k5 = np.asarray(pallas_trace_image(jc, js, J.TraceConfig(**cfg), interpret=True,
                                       track_steps=True).status)
    differ = k4 != so
    assert differ.sum() == 8
    assert (so[differ] == STATUS_RUNNING).all() and (k4[differ] == STATUS_CAPTURED).all()
    assert (np.asarray(oracle.steps)[differ] == STEPS).all()
    r_final = np.linalg.norm(np.asarray(oracle.final_pos)[differ], axis=-1)
    assert (r_final < 1.05 * 2.0).all()
    np.testing.assert_array_equal(k5, so)
    ts = T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    for fast in (False, True):
        port = trace_kernel.trace_image(_port_camera(jc), ts, T.TraceConfig(**cfg),
                                        fast_math=fast, device="cpu")
        np.testing.assert_array_equal(_np(port.status), so)
