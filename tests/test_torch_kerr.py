"""Exact Kerr (Kerr-Schild Hamiltonian geodesics, model "kerr") and the
Lense-Thirring approximation ("kerr_lt") of the port against bhr_tpu, on
identical numpy inputs at spin 0.9: the elementwise model functions, the
analytic invariants of tests/test_kerr_schild.py run on the port's
functions, the plain trace in both tiers against bhr_tpu's trace_rays and
its Pallas kernels in interpret mode (K4 and K5 of pallas_trace.py), and
render_image in every route against bhr_tpu's renderer. The kernels
themselves are held against their plain versions by the `gpu`-marked tests
at the end.

Bars. Elementwise functions are bit-equal: the port writes the oracle's
expression trees and takes square roots correctly rounded
(core/math.sqrt_rn). Whole traces use the chaos-aware bars of
tests/test_pallas_parity.py:46-61: status (and steps) agree on >= 99.5% of
pixels, the final direction is within 1e-4 on >= 99.5% of the matched,
non-captured ones.
"""

import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import kerr as jkerr
from bhr_tpu.models import kerr_schild as jks
from bhr_tpu.ops import geodesic as jgeo
from bhr_tpu.ops.pallas_trace import pallas_render_packed, pallas_trace_image
from bhr_tpu_torch import renderer as trenderer
from bhr_tpu_torch.models import kerr as tkerr
from bhr_tpu_torch.models import kerr_schild as tks
from bhr_tpu_torch.ops import geodesic as tgeo
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.sampling import unpack_frame
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, STATUS_DISK, STATUS_ESCAPED
from bhr_tpu_torch.utils.tracing import COUNTS

SPIN = 0.9
RS = 2.0
W, H, STEPS = 48, 32, 150
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])  # scripts/golden_diff.py:128
FRAC = 0.995


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _assert_match_chaotic(got, want, steps=True, frac=FRAC, vel_atol=1e-4):
    same = _np(got.status) == _np(want.status)
    if steps:
        same &= _np(got.steps) == _np(want.steps)
    assert same.mean() >= frac, f"status/steps agree on only {same.mean():.4f}"
    m = same & (_np(want.status) != STATUS_CAPTURED)
    vd = np.abs(_np(got.final_vel) - _np(want.final_vel)).max(-1)
    assert (vd[m] <= vel_atol).mean() >= frac, f"vel close on {(vd[m] <= vel_atol).mean():.4f}"
    return same


# ---- elementwise: bit-equal ---------------------------------------------------


def _random_qpd(n=8192, seed=11):
    """Positions from 0.05 to 40 M (many inside r_+ = 1.44), momenta and
    unit directions."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 3) * rng.uniform(0.05, 40.0, (n, 1))
    p = rng.randn(n, 3)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return q.astype(np.float32), p.astype(np.float32), d.astype(np.float32)


def _both(name, q, p, d):
    args = {"ks_radius": (q,), "aux": (q,), "derivs": (q, p), "hamiltonian": (q, p),
            "init_momentum": (q, d), "final_direction": (q, p)}[name]
    want = getattr(jks, name)(*args, RS, SPIN)
    got = getattr(tks, name)(*(_t(a) for a in args), torch.tensor(RS), torch.tensor(SPIN))
    return got, want


@pytest.mark.parametrize("name", ["ks_radius", "aux", "derivs", "hamiltonian", "init_momentum",
                                  "final_direction"])
def test_kerr_schild_functions_are_bit_equal_to_jax(name):
    """8192 random (q, p, d), a sixth of them inside the horizon: every
    output bit-equal to bhr_tpu.models.kerr_schild (NaN where it is NaN)."""
    q, p, d = _random_qpd()
    assert (np.linalg.norm(q, axis=-1) < 1.44).mean() > 0.02
    got, want = _both(name, q, p, d)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_capture_and_horizon_radius_are_bit_equal_to_jax():
    for spin in (0.0, 0.5, 0.9, 0.999, 1.2):  # 1.2 is clipped to 0.999
        for mod_j, mod_t in ((jks, tks), (jkerr, tkerr)):
            for fn in ("capture_radius", "horizon_radius"):
                want = np.asarray(getattr(mod_j, fn)(np.float32(RS), np.float32(spin)))
                got = getattr(mod_t, fn)(torch.tensor(RS), torch.tensor(spin))
                np.testing.assert_array_equal(_np(got), want)
    assert float(tks.capture_radius(torch.tensor(RS), torch.tensor(SPIN))) < RS


def test_lense_thirring_acceleration_is_bit_equal_to_jax():
    q, _, d = _random_qpd(seed=12)
    r = np.sqrt((q * q).sum(-1)).astype(np.float32)
    want = jkerr.acceleration(q, d, r, np.float32(RS), np.float32(SPIN))
    got = tkerr.acceleration(_t(q), _t(d), _t(r), torch.tensor(RS), torch.tensor(SPIN))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_lense_thirring_steps_match_jax(integrator):
    """One kerr_lt step of each integrator on 4096 random states outside
    the capture radius: rtol 1e-6, atol 1e-6, as for Schwarzschild."""
    rng = np.random.RandomState(5)
    rel = rng.randn(4096, 3)
    rel *= (rng.uniform(2.2, 90.0, 4096) / np.linalg.norm(rel, axis=-1))[:, None]
    vel = rng.randn(4096, 3)
    vel /= np.linalg.norm(vel, axis=-1, keepdims=True)
    rel, vel = rel.astype(np.float32), vel.astype(np.float32)
    r = np.sqrt((rel * rel).sum(-1)).astype(np.float32)
    want = jgeo.STEP_FNS[integrator](jgeo.model_acceleration("kerr_lt"), rel, vel, r,
                                     np.float32(RS), np.float32(SPIN), 0.1)
    got = tgeo.STEP_FNS[integrator](tgeo.model_acceleration("kerr_lt"), _t(rel), _t(vel), _t(r),
                                    torch.tensor(RS), torch.tensor(SPIN), 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)
    # the fast tier's folded forms are the same step reassociated
    fast_rel, fast_vel = tgeo.FAST_STEP_FNS[integrator](_t(rel), _t(vel), torch.tensor(RS),
                                                        torch.tensor(0.1), spin=torch.tensor(SPIN))
    torch.testing.assert_close(fast_rel, got[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(fast_vel, T.normalize(got[1]), rtol=0, atol=3e-6)


def test_fast_euler_does_not_clamp_kerr_lt():
    """pallas_trace.py physics_substep clamps one_m >= 0.02 for
    Schwarzschild only: a live kerr_lt ray inside r_s (capture 1.51 < 2)
    steps with one_m < 0, and so does the port's folded Euler step, while
    rk4's and leapfrog's sl_deriv clamp for every model."""
    rel = torch.tensor([[1.8, 0.3, 0.2]])
    vel = T.normalize(torch.tensor([[-0.2, 0.1, 1.0]]))
    rs, spin, dt = torch.tensor(RS), torch.tensor(SPIN), torch.tensor(0.1)
    lt = tgeo.euler_step_folded(rel, vel, rs, dt, spin=spin)
    clamped = tgeo.euler_step_folded(rel, vel, rs, dt)
    assert not torch.allclose(lt[1], clamped[1], atol=1e-2)
    literal = tgeo.euler_step(tgeo.model_acceleration("kerr_lt"), rel, vel,
                              torch.sqrt(T.core.math.dot(rel, rel)), rs, spin, dt)
    torch.testing.assert_close(lt[0], literal[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(lt[1], T.normalize(literal[1]), rtol=0, atol=1e-5)


def test_model_lookup():
    assert tgeo.MODELS["kerr"] is tks and tgeo.MODELS["kerr_lt"] is tkerr
    with pytest.raises(ValueError, match="Hamiltonian"):
        tgeo.model_acceleration("kerr")
    # plugin physics has no named acceleration: ops/trace adapts the plugin
    with pytest.raises(ValueError, match="custom_accel_arrays"):
        tgeo.model_acceleration("custom")
    with pytest.raises(ValueError, match="unknown"):
        tgeo.model_acceleration("minkowski")


# ---- invariants (tests/test_kerr_schild.py:74-160 on the port) -------------------

M = RS / 2.0


def _photon_ring_radius(a_star, prograde):
    s = -a_star if prograde else a_star
    return 2.0 * M * (1.0 + np.cos(2.0 / 3.0 * np.arccos(s)))


def _tangential(r_bl, spin, prograde):
    a = spin * M
    q = np.array([r_bl, 0.0, a], np.float32)
    d = np.array([-a, 0.0, r_bl], np.float32)
    d /= np.linalg.norm(d)
    return q, d if prograde else -d


@pytest.mark.parametrize("spin,prograde", [(0.9, True), (0.9, False), (0.0, True), (0.0, False),
                                           (0.5, True)])
def test_photon_ring_bracketing(spin, prograde):
    """A photon launched tangentially on the equator at 0.97 r_ph is
    captured, at 1.03 r_ph it escapes (Bardeen 1972's circular photon orbit
    radii), traced by the port's trace_rays (Euler, dt 0.02; escape at 30 M
    instead of 100 M to keep the run short: a photon moving out past 30 M
    from a ring inside 4 M does not come back)."""
    r_ph = _photon_ring_radius(spin, prograde)
    qs, ds = zip(*(_tangential(r_ph * f, spin, prograde) for f in (0.97, 1.03)))
    res = T.trace_rays(_t(np.stack(qs)), _t(np.stack(ds)), torch.zeros(3), RS, spin, 60_000,
                       T.TraceConfig(model="kerr", dt=0.02, escape_radius=30.0))
    assert res.status.tolist() == [STATUS_CAPTURED, STATUS_ESCAPED], (r_ph, res.status)


def test_hamiltonian_conserved_along_ray():
    q = _t([10.0, 3.0, -4.0])
    d = T.normalize(_t([-0.9, -0.2, 0.3]))
    rs, spin = torch.tensor(RS), torch.tensor(SPIN)
    p = tks.init_momentum(q, d, rs, spin)
    assert abs(float(tks.hamiltonian(q, p, rs, spin))) < 1e-6
    cap = float(tks.capture_radius(rs, spin))
    drift = 0.0
    for _ in range(1000):
        drift = max(drift, abs(float(tks.hamiltonian(q, p, rs, spin))))
        step = 0.02 * float(float(tks.ks_radius(q, rs, spin)) > cap)
        _, dp = tks.derivs(q, p, rs, spin)
        p = p + dp * step
        dq2, _ = tks.derivs(q, p, rs, spin)
        q = q + dq2 * step
    assert drift < 5e-3, drift


def test_schwarzschild_limit_matches_radial_physics():
    q = _t([[3.0, 4.0, 0.0], [0.0, 0.0, 7.5]])
    r, f, l = tks.aux(q, torch.tensor(RS), torch.tensor(0.0))
    np.testing.assert_allclose(_np(r), [5.0, 7.5], rtol=1e-6)
    np.testing.assert_allclose(_np(f), RS / np.array([5.0, 7.5]), rtol=1e-6)
    np.testing.assert_allclose(_np(l), [[0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], atol=1e-6)
    rs = torch.tensor(RS)
    assert float(tks.capture_radius(rs, torch.tensor(0.9))) < float(tks.capture_radius(rs, 0.0))
    np.testing.assert_allclose(float(tks.horizon_radius(rs, torch.tensor(0.0))), RS, rtol=1e-6)


def test_horizon_penetration_no_nans():
    q = _t([6.0, 0.5, 0.0])
    rs, spin = torch.tensor(RS), torch.tensor(SPIN)
    p = tks.init_momentum(q, _t([-1.0, 0.0, 0.0]), rs, spin)
    r_min = np.inf
    for _ in range(300):
        r_min = min(r_min, float(tks.ks_radius(q, rs, spin)))
        _, dp = tks.derivs(q, p, rs, spin)
        p = p + dp * 0.02
        dq2, _ = tks.derivs(q, p, rs, spin)
        q = q + dq2 * 0.02
    assert r_min < float(tks.horizon_radius(rs, spin))
    assert torch.isfinite(q).all() and torch.isfinite(p).all()


# ---- whole traces ---------------------------------------------------------------


def _jax_view(max_steps=STEPS):
    jc = J.Camera.new(*SIDE)
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=max_steps,
                       spin=np.float32(SPIN))
    origins, dirs = J.generate_rays(jc, W, H, js.fov)
    return jc, js, np.array(origins), np.array(dirs)


def _port_view(jc, max_steps=STEPS):
    cam = T.camera_from_numpy(*(np.asarray(x) for x in (jc.position, jc.forward, jc.right,
                                                         jc.up)))
    return cam, T.SceneParams(screen_width=W, screen_height=H, max_steps=max_steps, spin=SPIN)


TRACES = [(m, i, v) for m in ("kerr", "kerr_lt") for i in ("euler", "rk4", "leapfrog")
          for v in ("fixed", "adaptive-disk")]


def _cfg(model, integ, variant):
    """fixed: fixed dt, no disk; adaptive-disk; disk: fixed dt with the disk."""
    return dict(integrator=integ, model=model, adaptive="adaptive" in variant,
                disk="disk" in variant)


@pytest.mark.parametrize("model,integ,variant", TRACES, ids=["-".join(t) for t in TRACES])
def test_exact_trace_matches_jax_oracle(model, integ, variant):
    """The exact tier against bhr_tpu's trace_rays: the chaos-aware bars;
    a disk ray's final position on the plane y = 0; final positions within
    1e-3 of the oracle's, relative to max(1, |pos|), on >= 99.5% of the
    matched, non-captured pixels (kerr_lt's Schwarzschild term is singular
    at r_s, which its live rays cross, and a few rays leave with |pos| ~
    1e4)."""
    _, js, origins, dirs = _jax_view()
    cfg = _cfg(model, integ, variant)
    want = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius, js.spin,
                        STEPS, J.TraceConfig(**cfg))
    got = T.trace_rays(_t(origins), _t(dirs), torch.zeros(3), RS, SPIN, STEPS,
                       T.TraceConfig(**cfg))
    same = _assert_match_chaotic(got, want)
    status = _np(got.status)
    if cfg["disk"]:
        assert (status == STATUS_DISK).mean() > 0.2
        assert (_np(got.final_pos)[status == STATUS_DISK][:, 1] == 0.0).all()
    pd = np.abs(_np(got.final_pos) - np.asarray(want.final_pos)).max(-1)
    scale = np.maximum(np.abs(np.asarray(want.final_pos)).max(-1), 1.0)
    assert (pd <= 1e-3 * scale)[same & (status != STATUS_CAPTURED)].mean() >= FRAC


FAST_KERNEL_CASES = ["kerr-euler-fixed", "kerr-euler-adaptive-disk", "kerr-rk4-adaptive-disk",
                     "kerr-leapfrog-adaptive-disk", "kerr_lt-euler-fixed", "kerr_lt-rk4-fixed",
                     "kerr_lt-leapfrog-adaptive-disk"]


@pytest.mark.parametrize("case", FAST_KERNEL_CASES)
def test_fast_trace_matches_jax_stateless_kernel(case):
    """The fast tier (trace_image's plain version) against bhr_tpu's fast
    stateless kernel K4 in interpret mode: status (the fast tier's
    termination in r^2, its y = 0 disk hits) on >= 99.5% of pixels (K4
    counts no steps). Interpret mode's pl.reciprocal(approx=True) is a
    coarse estimate, and Kerr-Schild takes three per derivative, so
    directions are held within 2.5e-3 with adaptive dt and 2e-2 at fixed
    dt, where rays circle the photon ring for the whole 150 steps
    (measured at >= 99.5% of the matched pixels: 1.3e-3 and 1.3e-2)."""
    model, integ, variant = case.split("-", 2)
    cfg = _cfg(model, integ, variant)
    jc, js, _, _ = _jax_view()
    cam, ts = _port_view(jc)
    want = pallas_trace_image(jc, js, J.TraceConfig(**cfg), fast_math=True, interpret=True,
                              track_steps=False)
    got = trace_kernel.trace_image(cam, ts, T.TraceConfig(**cfg), fast_math=True, device="cpu")
    _assert_match_chaotic(got, want, steps=False, vel_atol=2e-2 if variant == "fixed" else 2.5e-3)


def test_exact_kerr_disk_direction_at_the_oracles_hit_point(monkeypatch):
    """bhr_tpu's exact kernels evaluate a Kerr disk ray's shading direction
    at the hit point with y = 0 (K5, pallas_trace.py:1618-1642; K4,
    :1134-1146); the oracle (ops/trace.py:302-319) and the port at its
    interpolated hit point, whose y is within rounding of 0. f and l move
    with y at first order, but y is ~1e-7 there, below an ulp of l: at
    48x32x150 from [15,5,0] (euler, adaptive dt, the disk) setting y = 0
    changes the direction of 0 of the 525 disk rays, and 0 pixels of the
    shaded frame."""
    seen = {}
    direction = tks.final_direction

    def spy(q, p, rs, spin):
        seen.update(q=q, p=p, rs=rs, spin=spin)
        return direction(q, p, rs, spin)

    monkeypatch.setattr(tks, "final_direction", spy)
    cam = T.Camera.new(*SIDE)
    ts = T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, spin=SPIN)
    res = trace_kernel.trace_image(cam, ts, T.TraceConfig(model="kerr", adaptive=True, disk=True),
                                   device="cpu")
    disk = res.status == STATUS_DISK
    q = seen["q"].clone()
    assert q[..., 1][disk].abs().max() < 1e-5 and (q[..., 1][disk] != 0).any()
    q[..., 1] = torch.where(disk, torch.zeros_like(q[..., 1]), q[..., 1])
    at_y0 = direction(q, seen["p"], seen["rs"], seen["spin"])
    differs = (at_y0 != res.final_vel).any(-1)
    assert not differs[~disk].any()
    assert int(disk.sum()) == 525 and int(differs.sum()) == 0, (disk.sum(), differs.sum())
    assert (at_y0 - res.final_vel).abs().max() < 3e-7
    plan = T.BlackHoleRenderer(W, H, device="cpu", model="kerr", disk=True)._frame_plan(ts)
    frames = [trenderer.shade_image(T.TraceResult(res.final_pos, v, res.status, res.steps), cam,
                                    ts, plan.disk_params, plan.lut, tonemap="passthrough")
              for v in (res.final_vel, at_y0)]
    assert int((frames[0] != frames[1]).any(-1).sum()) == 0


def test_exact_kerr_lt_matches_jax_scratch_kernel():
    """bhr_tpu's exact kerr_lt runs on its scratch kernel K5, whose drag is
    j (1/r)^3 (pallas_trace.py:385-397) where the oracle and the port
    divide j / (r r r) (models/kerr.py:57). Against K5 in interpret mode
    the port holds the chaos-aware bars; the share of bit-equal directions
    is lower than against the oracle (below)."""
    jc, js, origins, dirs = _jax_view()
    cam, ts = _port_view(jc)
    cfg = dict(model="kerr_lt")
    k5 = pallas_trace_image(jc, js, J.TraceConfig(**cfg), interpret=True, track_steps=True)
    got = trace_kernel.trace_image(cam, ts, T.TraceConfig(**cfg), device="cpu")
    same = _assert_match_chaotic(got, k5)
    oracle = J.trace_rays(origins, dirs, js.black_hole_position, js.schwarzschild_radius,
                          js.spin, STEPS, J.TraceConfig(**cfg))
    live = same & (_np(got.status) != STATUS_CAPTURED)
    eq_k5 = (_np(got.final_vel) == np.asarray(k5.final_vel)).all(-1)[live].mean()
    eq_oracle = (_np(got.final_vel) == np.asarray(oracle.final_vel)).all(-1)[live].mean()
    assert eq_oracle > eq_k5, (eq_oracle, eq_k5)


def test_fast_kerr_lt_heatmap_matches_jax_k5():
    """The fast tier's step counts (the heatmap's input) for kerr_lt
    against bhr_tpu's K5 fast flavour, which runs accel()'s fast branch
    where the port runs the stateless formulation of both its kernels:
    status and steps under the chaos-aware bars."""
    jc, js, _, _ = _jax_view()
    cam, ts = _port_view(jc)
    cfg = dict(model="kerr_lt", adaptive=True)
    k5 = pallas_trace_image(jc, js, J.TraceConfig(**cfg), fast_math=True, interpret=True,
                            track_steps=True)
    got = trace_kernel.trace_image(cam, ts, T.TraceConfig(**cfg), fast_math=True, device="cpu")
    _assert_match_chaotic(got, k5)


# ---- render_image: every route --------------------------------------------------

ROUTES = [
    # id, renderer kwargs, fast, debug, tonemap, route
    ("kerr-exact", dict(model="kerr"), False, 0, "passthrough", "mono"),
    ("kerr-fast-disk", dict(model="kerr", integrator="rk4", adaptive=True, disk=True), True, 0,
     "passthrough", "mono"),
    ("kerr-exact-disk", dict(model="kerr", disk=True), False, 0, "passthrough", "staged"),
    ("kerr-leapfrog-srgb", dict(model="kerr", integrator="leapfrog"), True, 0, "srgb", "staged"),
    ("kerr-debug", dict(model="kerr", adaptive=True), False, 1, "passthrough", "staged"),
    ("kerr_lt-fast", dict(model="kerr_lt"), True, 0, "passthrough", "mono"),
    ("kerr_lt-exact", dict(model="kerr_lt", integrator="rk4"), False, 0, "passthrough", "staged"),
    ("kerr_lt-fast-debug", dict(model="kerr_lt", adaptive=True), True, 1, "passthrough",
     "staged"),
]


def _spy(monkeypatch):
    calls = {"mono": 0, "staged": 0}

    def wrap(fn, key):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(trenderer, "render_packed", wrap(trenderer.render_packed, "mono"))
    monkeypatch.setattr(trenderer, "trace_image", wrap(trenderer.trace_image, "staged"))
    return calls


@pytest.mark.parametrize("name,kw,fast,debug,tonemap,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_render_frame_matches_jax(name, kw, fast, debug, tonemap, route, monkeypatch):
    """Each route of the table in bhr_tpu/renderer.py:257-307 takes the
    port's kernel wrapper it should, and the frame agrees with bhr_tpu's
    renderer on its oracle path (use_pallas=False, which traces Kerr in
    exact arithmetic in both tiers): channels within 1 level on >= 99.5%
    of pixels, packed words bit-equal on >= 98%."""
    calls = _spy(monkeypatch)
    jr = J.BlackHoleRenderer(W, H, use_pallas=False, fast_math=fast, tonemap=tonemap, **kw)
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, debug_mode=debug,
                       spin=np.float32(SPIN))
    want = np.asarray(jr.render_frame(J.Camera.new(*SIDE), js)).astype(np.int32)
    tr = T.BlackHoleRenderer(W, H, device="cpu", fast_math=fast, tonemap=tonemap, **kw)
    ts = T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, debug_mode=debug,
                       spin=SPIN)
    frame = tr.render_frame(T.Camera.new(*SIDE), ts)
    assert calls == {"mono": int(route == "mono"), "staged": int(route == "staged")}, calls
    got = frame.numpy().astype(np.int32)
    diff = np.abs(got - want).max(-1)
    assert (diff <= 1).mean() >= 0.995 and (diff == 0).mean() >= 0.98, diff.max()


def test_fast_kerr_disk_frame_matches_jax_monolithic():
    """The fast tier's in-kernel Kerr disk (its plain version here) against
    pallas_render_packed in interpret mode: the shading direction at the
    real hit point (tests/test_pallas_parity.py:334). Disk pixels within 6
    levels (the interpret-mode approximate reciprocals, amplified by 1/g^3
    beaming); every other pixel within 1 level on >= 95% (96% measured):
    the star field turns the directions' interpret-mode noise (see
    test_fast_trace_matches_jax_stateless_kernel) into a level or more on
    a few stars' edges."""
    jc, js, _, _ = _jax_view()
    cam, ts = _port_view(jc)
    cfg = dict(model="kerr", adaptive=True, disk=True)
    want = np.asarray(pallas_render_packed(jc, js, J.TraceConfig(**cfg), interpret=True,
                                           fast_math=True))
    got = trace_kernel.render_packed(cam, ts, T.TraceConfig(**cfg), fast_math=True, device="cpu")
    status = trace_kernel.trace_image(cam, ts, T.TraceConfig(**cfg), fast_math=True,
                                      device="cpu").status.numpy()
    g = unpack_frame(got).numpy().astype(np.int32)
    w = want.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    diff = np.abs(g - w).max(-1)
    is_disk = status == STATUS_DISK
    assert is_disk.mean() > 0.2
    assert diff[is_disk].max() <= 6
    assert (diff[~is_disk] <= 1).mean() >= 0.95


def test_kernel_params_and_flags():
    """P_CAP holds 1.05 r_+ and P_SPIN the spin; kerr_lt sets the LT flag,
    kerr the Kerr-Schild flag."""
    scene = T.SceneParams(spin=SPIN)
    for model, flag in (("kerr", 16), ("kerr_lt", 8)):
        cfg = T.TraceConfig(model=model, adaptive=True)
        p = trace_kernel.build_params(T.Camera.default(), scene, cfg)
        assert p[20].item() == tks.capture_radius(torch.tensor(RS), torch.tensor(SPIN)).item()
        assert p[17].item() == np.float32(SPIN)
        assert trace_kernel.trace_flags(cfg) == flag | 2


# ---- the CUDA kernels: run only where a CUDA device is visible -------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


# kerr-euler-disk has BASELINE config 5's flags: its fast frame runs the
# render_mono instantiation with the flags fixed at 20
GPU_CASES = ["kerr-euler-fixed", "kerr-rk4-adaptive-disk", "kerr-leapfrog-fixed",
             "kerr_lt-euler-adaptive-disk", "kerr_lt-rk4-fixed", "kerr_lt-leapfrog-fixed",
             "kerr-euler-disk", "kerr-rk4-disk", "kerr-leapfrog-adaptive-disk"]


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("case", GPU_CASES)
def test_kerr_kernels_match_plain_version_on_gpu(case, fast):
    """Both kernels' Kerr variants against their plain versions on the
    card at 160x96x200, spin 0.9: the planes kernel's status and steps on
    >= 99.5% of pixels (exact: every plane bit-equal on >= 99.9%); the
    monolithic frame, where the route takes it, bit-equal on >= 99.9%
    (exact) or within 1 level on >= 99.5% (fast)."""
    _need_cuda()
    model, integ, variant = case.split("-", 2)
    cfg = T.TraceConfig(**_cfg(model, integ, variant))
    scene = T.SceneParams(screen_width=160, screen_height=96, max_steps=200, spin=SPIN)
    cam = T.Camera.new(*SIDE)
    got = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cuda")
    want = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cuda")
    torch.cuda.synchronize()
    same = (got.status == want.status) & (got.steps == want.steps)
    assert same.float().mean().item() >= 0.995
    if not fast:
        for f in ("final_pos", "final_vel"):
            eq = (getattr(got, f) == getattr(want, f)).all(-1)
            assert eq.float().mean().item() >= 0.999, f
    if trace_kernel.monolithic_eligible(cfg, scene, fast_math=fast, skybox=None,
                                        disk_params=None if not cfg.disk else object(),
                                        tonemap="passthrough"):
        k = trace_kernel.render_packed(cam, scene, cfg, fast_math=fast, device="cuda")
        p = trace_kernel.render_packed_reference(cam, scene, cfg, fast_math=fast, device="cuda")
        torch.cuda.synchronize()
        if fast:
            d = (unpack_frame(k).int() - unpack_frame(p).int()).abs().amax(-1)
            assert (d <= 1).float().mean().item() >= 0.995
        else:
            assert (k == p).float().mean().item() >= 0.999


@pytest.mark.gpu
def test_a_kerr_frame_counts_one_kerr_schild_launch_on_gpu():
    """render_frame of an exact Kerr frame counts one launch under its
    kernel's key and under the key's .ks, in either route, and under .ks.fast
    in the fast tier (none an exact frame); a Schwarzschild or kerr_lt frame
    counts none under .ks."""
    _need_cuda()
    scene = T.SceneParams(screen_width=64, screen_height=48, max_steps=60, spin=SPIN)
    keys = ("launch.render_mono", "launch.render_mono.ks", "launch.render_mono.ks.fast",
            "launch.trace_planes", "launch.trace_planes.ks", "launch.trace_planes.ks.fast")
    for kw, want in ((dict(model="kerr", disk=True, fast_math=True), (1, 1, 1, 0, 0, 0)),
                     (dict(model="kerr", disk=True), (0, 0, 0, 1, 1, 0)),
                     (dict(model="kerr", disk=True, fast_math=True, tonemap="srgb"),
                      (0, 0, 0, 1, 1, 1)),
                     (dict(disk=True, fast_math=True), (1, 0, 0, 0, 0, 0)),
                     (dict(model="kerr_lt", fast_math=True), (1, 0, 0, 0, 0, 0))):
        r = T.BlackHoleRenderer(64, 48, device="cuda", **kw)
        before = [COUNTS[k] for k in keys]
        r.render_frame(T.Camera.new(*SIDE), scene)
        torch.cuda.synchronize()
        assert tuple(COUNTS[k] - b for k, b in zip(keys, before)) == want, kw
