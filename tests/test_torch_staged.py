"""Every routing of the port's render_image against bhr_tpu's: the
monolithic kernel for rk4, leapfrog, adaptive dt, flat spacetime and the
fast tier's disk; the planes kernel plus the shading epilogue for the exact
tier's disk, the tonemaps and the debug heatmap. On the CPU each kernel's
wrapper runs its plain version; the kernels themselves are held against
those plain versions by the `gpu`-marked tests at the end.

Bars against bhr_tpu's oracle path (use_pallas=False), both tiers: channels
within 1 level on >= 99.5% of pixels and packed words bit-equal on >= 98%.
The exact tier rounds as the oracle does, but XLA on the CPU contracts
some multiply-adds (tests/test_torch_integrators.py), which flips a
half-level here and there; the fast tier's folded integrators move a few
more rays of the photon-sphere rim.
"""

import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.ops.pallas_trace import monolithic_eligible as jax_monolithic_eligible
from bhr_tpu.ops.pallas_trace import pallas_render_packed
from bhr_tpu_torch import renderer as trenderer
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.sampling import unpack_frame
from bhr_tpu_torch.ops.trace import STATUS_DISK
from bhr_tpu_torch.utils.tracing import COUNTS

W, H, STEPS = 48, 32, 160
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
DISK = ([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])

# (id, renderer kwargs, debug_mode, camera, path of the exact tier, of the fast tier)
ROUTES = [
    ("rk4-adaptive", dict(integrator="rk4", adaptive=True), 0, SIDE, "mono", "mono"),
    ("leapfrog-flat", dict(integrator="leapfrog", model="flat"), 0, SIDE, "mono", "mono"),
    ("baseline4", dict(integrator="rk4", adaptive=True, disk=True), 0, DISK, "staged", "mono"),
    ("leapfrog-srgb", dict(integrator="leapfrog", tonemap="srgb"), 0, SIDE, "staged", "staged"),
    ("euler-reinhard-disk", dict(tonemap="reinhard", disk=True), 0, DISK, "staged", "staged"),
    ("rk4-disk-debug", dict(integrator="rk4", disk=True), 1, DISK, "staged", "staged"),
]


def _u8(frame):
    return np.asarray(frame.cpu() if isinstance(frame, torch.Tensor) else frame).astype(np.int32)


def _spy(monkeypatch):
    """Count render_image's calls of the two kernel wrappers."""
    calls = {"mono": 0, "staged": 0}

    def wrap(fn, key):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(trenderer, "render_packed", wrap(trenderer.render_packed, "mono"))
    monkeypatch.setattr(trenderer, "trace_image", wrap(trenderer.trace_image, "staged"))
    return calls


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("name,kw,debug,cam,exact_path,fast_path", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_render_frame_matches_jax(name, kw, debug, cam, exact_path, fast_path, fast,
                                  monkeypatch):
    calls = _spy(monkeypatch)
    jr = J.BlackHoleRenderer(W, H, use_pallas=False, fast_math=fast, **kw)
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, debug_mode=debug)
    want = _u8(jr.render_frame(J.Camera.new(*cam), js))
    tr = T.BlackHoleRenderer(W, H, device="cpu", fast_math=fast, **kw)
    ts = T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, debug_mode=debug)
    frame = tr.render_frame(T.Camera.new(*cam), ts)
    assert frame.shape == (H, W, 4) and frame.dtype == torch.uint8
    path = fast_path if fast else exact_path
    assert calls == {"mono": int(path == "mono"), "staged": int(path == "staged")}, calls
    got = _u8(frame)
    diff = np.abs(got - want).max(-1)
    same = (diff == 0).mean()
    assert (diff <= 1).mean() >= 0.995 and same >= 0.98, (same, (diff <= 1).mean(), diff.max())
    assert (got[..., 3] == 255).all()


def test_fast_disk_frame_matches_jax_monolithic():
    """The fast tier's in-kernel disk (its plain version here) against
    pallas_render_packed in interpret mode, BASELINE config 4's shape.
    In interpret mode JAX's pl.reciprocal(approx=True) really approximates
    (about 1e-3 relative), which the disk's 1/g^3 beaming amplifies: disk
    pixels are held within 6 levels, every other pixel within 1 level on
    >= 99.5%."""
    jc = J.Camera.new(*SIDE)
    js = J.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    cfg = dict(integrator="rk4", adaptive=True, disk=True)
    want = np.asarray(pallas_render_packed(jc, js, J.TraceConfig(**cfg), interpret=True,
                                           fast_math=True))
    tc = T.camera_from_numpy(*(np.asarray(x) for x in (jc.position, jc.forward, jc.right,
                                                        jc.up)))
    ts = T.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    got = trace_kernel.render_packed(tc, ts, T.TraceConfig(**cfg), fast_math=True, device="cpu")
    status = trace_kernel.trace_image(tc, ts, T.TraceConfig(**cfg), fast_math=True,
                                      device="cpu").status.numpy()
    g = _u8(unpack_frame(got))
    w = want.view(np.uint8).reshape(H, W, 4).astype(np.int32)
    diff = np.abs(g - w).max(-1)
    is_disk = status == STATUS_DISK
    assert is_disk.mean() > 0.2
    assert diff[is_disk].max() <= 6
    assert (diff[~is_disk] <= 1).mean() >= 0.995


def test_monolithic_eligible_matches_jax():
    """The port's predicate is bhr_tpu's on every ported model: disk frames
    and kerr_lt go monolithic in the fast tier only; a debug view or a
    tonemap never."""
    for integ in ("euler", "rk4", "leapfrog"):
        for model in ("schwarzschild", "flat", "kerr", "kerr_lt"):
            for adaptive in (False, True):
                for disk in (False, True):
                    for fast in (False, True):
                        for debug in (0, 1):
                            for tonemap in ("passthrough", "srgb"):
                                kw = dict(integrator=integ, model=model, adaptive=adaptive,
                                          disk=disk)
                                want = jax_monolithic_eligible(
                                    J.TraceConfig(**kw), J.SceneParams(debug_mode=debug),
                                    use_pallas=True, fast_math=fast, skybox=None,
                                    disk_params=object() if disk else None, tonemap=tonemap)
                                got = trace_kernel.monolithic_eligible(
                                    T.TraceConfig(**kw), T.SceneParams(debug_mode=debug),
                                    fast_math=fast, skybox=None,
                                    disk_params=object() if disk else None, tonemap=tonemap)
                                assert got == want, (kw, fast, debug, tonemap)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_trace_image_equals_its_reference_and_fills_out(fast):
    scene = T.SceneParams(screen_width=24, screen_height=16, max_steps=200)
    cam = T.Camera.new(*SIDE)
    cfg = T.TraceConfig(integrator="leapfrog", adaptive=True, disk=True)
    launches = COUNTS["launch.trace_planes"]
    got = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cpu")
    assert COUNTS["launch.trace_planes"] == launches  # the CPU path launches no kernel
    want = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cpu")
    out = trace_kernel.empty_trace_result(16, 24, "cpu")
    assert trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cpu", out=out) is out
    for f in ("final_pos", "final_vel", "status", "steps"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0)
        torch.testing.assert_close(getattr(out, f), getattr(want, f), rtol=0, atol=0)
    assert got.final_pos.shape == (16, 24, 3) and got.steps.dtype == torch.int32
    assert (got.status == STATUS_DISK).any() and (got.status != STATUS_DISK).any()
    bad = trace_kernel.empty_trace_result(16, 24, "cpu")
    bad = T.TraceResult(bad.final_pos, bad.final_vel, bad.status.long(), bad.steps)
    with pytest.raises(ValueError, match="out.status must be"):
        trace_kernel.trace_image(cam, scene, cfg, device="cpu", out=bad)


def test_render_packed_refuses_what_the_staged_path_renders():
    scene = T.SceneParams(screen_width=8, screen_height=8, max_steps=4)
    with pytest.raises(ValueError, match="staged epilogue"):
        trace_kernel.render_packed(T.Camera.default(), scene, T.TraceConfig(disk=True),
                                   fast_math=False, device="cpu")
    with pytest.raises(ValueError, match="staged epilogue"):
        trace_kernel.render_packed(T.Camera.default(), scene.replace(debug_mode=1),
                                   device="cpu")


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_orbit_animator_staged_frames(fast):
    """A staged configuration's animation: the trace planes are reused
    across frames, and each frame equals the single-frame render from its
    orbit camera; start_frame resumes a run exactly."""
    r = T.BlackHoleRenderer(24, 16, "rk4", device="cpu", fast_math=fast, disk=True,
                            tonemap="srgb")
    anim = T.OrbitAnimator(r)
    scene = T.SceneParams(screen_width=24, screen_height=16, max_steps=60)
    packed = anim.render_frames(3, fps=10.0, scene=scene, packed=True)
    assert packed.shape == (3, 16, 24) and packed.dtype == torch.int32
    for k, t in enumerate(anim.frame_times(3, fps=10.0)):
        one = r.render_frame(T.orbit_camera(t), scene)
        torch.testing.assert_close(unpack_frame(packed[k]), one, rtol=0, atol=0)
    tail = anim.render_frames(2, fps=10.0, start_frame=1, scene=scene, packed=True)
    torch.testing.assert_close(tail, packed[1:], rtol=0, atol=0)
    assert not (packed[1] == packed[0]).all()


def test_renderer_options():
    r = T.BlackHoleRenderer.new(16, 8, "src/ray_tracer_rk4.wgsl", device="cpu", adaptive=True,
                                disk=True, dt=0.05, tonemap="reinhard")
    assert r.config == T.TraceConfig(integrator="rk4", adaptive=True, disk=True, dt=0.05)
    assert r.disk_params(r.scene).r_isco.item() == 6.0 and r._lut.shape == (512, 3)
    assert T.BlackHoleRenderer(8, 8, "leapfrog", device="cpu", model="flat").config.model == "flat"
    assert T.BlackHoleRenderer(8, 8, device="cpu").disk_params(T.SceneParams()) is None
    with pytest.raises(ValueError, match="tonemap"):
        T.BlackHoleRenderer(8, 8, device="cpu", tonemap="filmic")
    with pytest.raises(ValueError, match="model"):
        T.BlackHoleRenderer(8, 8, device="cpu", model="minkowski")


# ---- the CUDA kernels: run only where a CUDA device is visible -------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


GPU_CONFIGS = [
    dict(integrator="rk4", adaptive=True, disk=True),
    dict(integrator="leapfrog"),
    dict(integrator="euler", model="flat", adaptive=True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("kw", GPU_CONFIGS, ids=["rk4-adaptive-disk", "leapfrog", "flat"])
def test_trace_planes_matches_plain_version_on_gpu(kw, fast):
    """The planes kernel against its plain version on the card: status and
    steps agree on >= 99.5% of pixels (exact tier: every plane bit-equal on
    >= 99.9%), directions within 1e-4 on >= 99.5% of the matched ones."""
    _need_cuda()
    scene = T.SceneParams(screen_width=160, screen_height=96, max_steps=200)
    cam = T.Camera.new(*DISK)
    cfg = T.TraceConfig(**kw)
    launches = COUNTS["launch.trace_planes"]
    got = trace_kernel.trace_image(cam, scene, cfg, fast_math=fast, device="cuda")
    torch.cuda.synchronize()
    assert COUNTS["launch.trace_planes"] == launches + 1
    want = trace_kernel.trace_image_reference(cam, scene, cfg, fast_math=fast, device="cuda")
    same = (got.status == want.status) & (got.steps == want.steps)
    assert same.float().mean().item() >= 0.995
    vd = (got.final_vel - want.final_vel).abs().amax(-1)[same]
    assert (vd <= 1e-4).float().mean().item() >= 0.995
    if not fast:
        for f in ("final_pos", "final_vel"):
            eq = (getattr(got, f) == getattr(want, f)).all(-1)
            assert eq.float().mean().item() >= 0.999, f


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("kw", GPU_CONFIGS, ids=["rk4-adaptive-disk", "leapfrog", "flat"])
def test_render_mono_variants_match_plain_version_on_gpu(kw, fast):
    """The monolithic kernel's rk4, leapfrog, adaptive, flat and disk
    variants against the plain version (the exact tier's disk frame: the
    planes kernel and the epilogue against the plain trace and the same
    epilogue): exact tier bit-equal on >= 99.9%, fast tier within 1 level
    on >= 99.5%."""
    _need_cuda()
    cfg = T.TraceConfig(**kw)
    scene = T.SceneParams(screen_width=160, screen_height=96, max_steps=200)
    cam = T.Camera.new(*DISK)
    if cfg.disk and not fast:
        r = T.BlackHoleRenderer(160, 96, device="cuda", **kw)
        got = T.render_image(cam, scene, config=cfg, fast_math=False, device="cuda", packed=True,
                             disk_params=r.disk_params(scene), lut=r._lut)
        want = trenderer.shade_image(
            trace_kernel.trace_image_reference(cam, scene, cfg, device="cuda"), cam, scene,
            r.disk_params(scene), r._lut, tonemap="passthrough", packed=True)
    else:
        got = trace_kernel.render_packed(cam, scene, cfg, fast_math=fast, device="cuda")
        want = trace_kernel.render_packed_reference(cam, scene, cfg, fast_math=fast,
                                                    device="cuda")
    torch.cuda.synchronize()
    if fast:
        d = (unpack_frame(got).int() - unpack_frame(want).int()).abs().amax(-1)
        assert (d <= 1).float().mean().item() >= 0.995
    else:
        assert (got == want).float().mean().item() >= 0.999
