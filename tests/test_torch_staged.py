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
    plan = r._frame_plan()
    assert plan.route == "planes" and plan.disk_params.r_isco.item() == 6.0
    assert plan.lut.shape == (512, 3)
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
        plan = T.BlackHoleRenderer(160, 96, device="cuda", **kw)._frame_plan(scene)
        got = T.render_image(cam, scene, config=cfg, fast_math=False, device="cuda", packed=True,
                             disk_params=plan.disk_params, lut=plan.lut)
        want = trenderer.shade_image(
            trace_kernel.trace_image_reference(cam, scene, cfg, device="cuda"), cam, scene,
            plan.disk_params, plan.lut, tonemap="passthrough", packed=True)
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


# ---- one route for every entry point -----------------------------------------

SKY = T.load_skybox(None, 7, (64, 128))
KERNELS = ("render_packed", "trace_image", "neural_render_packed", "neural_trace_dirs",
           "neural_trace_image", "render_multires", "render_multires_band")
# (id, renderer kwargs, the route, the kernel wrapper it calls, a caller's disk on a no-disk config)
ONE_ROUTE = [
    ("mono-fast", dict(fast_math=True), "mono", "render_packed", False),
    ("staged-exact-disk", dict(integrator="rk4", adaptive=True, disk=True), "planes",
     "trace_image", False),
    ("textured", dict(skybox=SKY), "planes", "trace_image", False),
    ("neural-kernel", dict(integrator="neural"), "neural", "neural_render_packed", False),
    ("neural-textured", dict(integrator="neural", skybox=SKY), "dirs", "neural_trace_dirs",
     False),
    ("neural-high", dict(integrator="neural", neural_precision="high"), "neural_staged",
     "neural_trace_image", False),
    ("multires", dict(multires=2), "multires", "render_multires", False),
    ("caller-disk", dict(fast_math=True), "planes", "trace_image", True),
]


def _kernel_spy(monkeypatch):
    calls = dict.fromkeys(KERNELS, 0)

    def wrap(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    for name in KERNELS:
        monkeypatch.setattr(trenderer, name, wrap(name, getattr(trenderer, name)))

    def since(before):
        return {k: calls[k] - before[k] for k in calls if calls[k] != before[k]}
    return calls, since


@pytest.mark.parametrize("kw,route,kernel,caller_disk", [c[1:] for c in ONE_ROUTE],
                         ids=[c[0] for c in ONE_ROUTE])
def test_one_route_for_the_animation_the_frame_render_image_and_the_mesh(
        kw, route, kernel, caller_disk, monkeypatch):
    """renderer.frame_route decides the route; PathAnimator.render_frames,
    render_frame (render_frame_multires at the animation's divisor),
    render_image and a one-band mesh each launch that route's kernel once
    a frame, and their frames are equal."""
    from bhr_tpu_torch.models.disk import DiskParams
    from bhr_tpu_torch.parallel import mesh as pm

    calls, since = _kernel_spy(monkeypatch)
    r = T.BlackHoleRenderer(24, 16, device="cpu", **kw)
    scene = r.frame_scene(T.SceneParams(max_steps=60))
    anim = T.OrbitAnimator(r)
    cam = anim.camera_fn(anim.frame_times(1, fps=10.0, start_frame=3)[0])
    plan = r._frame_plan(scene, divisor=r.multires)
    disk = DiskParams.for_scene(scene.schwarzschild_radius) if caller_disk else plan.disk_params
    assert plan.route == ("mono" if caller_disk else route)
    frames = {}
    if not caller_disk:
        before = dict(calls)
        frames["animation"] = anim.render_frames(1, fps=10.0, start_frame=3, scene=scene,
                                                 packed=True)[0]
        assert since(before) == {kernel: 1}
        before = dict(calls)
        one = (r.render_frame_multires(cam, scene, divisor=r.multires) if r.multires
               else r.render_frame(cam, scene))
        frames["render_frame"] = one.view(torch.int32).view(16, 24)
        assert since(before) == {kernel: 1}
    if not r.multires:
        before = dict(calls)
        frames["render_image"] = T.render_image(
            cam, scene, config=r.config, fast_math=r.fast_math, device="cpu", tonemap=r.tonemap,
            seed=r.skybox_seed, packed=True, skybox=r.skybox, disk_params=disk, lut=plan.lut,
            texture_filter=r.texture_filter, texture_subsample=r.texture_subsample,
            neural_params=r.neural_params, neural_dtype=r.neural_dtype,
            neural_precision=r.neural_precision)
        assert since(before) == {kernel: 1}
    before = dict(calls)
    sharded = pm.render_frame_sharded(
        cam, scene, r.skybox, pm.make_mesh(devices=["cpu"]), config=r.config,
        disk_params=disk, lut=plan.lut, fast_math=r.fast_math, tonemap=r.tonemap,
        seed=r.skybox_seed, neural_params=r.neural_params, neural_precision=r.neural_precision,
        multires=r.multires)
    frames["mesh"] = sharded.view(torch.int32).view(16, 24)
    # a band of a multires frame is ops/multires' band of its rows
    assert since(before) == {"render_multires_band" if r.multires else kernel: 1}
    first = next(iter(frames.values()))
    for name, frame in frames.items():
        torch.testing.assert_close(frame, first, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_a_monolithic_disk_animation_builds_no_disk_params(fast, monkeypatch):
    """The fast disk frame shades its disk in-kernel: its animation builds
    no DiskParams. The exact one is staged and builds them once a call."""
    from bhr_tpu_torch.models.disk import DiskParams

    built = []
    for_scene = DiskParams.for_scene
    monkeypatch.setattr(DiskParams, "for_scene", lambda rs: built.append(rs) or for_scene(rs))
    r = T.BlackHoleRenderer(24, 16, "rk4", adaptive=True, disk=True, fast_math=fast,
                            device="cpu")
    calls, since = _kernel_spy(monkeypatch)
    T.OrbitAnimator(r).render_frames(2, scene=T.SceneParams(max_steps=60), packed=True)
    assert since(dict.fromkeys(KERNELS, 0)) == {"render_packed" if fast else "trace_image": 2}
    assert len(built) == (0 if fast else 1)


def test_a_plan_decides_its_route_once_and_keeps_it():
    """The plan's route comes from its own inputs alone: no caller passes
    one, and nothing in the plan changes after it is decided. A monolithic
    disk frame's plan holds no disk parameters; a staged one's does."""
    import dataclasses

    fast = T.BlackHoleRenderer(24, 16, "rk4", disk=True, fast_math=True, device="cpu")
    exact = T.BlackHoleRenderer(24, 16, "rk4", disk=True, device="cpu")
    mono, staged = fast._frame_plan(), exact._frame_plan()
    assert (mono.route, mono.disk_params, mono.planes) == ("mono", None, None)
    assert staged.route == "planes" and staged.disk_params is not None
    assert exact._frame_setup().planes is not None and staged.planes is None
    with pytest.raises(TypeError):
        trenderer._FramePlan(mono.scene, mono.config, True, mono.device, route="planes")
    with pytest.raises(dataclasses.FrozenInstanceError):
        mono.route = "planes"


def test_multires_keywords_go_to_the_multires_route_only():
    """render_frame_multires's keywords reach ops/multires; any other route
    refuses them instead of dropping them, and a divisor below 1 is refused."""
    r = T.BlackHoleRenderer(24, 16, device="cpu")
    scene = T.SceneParams(max_steps=40)
    cam = T.Camera.default()
    with pytest.raises(TypeError, match="edge_fix"):
        r._frame_plan(scene).render(cam, edge_fix=False)
    with pytest.raises(ValueError, match="divisor"):
        r.render_frame_multires(cam, scene, divisor=0, edge_fix=False)
    fixed = r.render_frame_multires(cam, scene, divisor=2)
    want = T.render_multires(cam, r.frame_scene(scene), config=r.config, device="cpu",
                             divisor=2, fast_math=False, edge_fix=False)
    torch.testing.assert_close(r.render_frame_multires(cam, scene, divisor=2, edge_fix=False),
                               want, rtol=0, atol=0)
    assert (fixed != want).any()  # the keyword took effect
