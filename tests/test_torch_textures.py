"""The texture-skybox slice as a whole: BlackHoleRenderer with a skybox,
its filters and subsample tiers, the deflection cache, the animation, and
the neural surrogate's texture route (the direction-plane kernel, N3),
against bhr_tpu on the same texture, camera and scene. On the CPU every
wrapper runs its plain version; bhr_tpu's Pallas kernel runs in interpret
mode.

Bars. A textured frame agrees with bhr_tpu's renderer (oracle path) within
1 level on >= 99% of pixels: the traces differ on a few chaotic rays and
the uv mapping by an ulp (tests/test_torch_sampling.py). The plain version
of the direction-plane kernel agrees with bhr_tpu's kernel on status on >=
99.9% of pixels, and on directions within 1e-4 on >= 99.9% at the highest
tier. At the default tier the bar is >= 99% within 1e-4 and every pixel
within 5e-3, the frame kernel's bar in tests/test_torch_neural.py carried
over to directions: a hidden unit's tanh that differs by an ulp between
XLA and PyTorch rounds to the neighbouring bf16 value on a few units, and
that 2^-9 step reaches the direction as up to 1.2e-3 near the capture fold
(measured here: 99.2% to 99.8% within 1e-4, status equal everywhere).
"""

import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import neural as jn
from bhr_tpu.models import neural_kerr as jnk
from bhr_tpu.ops.neural_pallas import neural_trace_dirs as j_neural_trace_dirs
from bhr_tpu_torch import renderer as trenderer
from bhr_tpu_torch.models import neural as tn
from bhr_tpu_torch.models import neural_kerr as tnk
from bhr_tpu_torch.ops import neural_kernel, trace_kernel
from bhr_tpu_torch.ops.sampling import unpack_frame
from bhr_tpu_torch.ops.trace import STATUS_CAPTURED, STATUS_ESCAPED
from bhr_tpu_torch.utils.tracing import COUNTS

W, H, STEPS = 64, 48, 200
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
DISK = ([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
TIERS = [("bilinear", 1), ("nearest", 1), ("luma", 1), ("bilinear", 2), ("bilinear", "checker"),
         ("nearest", 3), ("luma", 3)]
CONFIGS = {"euler": (dict(), SIDE), "rk4-disk-srgb": (dict(integrator="rk4", disk=True,
                                                           tonemap="srgb"), DISK)}


def _scenes(w=W, h=H, steps=STEPS, spin=0.0, debug=0):
    return (J.SceneParams(screen_width=w, screen_height=h, max_steps=steps,
                          spin=np.float32(spin), debug_mode=debug),
            T.SceneParams(screen_width=w, screen_height=h, max_steps=steps, spin=spin,
                          debug_mode=debug))


def _within_1(got, want):
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return (diff[..., :3].max(-1) <= 1).mean()


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("tier", TIERS, ids=[f"{f}-{s}" for f, s in TIERS])
def test_textured_frame_matches_jax(tier, name, small_skybox):
    filt, sub = tier
    kw, pose = CONFIGS[name]
    jr = J.BlackHoleRenderer(W, H, use_pallas=False, skybox=small_skybox, texture_filter=filt,
                             texture_subsample=sub, **kw)
    tr = T.BlackHoleRenderer(W, H, device="cpu", skybox=small_skybox, texture_filter=filt,
                             texture_subsample=sub, **kw)
    jsc, tsc = _scenes()
    want = np.asarray(jr.render_frame(J.Camera.new(*pose), jsc))
    got = tr.render_frame(T.Camera.new(*pose), tsc).numpy()
    assert got.shape == (H, W, 4) and (got[..., 3] == 255).all()
    assert _within_1(got, want) >= 0.99, _within_1(got, want)
    # the texture really shades the frame: not the analytic star field
    stars = T.BlackHoleRenderer(W, H, device="cpu", **kw).render_frame(T.Camera.new(*pose), tsc)
    assert _within_1(got, stars.numpy()) < 0.9


@pytest.mark.parametrize("tonemap", ["passthrough", "srgb"])
def test_textured_disk_frame_matches_jax_both_tonemaps(tonemap, small_skybox):
    kw = dict(integrator="rk4", disk=True, adaptive=True, tonemap=tonemap)
    jr = J.BlackHoleRenderer(W, H, use_pallas=False, skybox=small_skybox, **kw)
    tr = T.BlackHoleRenderer(W, H, device="cpu", skybox=small_skybox, **kw)
    jsc, tsc = _scenes(steps=160)
    want = np.asarray(jr.render_frame(J.Camera.new(*DISK), jsc))
    got = tr.render_frame(T.Camera.new(*DISK), tsc).numpy()
    assert _within_1(got, want) >= 0.99


def test_debug_view_switches_the_approximate_tiers_off(small_skybox):
    """With debug_mode 1 the frame is the step heatmap whatever the
    texture tier, as bhr_tpu's."""
    jsc, tsc = _scenes(debug=1)
    frames = []
    for filt, sub in (("bilinear", 1), ("luma", 2), ("nearest", "checker")):
        tr = T.BlackHoleRenderer(W, H, device="cpu", skybox=small_skybox, texture_filter=filt,
                                 texture_subsample=sub)
        frames.append(tr.render_frame(T.Camera.new(*SIDE), tsc))
    assert torch.equal(frames[0], frames[1]) and torch.equal(frames[0], frames[2])
    jr = J.BlackHoleRenderer(W, H, use_pallas=False, skybox=small_skybox, texture_filter="luma")
    want = np.asarray(jr.render_frame(J.Camera.new(*SIDE), jsc))
    assert _within_1(frames[0].numpy(), want) >= 0.99


def test_renderer_validates_texture_arguments(small_skybox):
    """bhr_tpu's messages (bhr_tpu/renderer.py:579-636)."""
    new = lambda **kw: T.BlackHoleRenderer(8, 8, device="cpu", **kw)
    with pytest.raises(ValueError, match="'fast' prefiltered tier was removed"):
        new(texture_filter="fast")
    with pytest.raises(ValueError, match="texture_filter must be bilinear/nearest/luma"):
        new(texture_filter="cubic")
    with pytest.raises(ValueError, match="texture_subsample must be >= 1 or 'checker'"):
        new(texture_subsample=0)
    with pytest.raises(ValueError, match="multires divisor must be >= 0"):
        new(multires=-1)
    with pytest.raises(ValueError, match="no multires mode"):
        new(integrator="neural", multires=2)
    with pytest.raises(ValueError, match="multires is not supported with integrator='neural'"):
        new(integrator="neural").render_frame_multires()
    r = new(skybox=small_skybox, texture_filter="luma", texture_subsample="checker", multires=3,
            cache_deflection=True)
    assert (r.texture_subsample, r.multires, r.cache_deflection) == ("checker", 3, True)
    assert isinstance(r.skybox, tuple) and r.skybox[0].shape == (65, 128)
    assert new(skybox=small_skybox).skybox.dtype == torch.int32
    assert new().skybox is None


def _spy(monkeypatch, *names):
    calls = dict.fromkeys(names, 0)

    def wrap(name):
        fn = getattr(trenderer, name)

        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner

    for name in names:
        monkeypatch.setattr(trenderer, name, wrap(name))
    return calls


@pytest.mark.parametrize("kw", [dict(), dict(integrator="rk4", disk=True, tonemap="reinhard"),
                                dict(integrator="neural")], ids=["euler", "rk4-disk", "neural"])
def test_cache_deflection_traces_once(kw, small_skybox, monkeypatch):
    calls = _spy(monkeypatch, "trace_image", "neural_trace_dirs", "render_packed",
                 "neural_render_packed", "neural_trace_image")
    cached = T.BlackHoleRenderer(48, 32, device="cpu", skybox=small_skybox,
                                 cache_deflection=True, **kw)
    plain = T.BlackHoleRenderer(48, 32, device="cpu", skybox=small_skybox, **kw)
    cam = T.Camera.new(*DISK)
    scene = T.SceneParams(max_steps=150)
    want = plain.render_frame(cam, scene)
    before = dict(calls)
    for _ in range(3):
        torch.testing.assert_close(cached.render_frame(cam, scene), want, rtol=0, atol=0)
    traced = "neural_trace_dirs" if kw.get("integrator") == "neural" else "trace_image"
    assert {k: calls[k] - before[k] for k in calls if calls[k] != before[k]} == {traced: 1}
    # the epilogue's inputs may change without a new trace ...
    cached.skybox_seed, cached.tonemap = 7, "srgb"
    cached.render_frame(cam, scene)
    assert calls[traced] - before[traced] == 1
    # ... the geometry may not; a debug view is never cached
    cached.render_frame(T.Camera.new(*SIDE), scene)
    assert calls[traced] - before[traced] == 2
    cached.render_frame(T.Camera.new(*SIDE), scene.replace(debug_mode=1))
    cached.render_frame(T.Camera.new(*SIDE), scene.replace(max_steps=151))
    assert calls[traced] + calls["neural_trace_image"] - before[traced] == 4


def test_cache_deflection_without_a_skybox_is_the_staged_frame(monkeypatch):
    """A cached frame always takes the staged path (bhr_tpu/renderer.py:
    638-645), also where the uncached one would be monolithic."""
    calls = _spy(monkeypatch, "trace_image", "render_packed")
    r = T.BlackHoleRenderer(32, 24, device="cpu", cache_deflection=True, fast_math=True)
    scene = T.SceneParams(max_steps=100)
    a, b = r.render_frame(scene=scene), r.render_frame(scene=scene)
    assert calls == {"trace_image": 1, "render_packed": 0} and torch.equal(a, b)
    res = trace_kernel.trace_image(T.Camera.default(), r.frame_scene(scene), fast_math=True,
                                   device="cpu")
    want = T.shade_image(res, T.Camera.default(), r.frame_scene(scene), None, None,
                         tonemap="passthrough")
    assert torch.equal(a, want)


@pytest.mark.parametrize("kw", [dict(), dict(multires=2), dict(integrator="neural"),
                                dict(texture_filter="luma", disk=True)],
                         ids=["staged", "multires", "neural", "luma-disk"])
def test_orbit_animator_with_a_skybox(kw, small_skybox):
    r = T.BlackHoleRenderer(48, 32, device="cpu", skybox=small_skybox, fast_math=True, **kw)
    anim = T.OrbitAnimator(r)
    scene = T.SceneParams(max_steps=120)
    frames = anim.render_frames(3, scene=scene, start_frame=5)
    assert frames.shape == (3, 32, 48, 4) and frames.dtype == torch.uint8
    for k, t in enumerate(anim.frame_times(3, start_frame=5)):
        cam = T.orbit_camera(t)
        want = (r.render_frame_multires(cam, scene, divisor=2) if kw.get("multires")
                else r.render_frame(cam, scene))
        torch.testing.assert_close(frames[k], want, rtol=0, atol=0)
    assert not torch.equal(frames[0], frames[2])


# ---- the neural surrogate with a texture ------------------------------------------

NETS = {  # id: (asset, model, bhr_tpu precision, the port's tier, spin)
    "n1-default": ("neural_schwarzschild.npz", "schwarzschild", None, "default", 0.0),
    "n2-default": ("neural_kerr.npz", "kerr", None, "default", 0.9),
    "n2-fp32-highest": ("neural_kerr_default.npz", "kerr", "highest", "highest", 0.9),
}


def _net(asset, model):
    jp, _ = (jnk if model == "kerr" else jn).load_params(str(tn.ASSETS_DIR / asset))
    tp, _ = (tnk if model == "kerr" else tn).load_params(tn.ASSETS_DIR / asset)
    return jp, tp


@pytest.mark.parametrize("net", list(NETS))
def test_dirs_plain_version_matches_jax_interpret_kernel(net):
    asset, model, jprec, tier, spin = NETS[net]
    jp, tp = _net(asset, model)
    jsc, tsc = _scenes(spin=spin)
    want = j_neural_trace_dirs(jp, J.Camera.new(*SIDE), jsc, interpret=True, precision=jprec)
    got = neural_kernel.neural_trace_dirs_reference(tp, T.Camera.new(*SIDE), tsc, precision=tier,
                                                    device="cpu")
    vd = np.abs(got.final_vel.numpy() - np.asarray(want.final_vel)).max(-1)
    assert (vd <= 1e-4).mean() >= (0.999 if tier == "highest" else 0.99), (vd <= 1e-4).mean()
    assert vd.max() <= 5e-3, vd.max()
    st = got.status.numpy()
    assert (st == np.asarray(want.status)).mean() >= 0.999
    assert set(np.unique(st)) == {STATUS_ESCAPED, STATUS_CAPTURED}
    np.testing.assert_array_equal(got.final_pos.numpy(), np.asarray(want.final_pos))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(np.linalg.norm(got.final_vel.numpy(), axis=-1), 1.0, atol=1e-6)


def test_neural_trace_dirs_wrapper_on_the_cpu():
    """On a CPU tensor the wrapper is its plain version; out= receives the
    planes; the frame kernel's plain version shades the same directions."""
    _, tp = _net("neural_schwarzschild.npz", "schwarzschild")
    _, tsc = _scenes(32, 24)
    cam = T.Camera.default()
    want = neural_kernel.neural_trace_dirs_reference(tp, cam, tsc, device="cpu")
    got = neural_kernel.neural_trace_dirs(tp, cam, tsc, device="cpu")
    out = trace_kernel.empty_trace_result(24, 32, "cpu")
    res = neural_kernel.neural_trace_dirs(tp, cam, tsc, device="cpu", out=out)
    for r in (got, res):
        assert torch.equal(r.final_vel, want.final_vel) and torch.equal(r.status, want.status)
        assert int(r.steps.min()) == tsc.max_steps and torch.equal(r.final_pos[3, 4], cam.position)
    assert res.final_vel is out.final_vel
    with pytest.raises(ValueError, match="tiers"):
        neural_kernel.neural_trace_dirs(tp, cam, tsc, precision="high", device="cpu")
    wide = T.NeuralSurrogate([(np.zeros((16, 1280), np.float32), np.zeros(1280, np.float32)),
                              (np.zeros((1280, 2), np.float32), np.zeros(2, np.float32))])
    with pytest.raises(ValueError, match="no block"):
        neural_kernel.neural_trace_dirs(wide, cam, tsc, device="cpu")


ROUTES = [  # (id, skybox, tonemap, debug, dtype, precision, narrow net) -> the call reached
    ("stars", False, "passthrough", 0, "float32", "default", False, "neural_render_packed"),
    ("stars-srgb", False, "srgb", 0, "float32", "default", False, "neural_trace_image"),
    ("tex", True, "passthrough", 0, "float32", "default", False, "neural_trace_dirs"),
    ("tex-srgb", True, "srgb", 0, "float32", "default", False, "neural_trace_dirs"),
    ("tex-reinhard-highest", True, "reinhard", 0, "float32", "highest", False,
     "neural_trace_dirs"),
    ("tex-debug", True, "passthrough", 1, "float32", "default", False, "neural_trace_image"),
    ("tex-bf16", True, "passthrough", 0, "bfloat16", "default", False, "neural_trace_image"),
    ("tex-high", True, "passthrough", 0, "float32", "high", False, "neural_trace_image"),
    ("tex-narrow-net", True, "passthrough", 0, "float32", "default", True, "neural_trace_image"),
]


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_neural_routing_table(route, small_skybox, monkeypatch):
    """Which call each combination reaches (bhr_tpu/renderer.py:184-252):
    the frame kernel only without a skybox, with the passthrough tonemap;
    the direction-plane kernel with a skybox whatever the tonemap, for
    float32 at the default or highest tier and a net the kernel takes; the
    staged route for everything else."""
    _, skybox, tonemap, debug, dtype, precision, narrow, reached = route
    calls = _spy(monkeypatch, "neural_render_packed", "neural_trace_dirs", "neural_trace_image")
    params = None
    if narrow:  # hidden width 64: not a multiple of 128
        rng = np.random.default_rng(0)
        params = [(rng.standard_normal((16, 64)).astype(np.float32) * 0.2,
                   np.zeros(64, np.float32)),
                  (rng.standard_normal((64, 2)).astype(np.float32) * 0.2, np.zeros(2, np.float32))]
    r = T.BlackHoleRenderer(32, 24, "neural", device="cpu", tonemap=tonemap, neural_dtype=dtype,
                            neural_precision=precision, neural_params=params,
                            skybox=small_skybox if skybox else None)
    frame = r.render_frame(scene=T.SceneParams(debug_mode=debug))
    assert frame.shape == (24, 32, 4)
    assert calls == {k: int(k == reached) for k in calls}


def test_neural_textured_frame_matches_jax_staged(small_skybox):
    """The renderer's neural + skybox frame (direction-plane route, default
    tier) against bhr_tpu's staged path at bf16 operands on the same
    texture: within 1 level on >= 99% of pixels."""
    jp, tp = _net("neural_schwarzschild.npz", "schwarzschild")
    jsc, tsc = _scenes()
    jr = J.BlackHoleRenderer(W, H, "neural", use_pallas=False, skybox=small_skybox,
                             neural_dtype="bfloat16", tonemap="srgb")
    tr = T.BlackHoleRenderer(W, H, "neural", device="cpu", skybox=small_skybox, tonemap="srgb")
    want = np.asarray(jr.render_frame(J.Camera.new(*SIDE), jsc))
    got = tr.render_frame(T.Camera.new(*SIDE), tsc).numpy()
    assert _within_1(got, want) >= 0.99


# ---- on the card --------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("net", list(NETS))
def test_dirs_kernel_matches_plain_version_on_gpu(net):
    """csrc/neural_mlp.cu's direction-plane output against its plain
    version on the card, 160x96: status equal on >= 99.9%; directions
    within 1e-6 on >= 99.9% at the highest tier (the fp32 sums are taken
    in another order than cuBLAS's) and within 1e-4 on >= 99.5% at the
    default tier (a bf16 rounding that flips in a hidden layer moves a
    direction near the capture fold by more)."""
    _need_cuda()
    asset, model, _, tier, spin = NETS[net]
    tp = _net(asset, model)[1].to("cuda")
    scene = T.SceneParams(screen_width=160, screen_height=96, spin=spin)
    cam = T.Camera.new(*SIDE)
    n = COUNTS["launch.neural_mlp.dirs"], COUNTS["launch.neural_mlp"]
    got = neural_kernel.neural_trace_dirs(tp, cam, scene, precision=tier, device="cuda")
    torch.cuda.synchronize()
    assert (COUNTS["launch.neural_mlp.dirs"], COUNTS["launch.neural_mlp"]) == (n[0] + 1, n[1])
    want = neural_kernel.neural_trace_dirs_reference(tp, cam, scene, precision=tier,
                                                     device="cuda")
    assert (got.status == want.status).float().mean().item() >= 0.999
    vd = (got.final_vel - want.final_vel).abs().amax(-1)
    if tier == "highest":
        assert (vd <= 1e-6).float().mean().item() >= 0.999
    assert (vd <= 1e-4).float().mean().item() >= 0.995
    assert torch.equal(got.final_pos[5, 7].cpu(), cam.position)
    assert int(got.steps.min()) == scene.max_steps


@pytest.mark.gpu
@pytest.mark.parametrize("tier", TIERS[:5], ids=[f"{f}-{s}" for f, s in TIERS[:5]])
def test_textured_frame_on_gpu_matches_all_plain_frame(tier, small_skybox):
    """Kernel trace + device epilogue against the plain trace + the same
    epilogue, exact tier: bit-equal on >= 99.9% of pixels."""
    _need_cuda()
    filt, sub = tier
    r = T.BlackHoleRenderer(160, 96, "rk4", disk=True, device="cuda", skybox=small_skybox,
                            texture_filter=filt, texture_subsample=sub)
    cam = T.Camera.new(*DISK)
    scene = r.frame_scene(T.SceneParams(max_steps=200))
    n = COUNTS["launch.trace_planes"], COUNTS["launch.render_mono"]
    got = r.render_frame(cam, scene)
    torch.cuda.synchronize()
    assert (COUNTS["launch.trace_planes"], COUNTS["launch.render_mono"]) == (n[0] + 1, n[1])
    res = trace_kernel.trace_image_reference(cam, scene, r.config, device="cuda")
    want = unpack_frame(r._frame_plan(scene).shade(res, cam))
    assert (got == want).all(-1).float().mean().item() >= 0.999
