"""Row bands and the device mesh of the port (bhr_tpu_torch/parallel/mesh.py
and the band arguments of the kernels' wrappers) against bhr_tpu's
parallel/mesh.py, on the CPU: the port's mesh is a grid of "cpu" devices,
bhr_tpu's the 8 host devices of tests/conftest.py, and every wrapper runs
its plain version (bhr_tpu's Pallas kernels in interpret mode).

Bars. A band is bit for bit the same rows of the port's whole frame, for
every route, and a sharded frame is the port's whole frame. Against
bhr_tpu, where both sides are the same plain arithmetic (the exact tier:
bhr_tpu's oracle and the port's plain version, star field or texture), the
frames agree as tests/test_torch_render.py holds the exact tier: bit-equal
on >= 99.9% of pixels and within 1 level on every one (the plain
renormalisation's torch.sqrt is an ulp off on the CPU, ROADMAP queue C);
the multires frame, whose bhr_tpu side runs its fast-tier Pallas kernel,
within 1 level on >= 99% of pixels as tests/test_torch_multires.py holds
it; N4 at bhr_tpu's bars for its neural kernel (tests/test_torch_neural.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.models import neural as jn
from bhr_tpu.models import neural_kerr as jnk
from bhr_tpu.ops.neural_pallas import neural_render_packed_band as j_band
from bhr_tpu.ops.sampling import unpack_frame as j_unpack
from bhr_tpu.parallel import mesh as jmesh
from bhr_tpu_torch.models import neural as tn
from bhr_tpu_torch.ops import multires, neural_kernel, trace_kernel
from bhr_tpu_torch.ops.neural_trace import neural_trace_image
from bhr_tpu_torch.parallel import mesh as tmesh
from bhr_tpu_torch.utils.tracing import COUNTS

from test_torch_neural import assert_frames_agree

SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
CPU8 = ["cpu"] * 8


def _scenes(w=64, h=32, steps=30, spin=0.0):
    return (J.SceneParams(screen_width=w, screen_height=h, max_steps=steps,
                          spin=np.float32(spin)),
            T.SceneParams(screen_width=w, screen_height=h, max_steps=steps, spin=spin))


def _net(model):
    load = jnk.load_params if model == "kerr" else jn.load_params
    asset = "neural_kerr.npz" if model == "kerr" else "neural_schwarzschild.npz"
    jp, _ = load(str(tn.ASSETS_DIR / asset))
    return jp, T.neural_params_from_numpy(jp)


def assert_exact_frames_agree(got, want):
    """The exact tier's bar against bhr_tpu on uint8 (..., H, W, 4) frames."""
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))[..., :3].max(-1)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff > 0).mean()


def _need_jax_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs bhr_tpu's 8 host devices (tests/conftest.py)")


# ---- bands on one device ------------------------------------------------------

BAND_ROUTES = ["render_packed-fast", "render_packed-exact", "trace_image-kerr",
               "neural-schwarzschild-default", "neural-kerr-highest", "neural_dirs",
               "neural_trace_image", "multires-d3"]


@pytest.mark.parametrize("route", BAND_ROUTES)
def test_band_equals_the_rows_of_the_whole_frame(route):
    """Every route's band, rows [5, 12) and a band past the frame's bottom
    (rows [14, 21) of 18), is bit for bit the same rows of its whole frame:
    ray-gen refers to the frame's size."""
    scene = T.SceneParams(screen_width=24, screen_height=18, max_steps=60, spin=0.9)
    cam = T.Camera.new(*SIDE)
    if route.startswith("render_packed"):
        fn = trace_kernel.render_packed
        kw = dict(fast_math=route.endswith("fast"))
    elif route == "trace_image-kerr":
        fn = trace_kernel.trace_image
        kw = dict(config=T.TraceConfig(integrator="rk4", model="kerr"))
    elif route.startswith("neural-"):
        model, precision = route.split("-")[1:]
        fn = neural_kernel.neural_render_packed
        kw = dict(params=_net(model)[1], precision=precision)
    elif route == "neural_dirs":
        fn = neural_kernel.neural_trace_dirs
        kw = dict(params=_net("kerr")[1])
    elif route == "neural_trace_image":
        fn = neural_trace_image
        kw = dict(params=_net("schwarzschild")[1])
    else:
        def fn(camera, scene, device, row0=0, local_shape=None):
            if local_shape is None:
                return multires.render_multires(camera, scene, device=device, divisor=3,
                                                packed=True)
            return multires.render_multires_band(camera, scene, device=device, divisor=3,
                                                 row0=row0, band_h=local_shape[0])
        kw = {}
    whole = fn(camera=cam, scene=scene, device="cpu", **kw)
    for row0, rows in ((5, 7), (14, 4)):
        band = fn(camera=cam, scene=scene, device="cpu", row0=row0, local_shape=(7, 24), **kw)
        for name in ("final_pos", "final_vel", "status", "steps", None):
            if name is None and isinstance(band, torch.Tensor):
                assert band.shape[0] == 7
                assert torch.equal(band[:rows], whole[row0:row0 + rows]), route
            elif name is not None and not isinstance(band, torch.Tensor):
                assert torch.equal(getattr(band, name)[:rows],
                                   getattr(whole, name)[row0:row0 + rows]), (route, name)


@pytest.mark.parametrize("model", ["schwarzschild", "kerr"])
def test_neural_band_matches_jax_interpret_kernel(model):
    """N4's plain version against bhr_tpu's neural_render_packed_band in
    interpret mode, rows [16, 40) of a 64x48 frame from the side camera
    (Kerr at spin 0.9), at bhr_tpu's bars for its neural kernel in the
    default tier (bhr_tpu's band takes no other: queue C)."""
    jp, tp = _net(model)
    jscene, scene = _scenes(64, 48, 500, 0.9 if model == "kerr" else 0.0)
    jcam, cam = J.Camera.new(*SIDE), T.Camera.new(*SIDE)
    want = j_unpack(j_band(jp, jcam, jscene, 16, 24, interpret=True))
    got = neural_kernel.neural_render_packed_band(tp, cam, scene, 16, 24, device="cpu")
    assert got.shape == (24, 64)
    assert_frames_agree(T.ops.sampling.unpack_frame(got).numpy(), np.asarray(want))


# ---- the mesh ----------------------------------------------------------------


def test_make_mesh_shapes_and_devices():
    assert tmesh.make_mesh(8, devices=CPU8).shape == {"dp": 2, "sp": 4}
    assert tmesh.make_mesh(1, devices=CPU8).shape == {"dp": 1, "sp": 1}
    assert tmesh.make_mesh(8, shape=(1, 8), devices=CPU8).shape == {"dp": 1, "sp": 8}
    assert tmesh.make_mesh(devices=["cpu"] * 3).shape == {"dp": 1, "sp": 3}
    mesh = tmesh.make_mesh(4, shape=(2, 2), devices=CPU8)
    assert mesh.devices == ((torch.device("cpu"),) * 2,) * 2
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh(4, shape=(2, 3), devices=CPU8)
    with pytest.raises(ValueError, match="only 8"):
        tmesh.make_mesh(9, devices=CPU8)
    bands = tmesh.shard_image(torch.arange(33 * 2).reshape(33, 2), tmesh.make_mesh(
        8, shape=(1, 8), devices=CPU8))
    assert [b.shape[0] for b in bands] == [5, 5, 5, 5, 5, 5, 3, 0]
    assert torch.equal(torch.cat(bands), torch.arange(33 * 2).reshape(33, 2))


def _textures(kind):
    tex = T.load_skybox(None, seed=7, shape=(64, 128))
    jtex = jnp.asarray(J.ops.sampling.pack_texture_rgba8(tex))
    if kind == "luma":
        return J.ops.sampling.luma_pack_texture(jtex), T.texture_from_numpy(
            tex, texture_filter="luma")
    return jtex, T.texture_from_numpy(tex)


@pytest.mark.parametrize("case", ["stars", "texture", "luma", "multires"])
def test_sharded_frame_matches_jax(case):
    """The port's render_frame_sharded on 8 "cpu" devices against bhr_tpu's
    on its 8 host devices, 64x32x30: the exact tier's bar for the star
    field, the texture and the band-anchored luma tier; multires d = 2 (fast
    tier, bhr_tpu's interpret-mode kernel) within 1 level on >= 99%."""
    _need_jax_devices()
    jscene, scene = _scenes()
    jcam, cam = J.Camera.default(), T.Camera.default()
    jtex = ttex = None
    kw = {}
    if case in ("texture", "luma"):
        jtex, ttex = _textures(case)
        kw = dict(texture_filter="luma" if case == "luma" else "bilinear")
    if case == "multires":
        kw = dict(multires=2, fast_math=True)
    want = np.asarray(jmesh.render_frame_sharded(jcam, jscene, jtex, jmesh.make_mesh(
        8, shape=(1, 8)), **kw)).astype(int)
    got = tmesh.render_frame_sharded(cam, scene, ttex, tmesh.make_mesh(
        8, shape=(1, 8), devices=CPU8), **kw).numpy().astype(int)
    assert got.shape == (32, 64, 4) and (got[..., 3] == 255).all()
    diff = np.abs(got - want)[..., :3].max(-1)
    if case == "multires":
        assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    else:
        assert_exact_frames_agree(got, want)


def test_sharded_animation_matches_jax():
    """render_animation_sharded on a (2, 4) mesh: 4 orbit frames equal to the
    port's own OrbitAnimator frames and at the exact tier's bar against
    bhr_tpu's, and the luminance the frames' mean green within 1e-5
    (bhr_tpu's rtol), and bhr_tpu's within what its frames' bar allows."""
    _need_jax_devices()
    jscene, scene = _scenes()
    times = np.arange(4, dtype=np.float32) / 60.0
    jf, jl = jmesh.render_animation_sharded(jnp.asarray(times), jscene, None,
                                            jmesh.make_mesh(8))
    frames, lums = tmesh.render_animation_sharded(torch.from_numpy(times), scene, None,
                                                  tmesh.make_mesh(8, devices=CPU8))
    assert frames.shape == (4, 32, 64, 4) and lums.shape == (4,) and lums.dtype == torch.float32
    assert_exact_frames_agree(frames, jf)
    anim = T.OrbitAnimator(T.BlackHoleRenderer(64, 32, device="cpu"))
    torch.testing.assert_close(frames, anim.render_frames(4, fps=60.0, scene=scene),
                               rtol=0, atol=0)
    g_mean = frames.numpy()[..., 1].astype(np.float32).mean(axis=(1, 2))
    np.testing.assert_allclose(lums.numpy(), g_mean, rtol=1e-5)
    # a level off on <= 0.1% of bhr_tpu's pixels moves its mean by <= 1e-3
    np.testing.assert_allclose(lums.numpy(), np.asarray(jl), rtol=0, atol=1e-3)
    assert tmesh.render_animation_sharded(torch.from_numpy(times[:2]), scene, None,
                                          tmesh.make_mesh(8, devices=CPU8),
                                          with_stats=False).shape == (2, 32, 64, 4)
    with pytest.raises(ValueError, match="divide over dp"):
        tmesh.render_animation_sharded(torch.from_numpy(times[:3]), scene, None,
                                       tmesh.make_mesh(8, devices=CPU8))


@pytest.mark.parametrize("h", [33, 30])
def test_non_divisible_height_pads_bands(h):
    """33 and 30 rows on 8 bands of ceil(h / 8): the padded rows are sliced
    off and the frame equals the whole frame; the luminance on (2, 4)
    masks them out."""
    scene = T.SceneParams(screen_width=64, screen_height=h, max_steps=20)
    cam = T.Camera.default()
    sharded = tmesh.render_frame_sharded(cam, scene, None,
                                         tmesh.make_mesh(8, shape=(1, 8), devices=CPU8))
    whole = T.BlackHoleRenderer(64, h, device="cpu").render_frame(cam, scene)
    assert sharded.shape == (h, 64, 4)
    torch.testing.assert_close(sharded, whole, rtol=0, atol=0)
    frames, lums = tmesh.render_animation_sharded(torch.zeros(2), scene, None,
                                                  tmesh.make_mesh(8, devices=CPU8))
    g_mean = frames.numpy()[..., 1].astype(np.float32).mean(axis=(1, 2))
    np.testing.assert_allclose(lums.numpy(), g_mean, rtol=1e-5)


def test_sharded_seed_and_routes_equal_the_whole_frame():
    """The seed reaches every band; the disk (fast: monolithic bands; exact:
    staged), a tonemap, the step heatmap and the neural routes (N4 for the
    Kerr net at "highest"; the staged route at "high"; with a texture, the
    direction planes' band at "default" and the staged route at "high")
    give the renderer's whole frame on every pixel."""
    mesh = tmesh.make_mesh(4, shape=(1, 4), devices=CPU8)
    scene = T.SceneParams(screen_width=32, screen_height=24, max_steps=60, spin=0.9)
    cam = T.Camera.new(*SIDE)
    for kw, debug in ((dict(skybox_seed=7), 0), (dict(integrator="rk4", disk=True,
                                                     fast_math=True), 0),
                      (dict(integrator="rk4", disk=True), 0), (dict(tonemap="srgb"), 0),
                      ({}, 1)):
        r = T.BlackHoleRenderer(32, 24, device="cpu", **kw)
        sc = scene.replace(debug_mode=debug)
        plan = r._frame_plan(sc)
        got = tmesh.render_frame_sharded(cam, sc, None, mesh, config=r.config,
                                         fast_math=r.fast_math, tonemap=r.tonemap,
                                         disk_params=plan.disk_params, lut=plan.lut,
                                         seed=r.skybox_seed)
        torch.testing.assert_close(got, r.render_frame(cam, sc), rtol=0, atol=0, msg=str(kw))
    tex = T.load_skybox(None, seed=7, shape=(64, 128))
    for precision, sky in (("highest", None), ("high", None), ("default", tex), ("high", tex)):
        r = T.BlackHoleRenderer(32, 24, "neural", model="kerr", neural_precision=precision,
                                skybox=sky, device="cpu")
        launches = COUNTS["launch.neural_mlp.band"], COUNTS["launch.neural_mlp.dirs"]
        got = tmesh.render_frame_sharded(cam, scene, r.skybox, mesh, config=r.config,
                                         neural_params=r.neural_params,
                                         neural_precision=precision)
        torch.testing.assert_close(got, r.render_frame(cam, scene), rtol=0, atol=0,
                                   msg=f"{precision}, skybox {sky is not None}")
        # plain versions: no launch
        assert (COUNTS["launch.neural_mlp.band"],
                COUNTS["launch.neural_mlp.dirs"]) == launches
    with pytest.raises(ValueError, match="multires"):
        tmesh.render_frame_sharded(cam, scene, None, mesh, multires=2, tonemap="reinhard")


def test_mesh_keeps_one_surrogate_per_device():
    """A device that does not hold the weights gets the mesh's one copy of
    them, kept across calls (the neural kernel prepares its operands there
    once), and a new copy once a weight changes in place."""
    mesh = tmesh.make_mesh(devices=["cpu", "cpu:0"], shape=(1, 2))
    scene = T.SceneParams(screen_width=16, screen_height=12)
    cam = T.Camera.new(*SIDE)
    r = T.BlackHoleRenderer(16, 12, "neural", device="cpu")
    params, other = r.neural_params, torch.device("cpu:0")
    assert mesh.surrogate_on(params, torch.device("cpu")) is params
    copy = mesh.surrogate_on(params, other)
    assert copy is not params
    for _ in range(2):
        got = tmesh.render_frame_sharded(cam, scene, None, mesh, config=r.config,
                                         neural_params=params)
        torch.testing.assert_close(got, r.render_frame(cam, scene), rtol=0, atol=0)
        assert mesh.surrogate_on(params, other) is copy
    params.b0.mul_(0.5)
    changed = mesh.surrogate_on(params, other)
    assert changed is not copy and torch.equal(changed.b0, params.b0)
    torch.testing.assert_close(tmesh.render_frame_sharded(cam, scene, None, mesh,
                                                          config=r.config, neural_params=params),
                               r.render_frame(cam, scene), rtol=0, atol=0)


# ---- on the card --------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
def test_bands_on_gpu_equal_the_whole_frame():
    """On the card: monolithic and staged bands, N4 in both models and
    tiers, and a (1, 4) mesh of the one card (staged; the neural surrogate
    with a texture), each bit for bit the rows of the whole frame, every
    band one launch of its kernel."""
    _need_cuda()
    scene = T.SceneParams(screen_width=160, screen_height=96, max_steps=200, spin=0.9)
    cam = T.Camera.new(*SIDE)
    for fast in (True, False):
        whole = trace_kernel.render_packed(cam, scene, fast_math=fast, device="cuda")
        band = trace_kernel.render_packed(cam, scene, fast_math=fast, device="cuda", row0=40,
                                          local_shape=(24, 160))
        assert torch.equal(band, whole[40:64])
        res = trace_kernel.trace_image(cam, scene, T.TraceConfig(model="kerr"), fast_math=fast,
                                       device="cuda")
        bres = trace_kernel.trace_image(cam, scene, T.TraceConfig(model="kerr"),
                                        fast_math=fast, device="cuda", row0=40,
                                        local_shape=(24, 160))
        assert torch.equal(bres.final_vel, res.final_vel[40:64])
    for model, precision in (("schwarzschild", "default"), ("kerr", "default"),
                             ("kerr", "highest")):
        params = _net(model)[1].to("cuda")
        whole = neural_kernel.neural_render_packed(params, cam, scene, precision=precision,
                                                   device="cuda")
        n = COUNTS["launch.neural_mlp.band"]
        band = neural_kernel.neural_render_packed_band(params, cam, scene, 40, 24,
                                                       precision=precision, device="cuda")
        torch.cuda.synchronize()
        assert COUNTS["launch.neural_mlp.band"] == n + 1
        assert torch.equal(band, whole[40:64]), (model, precision)
    mesh = tmesh.make_mesh(devices=["cuda:0"] * 4, shape=(1, 4))
    r = T.BlackHoleRenderer(160, 96, "rk4", adaptive=True, disk=True, device="cuda")
    whole = r.render_frame(cam, scene)
    launches = COUNTS["launch.trace_planes"]
    plan = r._frame_plan(scene)
    got = tmesh.render_frame_sharded(cam, scene, None, mesh, config=r.config,
                                     disk_params=plan.disk_params, lut=plan.lut)
    torch.cuda.synchronize()
    assert COUNTS["launch.trace_planes"] == launches + 4
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
    r = T.BlackHoleRenderer(160, 96, "neural", model="kerr", device="cuda",
                            skybox=T.load_skybox(None, seed=7, shape=(64, 128)))
    whole = r.render_frame(cam, scene)
    launches = COUNTS["launch.neural_mlp.dirs"]
    got = tmesh.render_frame_sharded(cam, scene, r.skybox, mesh, config=r.config,
                                     neural_params=r.neural_params,
                                     neural_precision=r.neural_precision)
    torch.cuda.synchronize()
    assert COUNTS["launch.neural_mlp.dirs"] == launches + 4
    torch.testing.assert_close(got, whole, rtol=0, atol=0)
