"""What bhr_tpu_torch refuses to do: import JAX, render on the CPU when a
CUDA device was asked for, or quietly render a configuration outside what
it has ported -- and the configurations it renders now that once raised,
plugin physics among them (a plugin the kernel cannot record raises when
a CUDA device is asked for)."""

import functools
import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu_torch.ops import neural_kernel, trace, trace_kernel
from bhr_tpu_torch.parallel import mesh
from bhr_tpu_torch.utils import build
from bhr_tpu_torch.utils.tracing import COUNTS


def _no_force(rel, vel, r, r2, rs, spin):
    """A plugin with zero acceleration: the flat model's trace."""
    return (0.0, 0.0, 0.0)


def _torch_plugin(rel, vel, r, r2, rs, spin):
    """A plugin the kernel cannot record: it calls a torch function."""
    z = torch.zeros_like(rel[0])
    return (z, z, z)


PLUGIN = dict(model="custom", custom_accel=_no_force, custom_capture_factor=1.05)

MODULES = [
    "bhr_tpu_torch", "bhr_tpu_torch.animation", "bhr_tpu_torch.renderer",
    "bhr_tpu_torch.from_numpy", "bhr_tpu_torch.io.image", "bhr_tpu_torch.ops.trace_kernel",
    "bhr_tpu_torch.ops.trace", "bhr_tpu_torch.ops.shading", "bhr_tpu_torch.ops.starfield",
    "bhr_tpu_torch.ops.sampling", "bhr_tpu_torch.ops.geodesic", "bhr_tpu_torch.models.flat",
    "bhr_tpu_torch.models.schwarzschild", "bhr_tpu_torch.core.camera",
    "bhr_tpu_torch.core.scene", "bhr_tpu_torch.core.math", "bhr_tpu_torch.utils.build",
    "bhr_tpu_torch.models.disk", "bhr_tpu_torch.ops.display", "bhr_tpu_torch.ops.heatmap",
    "bhr_tpu_torch.models.kerr", "bhr_tpu_torch.models.kerr_schild",
    "bhr_tpu_torch.models.neural", "bhr_tpu_torch.models.neural_kerr",
    "bhr_tpu_torch.ops.neural_trace", "bhr_tpu_torch.ops.neural_kernel",
    "bhr_tpu_torch.io.skybox", "bhr_tpu_torch.io.native", "bhr_tpu_torch.ops.resample",
    "bhr_tpu_torch.ops.multires", "bhr_tpu_torch.parallel", "bhr_tpu_torch.parallel.mesh",
    "bhr_tpu_torch.utils.plugin", "bhr_tpu_torch.utils.tracing",
]


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bhr_tpu',"
        " 'triton'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_render_packed_on_cuda_raises_without_cuda():
    _need_no_cuda()
    scene = T.SceneParams(screen_width=8, screen_height=8, max_steps=4)
    launches = COUNTS["launch.render_mono"], COUNTS["launch.trace_planes"]
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            trace_kernel.render_packed(T.Camera.default(), scene, device=device)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            trace_kernel.trace_image(T.Camera.default(), scene, device=device)
    assert (COUNTS["launch.render_mono"], COUNTS["launch.trace_planes"]) == launches


def test_cuda_context_raises_without_cuda():
    _need_no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.CudaContext.new()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.BlackHoleRenderer(8, 8)
    assert T.CudaContext.new("cpu").device == torch.device("cpu")


def test_render_packed_rejects_other_devices():
    scene = T.SceneParams(screen_width=8, screen_height=8, max_steps=4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        trace_kernel.render_packed(T.Camera.default(), scene, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        trace_kernel.trace_image(T.Camera.default(), scene, device="meta")


def test_no_fallback_in_the_cuda_path():
    """The wrapper and the build have no `try`: a failed build or launch
    raises where it happened instead of running something else."""
    for fn in (trace_kernel.render_packed, trace_kernel.trace_image, trace_kernel._set_disk_lut,
               neural_kernel.neural_render_packed, neural_kernel.neural_trace_dirs,
               neural_kernel._launch, neural_kernel.neural_render_packed_band, T.render_multires,
               T.ops.multires.render_multires_band, T.renderer._FramePlan.render, mesh._Bands.render,
               mesh.render_frame_sharded, mesh.render_animation_sharded, build.build,
               build.load_render_mono, build.load_trace_planes, build.load_trace_planes_custom,
               build.load_neural_mlp):
        assert "try:" not in inspect.getsource(fn), fn.__name__


@pytest.mark.parametrize(
    "args,kw,item",
    [
        (("euler",), dict(model="kerr", skybox="sky.exr"), "item 10"),
        # the neural surrogate with a texture skybox goes through the
        # direction-plane kernel's wrapper (N3)
        (("neural_kerr",), dict(skybox="sky.exr"), "item 10"),
        (("src/ray_tracer_kerr.wgsl",), dict(multires=2), "item 12"),
        (("euler",), dict(skybox="sky.exr"), "item 10"),
        (("neural",), dict(skybox="sky.exr"), "item 10"),
        (("euler",), dict(neural_params={}, multires=3), "item 12"),
        (("euler",), dict(multires=3), "item 12"),
        (("euler",), dict(model="custom"), "item 14"),
        (("euler",), dict(custom_physics="plugin.py"), "item 14"),
    ],
)
def test_renderer_outside_slice_raises(args, kw, item, tmp_path):
    """Each case raised until its slice. The texture-skybox and multires
    cases (items 10 and 12) render: the skybox, an EXR file, is loaded and
    sampled, and the multires frame comes from the strided and the masked
    trace. Plugin physics (item 14) renders a plugin file through the
    staged path, as bhr_tpu does; model="custom" without one raises
    bhr_tpu's ValueError."""
    if item == "item 14":
        if "model" in kw:
            with pytest.raises(ValueError, match="custom_physics"):
                T.BlackHoleRenderer(8, 8, *args, device="cpu", **kw)
            return
        path = tmp_path / kw["custom_physics"]
        path.write_text("def acceleration(rel, vel, r, r2, rs, spin):\n"
                        "    f = -0.5 * rs / (r * r * r)\n"
                        "    return (rel[0] * f, rel[1] * f, rel[2] * f)\n")
        r = T.BlackHoleRenderer(24, 16, *args, device="cpu", custom_physics=str(path))
        scene = T.SceneParams(screen_width=24, screen_height=16, max_steps=120)
        cam = T.Camera.new([0.0, 3.0, 11.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        frame = r.render_frame(cam, scene)
        res = trace_kernel.trace_image(cam, scene, r.config, device="cpu")
        assert r.config.model == "custom" and bool((res.status == trace.STATUS_CAPTURED).any())
        want = T.shade_image(res, cam, scene, None, None, tonemap="passthrough")
        torch.testing.assert_close(frame, want, rtol=0, atol=0)
        return
    kw = dict(kw)
    tex = None
    if "skybox" in kw:
        rng = np.random.default_rng(10)
        kw["skybox"] = str(tmp_path / kw["skybox"])
        T.io.skybox.write_exr(kw["skybox"], rng.random((16, 32, 4), np.float32) * 2.0)
        tex = T.ops.sampling.pack_texture_rgba8(T.load_skybox(kw["skybox"]))
    r = T.BlackHoleRenderer(24, 16, *args, device="cpu", **kw)
    scene = T.SceneParams(screen_width=24, screen_height=16, max_steps=120, spin=0.9)
    cam = T.Camera.new([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    neural = r.config.integrator == "neural"
    counts = (COUNTS["launch.trace_planes"], COUNTS["launch.neural_mlp.dirs"])
    if item == "item 12":
        assert r.multires == kw["multires"]
        frame = r.render_frame_multires(cam, scene, divisor=r.multires)
        full = r.render_frame(cam, scene)
        # the multires frame approximates the full one (bhr_tpu's budget,
        # tests/test_multires.py:97-151: mean u8 error under 3 levels)
        assert (frame.int() - full.int()).abs().float().mean() < 3.0
    else:
        torch.testing.assert_close(r.skybox, tex, rtol=0, atol=0)
        frame = r.render_frame(cam, scene)
        trace_fn = (functools.partial(neural_kernel.neural_trace_dirs, r.neural_params,
                                      precision=r.neural_precision) if neural
                    else functools.partial(trace_kernel.trace_image, config=r.config))
        want = T.shade_image(trace_fn(cam, scene, device="cpu"), cam, scene, None, None,
                             tonemap="passthrough", skybox=tex)
        torch.testing.assert_close(frame, want, rtol=0, atol=0)
        # the texture, not the analytic star field, is what was sampled
        bare = T.BlackHoleRenderer(24, 16, *args, device="cpu").render_frame(cam, scene)
        assert not torch.equal(frame, bare)
    assert frame.shape == (16, 24, 4) and frame.dtype == torch.uint8
    assert bool((frame[..., 3] == 255).all())
    # on the CPU every wrapper ran its plain version: nothing was launched
    assert (COUNTS["launch.trace_planes"], COUNTS["launch.neural_mlp.dirs"]) == counts


@pytest.mark.parametrize(
    "args,kw",
    [
        (("rk4",), {}),
        (("leapfrog",), {}),
        (("src/ray_tracer_rk4.wgsl",), {}),
        (("euler",), dict(adaptive=True)),
        (("euler",), dict(model="flat")),
        (("euler",), dict(tonemap="reinhard")),
        (("euler",), dict(disk=True)),
        (("euler",), dict(model="kerr")),
        (("euler",), dict(model="kerr_lt")),
        (("src/ray_tracer_kerr.wgsl",), {}),
    ],
    ids=["rk4", "leapfrog", "rk4-wgsl", "adaptive", "flat", "reinhard", "disk", "kerr",
         "kerr_lt", "kerr-wgsl"],
)
def test_renderer_renders_what_once_raised(args, kw):
    """Each configuration that raised before this slice or an earlier one
    renders, and agrees with bhr_tpu's renderer (oracle path, exact tier)
    at 24x16x120, spin 0.9, within 1 level on every pixel."""
    jr = J.BlackHoleRenderer(24, 16, *args, use_pallas=False, **kw)
    cam = ([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    want = np.asarray(jr.render_frame(
        J.Camera.new(*cam), J.SceneParams(screen_width=24, screen_height=16, max_steps=120,
                                          spin=np.float32(0.9))))
    tr = T.BlackHoleRenderer(24, 16, *args, device="cpu", **kw)
    got = tr.render_frame(T.Camera.new(*cam),
                          T.SceneParams(screen_width=24, screen_height=16, max_steps=120,
                                        spin=0.9))
    assert tr.config.integrator == jr.config.integrator and tr.config.model == jr.config.model
    diff = np.abs(got.numpy().astype(int) - want.astype(int)).max(-1)
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("kw", [dict(tile=(8, 128)), dict(kernel_knobs=(64, 1, 1)),
                                dict(use_pallas=True), dict(interpret=True)])
def test_renderer_takes_no_tpu_tuning_arguments(kw):
    with pytest.raises(TypeError):
        T.BlackHoleRenderer(8, 8, device="cpu", **kw)


def test_debug_heatmap_raises():
    """The monolithic kernel has no debug view and refuses one; the
    renderer sends the heatmap down the staged path instead, where it is
    the step counts' colour ramp (wgsl:204-211)."""
    scene = T.SceneParams(screen_width=8, screen_height=8, max_steps=40, debug_mode=1)
    with pytest.raises(ValueError, match="staged epilogue"):
        trace_kernel.render_packed(T.Camera.default(), scene, device="cpu")
    r = T.BlackHoleRenderer(8, 8, device="cpu")
    frame = r.render_frame(scene=scene)
    steps = trace_kernel.trace_image(T.Camera.default(), scene, device="cpu").steps
    want = T.ops.heatmap.steps_to_color(steps, 40)
    want = T.ops.sampling.unpack_frame(T.ops.sampling.pack_rgba8_planes(*want.unbind(-1)))
    torch.testing.assert_close(frame, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "config",
    [T.TraceConfig(**PLUGIN), T.TraceConfig(integrator="leapfrog", **PLUGIN),
     T.TraceConfig(integrator="neural")],
    ids=["custom", "custom-leapfrog", "neural"],
)
def test_trace_and_render_outside_slice_raise(config):
    """The geodesic tracer and kernels refuse what they do not integrate,
    the neural surrogate included; render_image renders a neural frame
    with its weights (the surrogate's own route) and refuses one without.
    Plugin physics raised until its slice: now it traces (a plugin of zero
    force is the flat model) and renders staged, and only the monolithic
    kernel refuses it."""
    scene = T.SceneParams(screen_width=4, screen_height=4, max_steps=2)
    origins, dirs = T.generate_rays(T.Camera.default(), 4, 4, scene.fov)
    if config.model == "custom":
        res = trace.trace_rays(origins, dirs, torch.zeros(3), 2.0, 0.0, 2, config)
        flat = trace.trace_rays(origins, dirs, torch.zeros(3), 2.0, 0.0, 2,
                                T.TraceConfig(integrator=config.integrator, model="flat"))
        for name in ("final_pos", "final_vel", "status", "steps"):
            assert torch.equal(getattr(res, name), getattr(flat, name)), name
        with pytest.raises(ValueError, match="plugin physics"):
            trace_kernel.render_packed(T.Camera.default(), scene, config, device="cpu")
        planes = trace_kernel.trace_image(T.Camera.default(), scene, config, device="cpu")
        frame = T.render_image(T.Camera.default(), scene, config=config, fast_math=False,
                               device="cpu")
        torch.testing.assert_close(frame, T.shade_image(planes, T.Camera.default(), scene, None,
                                                        None, tonemap="passthrough"),
                                   rtol=0, atol=0)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace.trace_rays(origins, dirs, torch.zeros(3), 2.0, 0.0, 2, config)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace_kernel.render_packed(T.Camera.default(), scene, config, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace_kernel.trace_image(T.Camera.default(), scene, config, device="cpu")
    if config.integrator == "neural":
        with pytest.raises(ValueError, match="neural_params"):
            T.render_image(T.Camera.default(), scene, config=config, fast_math=False,
                           device="cpu")
        params, _ = T.models.neural.load_params(T.models.neural.ASSETS_DIR
                                                / "neural_schwarzschild.npz")
        frame = T.render_image(T.Camera.default(), scene, config=config, fast_math=False,
                               device="cpu", neural_params=params)
        assert frame.shape == (4, 4, 4) and frame.dtype == torch.uint8
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.render_image(T.Camera.default(), scene, config=config, fast_math=False,
                       device="cpu")


@pytest.mark.parametrize(
    "config",
    [T.TraceConfig(integrator="rk4"), T.TraceConfig(integrator="leapfrog"),
     T.TraceConfig(adaptive=True), T.TraceConfig(disk=True), T.TraceConfig(model="kerr"),
     T.TraceConfig(model="kerr_lt", disk=True)],
    ids=["rk4", "leapfrog", "adaptive", "disk", "kerr", "kerr_lt-disk"],
)
def test_trace_and_render_what_once_raised(config):
    """trace_rays, the monolithic wrapper and render_image take each
    configuration that raised before this slice or an earlier one (spin
    0.9); render_image is the monolithic frame wherever the route takes
    it: the fast tier, and the exact tier without the disk but for
    kerr_lt."""
    scene = T.SceneParams(screen_width=12, screen_height=8, max_steps=60, spin=0.9)
    cam = T.Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    origins, dirs = T.generate_rays(cam, 12, 8, scene.fov)
    res = trace.trace_rays(origins, dirs, torch.zeros(3), 2.0, 0.9, 60, config)
    assert res.status.shape == (8, 12) and int(res.steps.max()) == 60
    for fast in (False, True):
        frame = T.render_image(cam, scene, config=config, fast_math=fast, device="cpu",
                               packed=True)
        if trace_kernel.monolithic_eligible(config, scene, fast_math=fast, skybox=None,
                                            disk_params=None, tonemap="passthrough"):
            mono = trace_kernel.render_packed(cam, scene, config, fast_math=fast, device="cpu")
            torch.testing.assert_close(frame, mono, rtol=0, atol=0)


@pytest.mark.parametrize(
    "kw,config",
    [(dict(skybox=object()), T.TraceConfig()),
     (dict(skybox=object()), T.TraceConfig(disk=True)),
     ({}, T.TraceConfig(**PLUGIN))],
    ids=["skybox", "skybox-disk", "custom"])
def test_render_image_outside_slice_raises(kw, config):
    """Each case raised until its slice. With a skybox render_image traces
    into planes and samples the texture, with the disk's emission over it
    when the configuration has one; plugin physics is the planes and the
    star-field epilogue, in both tiers."""
    scene = T.SceneParams(screen_width=12, screen_height=8, max_steps=250)
    if "skybox" not in kw:
        for fast in (True, False):
            got = T.render_image(T.Camera.default(), scene, config=config, fast_math=fast,
                                 device="cpu")
            res = trace_kernel.trace_image(T.Camera.default(), scene, config, fast_math=fast,
                                           device="cpu")
            torch.testing.assert_close(got, T.shade_image(res, T.Camera.default(), scene, None,
                                                          None, tonemap="passthrough"),
                                       rtol=0, atol=0)
        return
    tex = T.texture_from_numpy(T.load_skybox(None, seed=1, shape=(16, 32)))
    cam = T.Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    disk = (dict(disk_params=T.models.disk.DiskParams.for_scene(torch.tensor(2.0)),
                 lut=T.models.disk.blackbody_lut()) if config.disk else {})
    for fast in (True, False):
        got = T.render_image(cam, scene, config=config, fast_math=fast, device="cpu",
                             skybox=tex, **disk)
        res = trace_kernel.trace_image(cam, scene, config, fast_math=fast, device="cpu")
        want = T.shade_image(res, cam, scene, disk.get("disk_params"), disk.get("lut"),
                             tonemap="passthrough", skybox=tex)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert config.disk == bool((res.status == trace.STATUS_DISK).any())


@pytest.mark.parametrize("what", ["strided", "masked", "neural_dirs", "renderer-skybox",
                                  "renderer-multires"])
def test_texture_and_multires_on_cuda_raise_without_cuda(what):
    """The strided and masked trace, the direction-plane kernel and the
    renderer paths built on them never run a plain version when a CUDA
    device was asked for and there is none."""
    _need_no_cuda()
    scene = T.SceneParams(screen_width=8, screen_height=8, max_steps=4)
    cam = T.Camera.default()
    counts = (COUNTS["launch.trace_planes"], COUNTS["launch.neural_mlp.dirs"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        if what == "strided":
            trace_kernel.trace_image(cam, scene, device="cuda", stride=2, local_shape=(4, 4))
        elif what == "masked":
            trace_kernel.trace_image(cam, scene, device="cuda", mask=torch.ones(8, 8))
        elif what == "neural_dirs":
            params, _ = T.models.neural.load_params(T.models.neural.ASSETS_DIR
                                                    / "neural_schwarzschild.npz")
            neural_kernel.neural_trace_dirs(params, cam, scene, device="cuda")
        elif what == "renderer-skybox":
            T.BlackHoleRenderer(8, 8, skybox=np.zeros((4, 8, 4), np.float32))
        else:
            T.render_multires(cam, scene, device="cuda", divisor=2)
    assert (COUNTS["launch.trace_planes"], COUNTS["launch.neural_mlp.dirs"]) == counts


def test_plugin_and_mesh_guards_without_cuda():
    """A plugin that calls a torch function renders with the plain version
    on a CPU device and raises ValueError, naming the call, when a CUDA
    device is asked for; the band, mesh and plugin paths never run a plain
    version on a CUDA device that is not there."""
    r = T.BlackHoleRenderer(8, 8, custom_physics=_torch_plugin, device="cpu")
    assert r.render_frame().shape == (8, 8, 4)
    for kw in ({}, dict(device="cuda")):
        with pytest.raises(ValueError, match="torch function zeros_like"):
            T.BlackHoleRenderer(8, 8, custom_physics=_torch_plugin, **kw)
    _need_no_cuda()
    scene = T.SceneParams(screen_width=8, screen_height=8, max_steps=4)
    cam = T.Camera.default()
    keys = ("launch.render_mono", "launch.trace_planes", "launch.trace_planes.custom",
            "launch.neural_mlp.band")
    counts = [COUNTS[k] for k in keys]
    params, _ = T.models.neural.load_params(T.models.neural.ASSETS_DIR
                                            / "neural_schwarzschild.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    for call in (
            lambda: trace_kernel.trace_image(cam, scene, T.TraceConfig(**PLUGIN), device="cuda"),
            lambda: trace_kernel.render_packed(cam, scene, device="cuda", row0=4,
                                               local_shape=(4, 8)),
            lambda: neural_kernel.neural_render_packed_band(params, cam, scene, 4, 4,
                                                            device="cuda"),
            lambda: mesh.render_frame_sharded(cam, scene, None, mesh.make_mesh(
                devices=["cuda"] * 2))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    assert [COUNTS[k] for k in keys] == counts


def test_render_image_tonemap_and_disk_params_take_the_staged_path():
    """A tonemap or the exact tier's disk goes through the planes kernel's
    wrapper and the epilogue; an unknown tonemap raises."""
    scene = T.SceneParams(screen_width=12, screen_height=8, max_steps=40)
    cam = T.Camera.new([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    res = trace_kernel.trace_image(cam, scene, T.TraceConfig(disk=True), device="cpu")
    p = T.models.disk.DiskParams.for_scene(torch.tensor(2.0))
    lut = T.models.disk.blackbody_lut()
    got = T.render_image(cam, scene, config=T.TraceConfig(disk=True), fast_math=False,
                         device="cpu", tonemap="srgb", disk_params=p, lut=lut)
    want = T.renderer.shade_image(res, cam, scene, p, lut, tonemap="srgb")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="tonemap"):
        T.render_image(cam, scene, config=T.TraceConfig(), fast_math=True, device="cpu",
                       tonemap="filmic")


def test_fast_tier_flat_trace_is_a_straight_line():
    """The fast tier traces flat spacetime too (it raised before this
    slice): each ray's position advances along its unchanged direction."""
    origins, dirs = T.generate_rays(T.Camera.default(), 4, 4, T.SceneParams().fov)
    for integ in ("euler", "rk4", "leapfrog"):
        res = trace.trace_rays(origins, dirs, torch.zeros(3), 0.0, 0.0, 20,
                               T.TraceConfig(integrator=integ, model="flat"), fast_math=True)
        unit = T.normalize(dirs)
        torch.testing.assert_close(res.final_vel, unit, rtol=0, atol=3e-7)
        torch.testing.assert_close(res.final_pos, origins + unit * 2.0, rtol=0, atol=2e-5)


def test_build_is_keyed_by_source_hash():
    """The library name carries a hash of the sources and flags, so an edited
    kernel is rebuilt; nothing is built or loaded when the package imports."""
    h = build._source_hash(build.RENDER_MONO_SOURCES)
    assert len(h) == 16 and h == build._source_hash(build.RENDER_MONO_SOURCES)
    assert h != build._source_hash(build.TRACE_PLANES_SOURCES)
    for loader in (build.load_render_mono, build.load_trace_planes):
        assert loader.cache_info().currsize == 0 or torch.cuda.is_available()
    assert {p.name for p in build.CSRC_DIR.glob("*.cu*")} >= {
        "render_mono.cu", "trace_planes.cu", "trace_ray.cuh", "common.cuh"}
