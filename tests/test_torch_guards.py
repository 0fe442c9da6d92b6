"""What bhr_tpu_torch refuses to do: import JAX, render on the CPU when a
CUDA device was asked for, or quietly render a configuration outside its
slice."""

import inspect
import subprocess
import sys

import pytest
import torch

import bhr_tpu_torch as T
from bhr_tpu_torch.ops import trace, trace_kernel
from bhr_tpu_torch.utils import build

MODULES = [
    "bhr_tpu_torch", "bhr_tpu_torch.animation", "bhr_tpu_torch.renderer",
    "bhr_tpu_torch.from_numpy", "bhr_tpu_torch.io.image", "bhr_tpu_torch.ops.trace_kernel",
    "bhr_tpu_torch.ops.trace", "bhr_tpu_torch.ops.shading", "bhr_tpu_torch.ops.starfield",
    "bhr_tpu_torch.ops.sampling", "bhr_tpu_torch.ops.geodesic", "bhr_tpu_torch.models.flat",
    "bhr_tpu_torch.models.schwarzschild", "bhr_tpu_torch.core.camera",
    "bhr_tpu_torch.core.scene", "bhr_tpu_torch.core.math", "bhr_tpu_torch.utils.build",
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
    launches = trace_kernel.LAUNCHES
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            trace_kernel.render_packed(T.Camera.default(), scene, device=device)
    assert trace_kernel.LAUNCHES == launches


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


def test_no_fallback_in_the_cuda_path():
    """The wrapper and the build have no `try`: a failed build or launch
    raises where it happened instead of running something else."""
    for fn in (trace_kernel.render_packed, build.build, build.load_render_mono):
        assert "try:" not in inspect.getsource(fn), fn.__name__


@pytest.mark.parametrize(
    "args,kw,item",
    [
        (("rk4",), {}, "item 6"),
        (("leapfrog",), {}, "item 6"),
        (("src/ray_tracer_rk4.wgsl",), {}, "item 6"),
        (("euler",), dict(adaptive=True), "item 6"),
        (("euler",), dict(model="flat"), "item 6"),
        (("euler",), dict(tonemap="reinhard"), "item 6"),
        (("euler",), dict(disk=True), "item 8"),
        (("euler",), dict(model="kerr"), "item 9"),
        (("euler",), dict(model="kerr_lt"), "item 9"),
        (("src/ray_tracer_kerr.wgsl",), {}, "item 9"),
        (("euler",), dict(skybox="sky.exr"), "item 10"),
        (("neural",), {}, "item 11"),
        (("euler",), dict(neural_params={}), "item 11"),
        (("euler",), dict(multires=3), "item 12"),
        (("euler",), dict(model="custom"), "item 14"),
        (("euler",), dict(custom_physics="plugin.py"), "item 14"),
    ],
)
def test_renderer_outside_slice_raises(args, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        T.BlackHoleRenderer(8, 8, *args, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(tile=(8, 128)), dict(kernel_knobs=(64, 1, 1)),
                                dict(use_pallas=True), dict(interpret=True)])
def test_renderer_takes_no_tpu_tuning_arguments(kw):
    with pytest.raises(TypeError):
        T.BlackHoleRenderer(8, 8, device="cpu", **kw)


def test_debug_heatmap_raises():
    r = T.BlackHoleRenderer(8, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        r.render_frame(scene=T.SceneParams(screen_width=8, screen_height=8, debug_mode=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace_kernel.render_packed(
            T.Camera.default(), T.SceneParams(screen_width=8, screen_height=8, debug_mode=1),
            device="cpu")


@pytest.mark.parametrize(
    "config",
    [T.TraceConfig(integrator="rk4"), T.TraceConfig(integrator="leapfrog"),
     T.TraceConfig(model="kerr"), T.TraceConfig(model="kerr_lt"), T.TraceConfig(adaptive=True),
     T.TraceConfig(disk=True)],
    ids=["rk4", "leapfrog", "kerr", "kerr_lt", "adaptive", "disk"],
)
def test_trace_and_render_outside_slice_raise(config):
    scene = T.SceneParams(screen_width=4, screen_height=4, max_steps=2)
    origins, dirs = T.generate_rays(T.Camera.default(), 4, 4, scene.fov)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace.trace_rays(origins, dirs, torch.zeros(3), 2.0, 0.0, 2, config)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace_kernel.render_packed(T.Camera.default(), scene, config, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.render_image(T.Camera.default(), scene, config=config, fast_math=False,
                       device="cpu")


@pytest.mark.parametrize("kw", [dict(tonemap="srgb"), dict(skybox=object()),
                                dict(disk_params=object())], ids=["tonemap", "skybox", "disk"])
def test_render_image_outside_slice_raises(kw):
    scene = T.SceneParams(screen_width=4, screen_height=4, max_steps=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.render_image(T.Camera.default(), scene, config=T.TraceConfig(), fast_math=True,
                       device="cpu", **kw)


def test_fast_tier_trace_is_schwarzschild_only():
    origins, dirs = T.generate_rays(T.Camera.default(), 4, 4, T.SceneParams().fov)
    with pytest.raises(NotImplementedError, match="schwarzschild"):
        trace.trace_rays(origins, dirs, torch.zeros(3), 0.0, 0.0, 2,
                         T.TraceConfig(model="flat"), fast_math=True)


def test_build_is_keyed_by_source_hash():
    """The library name carries a hash of the sources and flags, so an edited
    kernel is rebuilt; nothing is built or loaded when the package imports."""
    h = build._source_hash(build.RENDER_MONO_SOURCES)
    assert len(h) == 16 and h == build._source_hash(build.RENDER_MONO_SOURCES)
    assert build.load_render_mono.cache_info().currsize == 0 or torch.cuda.is_available()
    assert {p.name for p in build.CSRC_DIR.glob("*.cu*")} >= {"render_mono.cu", "common.cuh"}
