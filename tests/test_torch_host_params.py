"""The frame's host inputs on the CPU: core/camera.orbit_camera on host
floats and the kernels' parameter block with its part other than the camera
computed once and reused (ops/trace_kernel._kernel_params), held bit for
bit against the tensor versions they replace in the frame path
(Camera.new, build_params), for each benchmark configuration's scene and
launch configuration over the orbit frames a run can start from, for a
band, a strided launch, the default camera and normalize's zero-length
guard; and the reuse counted, rebuilt for any change of what the block
reads, never launched stale."""

import types

import numpy as np
import pytest
import torch

import bhr_tpu_torch as bt
from bench_torch import harness
from bhr_tpu_torch.core.camera import Camera
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.ops.trace import TraceConfig
from bhr_tpu_torch.utils import build, tracing

F32 = torch.float32
N_FRAMES = 6001  # orbit frames 0-6000 at the cell's 60 fps
# a cell of each benchmark configuration: the scene and the launch's config
CELLS = {"sch1080": "sch1080.orbit_fast", "rk4disk1080": "rk4disk1080.orbit_exact",
         "kerr09disk4k": "kerr09disk4k.orbit_exact",
         "kerr09sky4k": "kerr09sky4k.orbit_neural_kerr", "pw4k": "pw4k.orbit_exact"}


def _bits(values) -> np.ndarray:
    return np.asarray(list(values), dtype=np.float32).view(np.uint32)


def _block(camera, scene, config, **band) -> np.ndarray:
    return _bits(trace_kernel._kernel_params(camera, scene, config, **band).v)


def _plain_block(camera, scene, config, **band) -> np.ndarray:
    return _bits(trace_kernel.build_params(camera, scene, config, **band).tolist())


def _tensor_cameras(times, radius, height, speed) -> Camera:
    """The orbit cameras of `times` the tensor way: each frame's angle and
    its cos and sin as 0-d fp32 tensors, then one Camera.new of them all
    (its + - * / and roots are exact fp32 operations in any batch)."""
    pos = []
    for t in times:
        angle = torch.as_tensor(t, dtype=F32) * torch.tensor(speed, dtype=F32)
        r = torch.tensor(radius, dtype=F32)
        pos.append(torch.stack([r * torch.cos(angle), torch.tensor(height, dtype=F32),
                                r * torch.sin(angle)]))
    pos = torch.stack(pos)
    return Camera.new(pos, torch.zeros(3, dtype=F32), [0.0, 1.0, 0.0])


def _assert_fields_equal(camera: Camera, want: Camera) -> None:
    for name in ("position", "forward", "right", "up"):
        got, ref = getattr(camera, name), getattr(want, name)
        assert got.dtype == F32 and tuple(got.shape) == (3,)
        assert np.array_equal(got.numpy().view(np.uint32), ref.numpy().view(np.uint32)), name


@pytest.fixture(scope="module")
def programs():
    """(animator, scene, launch config) of each configuration's cell, built
    on the CPU as the harness builds it."""
    out = {}
    for config, cell_name in CELLS.items():
        cell = harness.load_cell(cell_name)
        anim, _ = harness.build_program(cell, 7, "cpu")
        r = anim.renderer
        launch = TraceConfig() if r.config.integrator == "neural" else r.config
        out[config] = (anim, r.frame_scene(), launch, cell.config["camera"])
    return out


@pytest.mark.parametrize("config", sorted(CELLS))
def test_the_block_is_build_params_bit_for_bit(programs, config):
    """Frames 0-6000 of the cell's orbit, a band, a strided launch and the
    default camera: the launch's 32 floats are build_params' bits, and the
    orbit camera's fields are Camera.new's."""
    anim, scene, launch, path = programs[config]
    times = anim.frame_times(N_FRAMES, path["fps"])
    want = _tensor_cameras(times, path["radius"], path["height"], path["rotation_speed"])
    bad = []
    for k, t in enumerate(times):
        cam = anim.camera_fn(t)
        _assert_fields_equal(cam, Camera(want.position[k], want.forward[k], want.right[k],
                                         want.up[k]))
        if not np.array_equal(_block(cam, scene, launch), _plain_block(cam, scene, launch)):
            bad.append(k)
    assert bad == []
    cam = anim.camera_fn(times[123])
    for band in (dict(row0=270), dict(row0=2, col0=1, stride=3), dict(row0=0, col0=0)):
        assert np.array_equal(_block(cam, scene, launch, **band),
                              _plain_block(cam, scene, launch, **band)), band
    default = Camera.default()
    assert np.array_equal(_block(default, scene, launch), _plain_block(default, scene, launch))


@pytest.mark.parametrize("radius, height", [(0.0, 0.0), (0.0, 5.0), (0.0, -5.0), (1e-30, 0.0),
                                            (1e-20, 1e-20), (3e38, 0.0)])
def test_a_degenerate_orbit_keeps_the_zero_length_guard(radius, height):
    """A camera at the origin (forward zero), straight above it (right
    zero), one whose squared length underflows and one whose overflows
    (the tensor version's infinities): the tensor version's bits."""
    scene = bt.SceneParams(screen_width=64, screen_height=48)
    for t in (0.0, 1.25, torch.tensor(7.5)):
        cam = bt.orbit_camera(t, radius=radius, height=height)
        want = _tensor_cameras([t], radius, height, 0.3)
        _assert_fields_equal(cam, Camera(want.position[0], want.forward[0], want.right[0],
                                         want.up[0]))
        assert np.array_equal(_block(cam, scene, TraceConfig()),
                              _plain_block(cam, scene, TraceConfig()))


def _no_force(rel, vel, r, r2, rs, spin):
    return 0.0, 0.0, 0.0


def _custom(factor):
    return dict(model="custom", custom_accel=_no_force, custom_capture_factor=factor)


@pytest.fixture
def fresh_blocks(monkeypatch):
    """An empty store of constant blocks, and the counters' values before."""
    monkeypatch.setattr(trace_kernel, "_CONST_BLOCKS", {})
    return {k: tracing.COUNTS[k] for k in ("host.params.built", "host.params.reused")}


def _counted(before) -> tuple[int, int]:
    return tuple(tracing.COUNTS[k] - v for k, v in before.items())


@pytest.fixture
def launched(monkeypatch):
    """render_packed's CUDA path on the CPU, its launches' parameter blocks
    kept in order."""
    blocks = []

    def render_mono(params, *args):
        blocks.append(_bits(params.v))
        return 0

    lib = types.SimpleNamespace(bhr_render_mono=render_mono)
    monkeypatch.setattr(trace_kernel, "_kernel_device", lambda device, name: torch.device("cuda", 0))
    monkeypatch.setattr(trace_kernel, "_check_out", lambda *a: None)
    monkeypatch.setattr(build, "load_render_mono", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return blocks


@pytest.mark.parametrize("calls", [1, 12])
def test_a_scene_builds_its_block_once(fresh_blocks, launched, calls):
    """F frames of one scene, in one render_frames call or a call a frame
    as the benchmark issues them (a new plan each): the block is built once
    and reused F - 1 times, and every launch carries build_params' bits."""
    r = bt.BlackHoleRenderer(24, 16, fast_math=True, device="cpu")
    r.scene = bt.SceneParams(screen_width=24, screen_height=16, max_steps=8)
    anim = bt.OrbitAnimator(r)
    n, start = 12, 40
    if calls == 1:
        anim.render_frames(n, start_frame=start, packed=True)
    else:
        for k in range(n):
            anim.render_frames(1, start_frame=start + k, packed=True)
    assert _counted(fresh_blocks) == (1, n - 1)
    times = anim.frame_times(n, start_frame=start)
    assert len(launched) == n
    for block, t in zip(launched, times):
        assert np.array_equal(block, _plain_block(anim.camera_fn(t), r.scene, r.config))


# (scene, config, band) of a first launch, then of a second that differs in
# one thing the block reads
BASE = ({}, {}, {})
CHANGES = {
    "fov": (BASE, ({"fov": 1.0}, {}, {})),
    "spin": (BASE, ({"spin": 0.9}, {}, {})),
    "spin_negative_zero": (BASE, ({"spin": -0.0}, {}, {})),
    "schwarzschild_radius": (BASE, ({"schwarzschild_radius": 1.5}, {}, {})),
    "black_hole_position": (BASE, ({"black_hole_position": [0.0, 0.5, 0.0]}, {}, {})),
    "dt": (BASE, ({}, {"dt": 0.05}, {})),
    "escape_radius": (BASE, ({}, {"escape_radius": 50.0}, {})),
    "capture_factor": (({}, _custom(1.05), {}), ({}, _custom(1.10), {})),
    "model": (({"spin": 0.9}, {}, {}), ({"spin": 0.9}, {"model": "kerr"}, {})),
    "disk_radii": (BASE, ({}, {"disk_r_isco_factor": 2.0, "disk_r_outer_factor": 12.0}, {})),
    "width": (BASE, ({"screen_width": 32}, {}, {})),
    "height": (BASE, ({"screen_height": 20}, {}, {})),
    "band": (BASE, ({}, {}, {"row0": 8})),
    "strided": (BASE, ({}, {}, {"stride": 3, "col0": 1})),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_change_of_what_the_block_reads_rebuilds_it(fresh_blocks, change):
    """Launches alternating between two setups that differ in one value the
    block reads: each is built once, then reused, and every block is
    build_params' own, so no launch takes the other's."""
    setups = []
    for scene_kw, config_kw, band in CHANGES[change]:
        scene = bt.SceneParams(**{"screen_width": 24, "screen_height": 16, **scene_kw})
        setups.append((scene, TraceConfig(**config_kw), band))
    cam = bt.orbit_camera(torch.tensor(2.5))
    blocks = []
    for scene, config, band in setups * 2:
        block = _block(cam, scene, config, **band)
        assert np.array_equal(block, _plain_block(cam, scene, config, **band))
        blocks.append(block)
    assert not np.array_equal(blocks[0], blocks[1])
    assert _counted(fresh_blocks) == (2, 2)
