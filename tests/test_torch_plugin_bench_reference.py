"""The benchmark's plain reference of plugin physics
(bench_torch/reference/plugin.py), its cell pw4k.orbit_exact (the
Paczynski-Wiita plugin at 4K, exact tier) and the exact main-loop cell
sch1080.orbit_exact, on the CPU; with the program's span and counter of a
plugin (setup.plugin, COUNTS["plugin.records"]).

The reference is held bit for bit against the port's plain frame (the
program's CPU path, through the harness's own entry) for the
configuration's plugin and for a second plugin written here, a
velocity-dependent drag; each cell is resolved from its files by name; the
plugin's copy is pinned by its digest; plugin.roofline_pct is read from a
synthetic record; and a run of each cell by the harness's run_cell, shrunk
as bench_torch/tests/test_correct.py shrinks cells, is correct, and not
correct with the control or any planted fault of calibrate.py in the
program's place."""

import hashlib
import time
import types

import pytest
import torch

import bhr_tpu_torch as bt
from bench_torch import harness
from bench_torch.calibrate import faults
from bench_torch.reference import plugin as plugin_ref
from bench_torch.reference import schwarzschild
from bench_torch.reference.common import orbit_camera
from bhr_tpu_torch.ops import trace_kernel
from bhr_tpu_torch.utils import build, plugin, tracing

PLUGIN_CELL = "pw4k.orbit_exact"
# each cell: its plain reference, its scene (width, height, max_steps) and
# the per-layer metrics it reports
CELLS = {
    "pw4k.orbit_exact": (plugin_ref, (3840, 2160, 500),
                         {"host.issue_ms", "epilogue.device_ms", "epilogue.launches",
                          "device.idle_pct", "plugin.roofline_pct"}),
    "sch1080.orbit_exact": (schwarzschild, (1920, 1080, 500),
                            {"host.issue_ms", "geodesic.roofline_pct", "device.idle_pct"}),
}
SEED = 2**31 + 101  # larger than 32 signed bits hold
PW_SHA256 = "2d9ebb7096af14f13629c80f87702f234cb0e8446dc26133f08be2eafe302621"
DRAG = """\
def acceleration(rel, vel, r, r2, rs, spin):
    f = -0.5 * rs / (r2 * r)
    k = 0.05 * rs / r2
    return (rel[0] * f - vel[0] * k, rel[1] * f - vel[1] * k, rel[2] * f - vel[2] / 3.0 * k)


CAPTURE_FACTOR = 1.2
"""


@pytest.fixture(autouse=True)
def at_the_root(monkeypatch):
    """The benchmark runs from the checkout's root, where the configuration's
    plugin path is resolved."""
    monkeypatch.chdir(harness.REPO)


def small(name, width=40, height=24, max_steps=100):
    cell = harness.load_cell(name)
    cell.config["scene"].update(width=width, height=height, max_steps=max_steps)
    cell.traffic.update(sample_within=2, compare_frames=1, warmup_frames=1)
    return cell


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cell_resolves_from_its_files(name):
    ref, (width, height, max_steps), per_layer = CELLS[name]
    cell = harness.load_cell(name)
    assert cell.chips == 1 and harness.reference_module(cell) is ref
    sc = cell.config["scene"]
    assert (sc["width"], sc["height"], sc["max_steps"]) == (width, height, max_steps)
    assert cell.config["reduced"] == [] and cell.traffic["renderer"] == {"fast_math": False}
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == per_layer
    assert set(cell.limits["numbers"]) == {"neq_pct"}
    spec = cell.limits["numbers"]["neq_pct"]
    assert spec["lower"] < spec["limit"] < min(spec["upper"], spec["faults_min"])
    if name == PLUGIN_CELL:
        assert cell.config["renderer"] == {
            "integrator": "euler", "model": "custom",
            "custom_physics": "bench_torch/assets/paczynski_wiita.py", "adaptive": False,
            "disk": False, "dt": 0.1}
        assert cell.config["trace"]["capture_factor"] == 1.10 and sc["spin"] == 0.0
    else:
        assert cell.config["renderer"]["model"] == "schwarzschild"
        assert cell.counts["ops_per_step"]["counts"]["schwarzschild.euler"] == 50


def _held(cell, frames=(0, 1)):
    """The port's plain frames of the cell's seeded orbit frames against the
    reference's, with the reference's steps."""
    s = harness.seeded(cell, SEED)
    anim, render = harness.build_program(cell, s["star_seed"], "cpu")
    ref = harness.reference_module(cell)
    out = []
    for j in frames:
        k = s["phase"] + j
        want, steps = ref.render(cell, orbit_camera(k, cell.config["camera"]),
                                 seed=s["star_seed"], device="cpu")
        out.append((harness.numbers(render(k), want), want, steps))
    return anim.renderer, out


@pytest.mark.parametrize("max_steps", [100, 160], ids=["steps100", "steps160"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_reference_equals_the_ports_plain_frame(name, max_steps):
    """Two seeded frames, bit for bit; at 160 steps rays reach the capture
    sphere from the orbit (r about 15.8) and are captured."""
    cell = small(name, max_steps=max_steps)
    r, held = _held(cell)
    assert r.config.model == ("custom" if name == PLUGIN_CELL else "schwarzschild")
    assert not r.fast_math
    for numbers, want, steps in held:
        assert numbers == {"neq_pct": 0.0, "off1_pct": 0.0}
        assert want.shape == steps.shape == (24, 40) and want.dtype == torch.int32
        assert int(steps.max()) == max_steps
        assert (int(steps.min()) < max_steps) == (max_steps == 160)


def _drag_cell(tmp_path):
    path = tmp_path / "drag.py"
    path.write_text(DRAG)
    cell = small(PLUGIN_CELL, max_steps=160)
    cell.config["renderer"]["custom_physics"] = str(path)
    cell.config["plugin_sha256"] = hashlib.sha256(path.read_bytes()).hexdigest()
    return cell


def test_the_reference_is_generic_in_the_plugin(tmp_path):
    """A second plugin, a central force with a velocity-dependent drag (one
    component divided by a Python number) and its own capture factor,
    equals the port's plain frame bit for bit too, and differs from the
    Paczynski-Wiita frame."""
    cell = _drag_cell(tmp_path)
    r, held = _held(cell)
    assert r.config.custom_capture_factor == pytest.approx(1.2)
    _, pw = _held(small(PLUGIN_CELL, max_steps=160))
    for (numbers, want, _), (_, pw_want, _) in zip(held, pw):
        assert numbers == {"neq_pct": 0.0, "off1_pct": 0.0}
        assert harness.numbers(want, pw_want)["neq_pct"] > 10.0


def test_the_plugin_copy_is_pinned(tmp_path):
    cell = harness.load_cell(PLUGIN_CELL)
    copy = harness.REPO / cell.config["renderer"]["custom_physics"]
    data = copy.read_bytes()
    assert data == (harness.REPO / "examples" / "plugins" / "paczynski_wiita.py").read_bytes()
    assert hashlib.sha256(data).hexdigest() == cell.config["plugin_sha256"] == PW_SHA256
    assert plugin_ref.load(cell).CAPTURE_FACTOR == cell.config["trace"]["capture_factor"]
    other = tmp_path / "paczynski_wiita.py"
    other.write_bytes(data[:-2] + b"5\n")  # CAPTURE_FACTOR 1.15
    cell.config["renderer"]["custom_physics"] = str(other)
    with pytest.raises(ValueError, match="sha256"):
        plugin_ref.load(cell)


def test_plugin_roofline_from_its_own_count():
    counts = harness.load_cell(PLUGIN_CELL).counts
    config = harness.load_cell(PLUGIN_CELL).config
    ray_steps, px = 3_900_000_000, 3840 * 2160
    kernels = [("void bhr::trace_planes_kernel<false, 0, false, 0>(float const*)", 0.0, 0.0108),
               ("shade_planes_kernel", 0.0108, 0.0110)] * 2
    rec = types.SimpleNamespace(kernels=kernels, frames=2, ray_steps=ray_steps, pixels=px,
                                config=config, counts=counts)
    read = harness.metric_reader("plugin.roofline_pct")
    least = max(ray_steps * 34 / 67e12, px * 32 / 3.35e12)
    assert read(rec) == pytest.approx(100 * least / 0.0108)
    assert read(types.SimpleNamespace(**dict(vars(rec), ray_steps=None))) is None
    sch = harness.load_cell("sch1080.orbit_exact").config
    assert read(types.SimpleNamespace(**dict(vars(rec), config=sch))) is None


@pytest.fixture
def fake_cuda(monkeypatch):
    """trace_image's CUDA path on the CPU: a CUDA device by name, unchecked
    CPU outputs, and a plugin library whose launches succeed and do
    nothing."""
    lib = types.SimpleNamespace(bhr_trace_planes=lambda *a: 0)
    monkeypatch.setattr(trace_kernel, "_kernel_device", lambda device, name: torch.device("cuda"))
    monkeypatch.setattr(trace_kernel, "_check_out", lambda *a: None)
    monkeypatch.setattr(build, "load_trace_planes_custom", lambda *a: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def test_a_plugin_is_recorded_once_a_process(fake_cuda):
    """Two renderers of one plugin file (built for a CUDA device, which
    records the plugin) and several frames' launches record it once."""
    for cache in (plugin._load_module, plugin.program, plugin.cuda_source):
        cache.cache_clear()
    before = dict(tracing.COUNTS)
    path = harness.load_cell(PLUGIN_CELL).config["renderer"]["custom_physics"]
    renderers = [bt.BlackHoleRenderer(40, 24, custom_physics=path, device="cuda")
                 for _ in range(2)]
    assert renderers[0].config.custom_accel is renderers[1].config.custom_accel
    scene = bt.SceneParams(screen_width=40, screen_height=24, max_steps=100)
    planes = trace_kernel.empty_trace_result(24, 40, "cpu")
    for r in renderers:
        for t in range(3):
            trace_kernel.trace_image(bt.orbit_camera(torch.tensor(t / 60.0)), scene, r.config,
                                     device="cuda", out=planes)

    def delta(key):
        return tracing.COUNTS[key] - before.get(key, 0)

    assert delta("plugin.records") == 1
    assert delta("launch.trace_planes.custom") == delta("launch.trace_planes") == 6


def test_setup_plugin_is_a_span_of_the_construction_alone():
    path = harness.load_cell(PLUGIN_CELL).config["renderer"]["custom_physics"]
    tracing.drain()
    with tracing.recording():
        r = bt.BlackHoleRenderer(40, 24, custom_physics=path, device="cpu")
    built = tracing.drain()
    assert [s.name for s in built].count("setup.plugin") == 1
    (span,) = [s for s in built if s.name == "setup.plugin"]
    assert span.parent is None and span.frame is None and span.end_ns >= span.start_ns
    r.scene = bt.SceneParams(screen_width=40, screen_height=24, max_steps=30)
    with tracing.recording():
        frames = bt.OrbitAnimator(r).render_frames(3, packed=True)
    spans = tracing.drain()
    assert frames.shape == (3, 24, 40)
    assert "host.frames" in {s.name for s in spans}
    assert not [s for s in spans if s.name.startswith("setup.")]


def run(cell, wrap=None, seconds=0.1):
    """A run of `seconds`: one frame is enough for any fault but the stale
    one, which needs a second frame in the window (`run_stale`)."""
    return harness.run_cell(cell, SEED, seconds, False, t_start=time.perf_counter(),
                            device="cpu", wrap=wrap)


def run_stale(cell, tries=6):
    """A stale run whose window holds at least two frames: its window is
    doubled from 0.8 s until it does, within `tries` runs, so that a loaded
    CPU cannot leave the window a single (correct) frame."""
    seconds = 0.8
    for _ in range(tries):
        out = run(cell, _stale(), seconds)
        if out["attempted"] >= 2:
            return out
        seconds *= 2
    raise AssertionError(f"{tries} stale windows up to {seconds / 2} s held one frame each")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct(name):
    out = run(small(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert out["checks"]["neq_pct"]["value"] == 0.0
    assert all(isinstance(x, int) and x > 0 for x in out["ray_steps"])


def _control(cell):
    s = harness.seeded(cell, SEED)
    ref = harness.reference_module(cell)

    def wrap(render, k):
        render(k)  # the program still runs; its frame is replaced
        low, _ = ref.render(cell, orbit_camera(k, cell.config["camera"]), seed=s["star_seed"],
                            device="cpu", control=True)
        return low[None]
    return wrap


def _stale():
    first = []

    def wrap(render, k):
        first.append(k)
        return render(first[0])
    return wrap


def _planted(kind):
    def wrap(render, k):
        frame = render(k)
        return faults(frame[0], frame[0])[kind][None]
    return wrap


@pytest.mark.parametrize("broken", ["control", "stale", "half_rows", "band_altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_run_is_not_correct(name, broken):
    cell = small(name)
    if broken == "stale":
        out = run_stale(cell)
        assert out["attempted"] >= 2
    else:
        wrap = _control(cell) if broken == "control" else _planted(broken)
        out = run(cell, wrap)
    assert not out["correct"], out["checks"]
    if broken == "control":
        assert out["checks"]["neq_pct"]["value"] > 1.0
