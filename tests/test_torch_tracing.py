"""The program's spans and counters (bhr_tpu_torch/utils/tracing.py) and the
tool that reads them against a CUDA trace (tools/frame_spans.py), on the
CPU: spans nest and carry their frame, recording off records nothing and
changes no frame, the collector's pauses are spans only while recording,
and each launch key counts what its kernel's wrapper launches."""

import gc
import subprocess
import sys
import types

import pytest
import torch

import bhr_tpu_torch as T
from bhr_tpu_torch.models import neural as tn
from bhr_tpu_torch.models import neural_kerr as tnk
from bhr_tpu_torch.ops import neural_kernel, shade_kernel, trace_kernel
from bhr_tpu_torch.tools import frame_spans as fs
from bhr_tpu_torch.utils import build, tracing
from bhr_tpu_torch.utils.tracing import COUNTS, Span

ROUTES = {
    "monolithic": (dict(fast_math=True), "kernel.render_mono"),
    "staged": (dict(integrator="rk4", adaptive=True, disk=True), "kernel.trace_planes"),
    "neural": (dict(integrator="neural"), "kernel.neural_mlp"),
}


def _animator(route):
    kw, _ = ROUTES[route]
    r = T.BlackHoleRenderer(24, 16, device="cpu", **kw)
    r.scene = T.SceneParams(screen_width=24, screen_height=16, max_steps=30)
    return T.OrbitAnimator(r)


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_spans_nest_under_their_parents():
    tracing.drain()
    with tracing.recording():
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d"):
                pass
        with tracing.span("e"):
            pass
    spans = tracing.drain()
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert _inside(s, spans[s.parent])
    own = tracing.self_ns(spans)
    a, b, c, d, _ = spans
    dur = [s.end_ns - s.start_ns for s in spans]
    assert own[0] == dur[0] - dur[1] - dur[3] and own[1] == dur[1] - dur[2]
    assert own[2] == dur[2] and sum(own[:4]) == dur[0]


def test_self_time_takes_the_union_of_the_children():
    spans = [Span("p", 0, 100, None, None), Span("x", 10, 40, 0, None),
             Span("y", 30, 60, 0, None), Span("z", 90, 120, 0, None)]
    assert tracing.self_ns(spans) == [100 - 50 - 10, 30, 30, 30]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_frames_records_a_camera_span_a_frame(route):
    anim = _animator(route)
    off = anim.render_frames(3, start_frame=7, packed=True)
    tracing.drain()
    with tracing.recording():
        on = anim.render_frames(3, start_frame=7, packed=True)
    spans = tracing.drain()
    assert torch.equal(on, off)
    names = [s.name for s in spans]
    assert names.count("host.frames") == 1 and spans[0].name == "host.frames"
    top = spans[0]
    assert all(_inside(s, top) for s in spans)
    for s in spans[1:]:
        assert s.parent is not None and _inside(s, spans[s.parent])
    cams = [s.frame for s in spans if s.name == "host.camera" and s.frame is not None]
    assert cams == [7, 8, 9]
    kernel = ROUTES[route][1]
    assert [s.frame for s in spans if s.name == kernel] == [7, 8, 9]
    if route == "staged":
        assert [s.frame for s in spans if s.name == "epilogue.background"] == [7, 8, 9]
        assert all(spans[s.parent].name == "epilogue" for s in spans
                   if s.name == "epilogue.background")
    assert top.frame is None


def test_recording_off_records_nothing():
    anim = _animator("monolithic")
    tracing.drain()
    anim.render_frames(2, packed=True)
    with tracing.span("x"):
        pass
    assert tracing.drain() == []
    assert tracing.span("x") is tracing.span("y")  # the shared null context


def test_gc_spans_only_while_recording():
    tracing.drain()
    with tracing.recording():
        assert tracing._gc_callback in gc.callbacks
        with tracing.span("outer"):
            gc.collect()
    spans = tracing.drain()
    collections = [s for s in spans if s.name == "gc"]
    assert collections and all(spans[s.parent].name == "outer" for s in collections)
    assert tracing._gc_callback not in gc.callbacks
    gc.collect()
    assert tracing.drain() == []


def test_the_import_is_a_setup_span():
    code = ("import bhr_tpu_torch\n"
            "from bhr_tpu_torch.utils import tracing\n"
            "print([s.name for s in tracing.drain()])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "['setup.import']", out.stdout + out.stderr


# ---- the launch counts: each wrapper's CUDA path, its kernel and device faked ----

KEYS = ("launch.render_mono", "launch.render_mono.ks", "launch.render_mono.ks.fast",
        "launch.trace_planes", "launch.trace_planes.strided", "launch.trace_planes.masked",
        "launch.trace_planes.custom", "launch.trace_planes.ks", "launch.trace_planes.ks.fast",
        "launch.trace_planes.fixed", "launch.neural_mlp",
        "launch.neural_mlp.dirs", "launch.neural_mlp.band", "launch.neural_mlp.kerr",
        "launch.neural_mlp.streamed", "launch.shade_planes")
KERR = T.TraceConfig(model="kerr", disk=True)
DISK4 = dict(integrator="rk4", adaptive=True, disk=True)  # BASELINE config 4
# trace_planes launches by (configuration, fast_math, multires pass): config
# 4's exact rk4 runs the instantiation with its flags fixed at adaptive |
# disk, and config 5's exact Euler the one fixed at Kerr-Schild | disk,
# whole or in either pass; each neighbour of them reads its flags
PLANES = {
    "config4_exact": (DISK4, False, None),
    "config4_exact.strided": (DISK4, False, "strided"),
    "config4_exact.masked": (DISK4, False, "masked"),
    "config4_exact.custom": (dict(DISK4, model="custom", custom_accel=None), False, None),
    "config4_fast": (DISK4, True, None),
    "leapfrog_disk_exact": (dict(DISK4, integrator="leapfrog"), False, None),
    "rk4_kerr_lt_exact": (dict(DISK4, model="kerr_lt"), False, None),
    "rk4_flat_exact": (dict(DISK4, model="flat"), False, None),
    "config4_exact.ks": (dict(DISK4, model="kerr"), False, None),
    "rk4_adaptive_exact": (dict(integrator="rk4", adaptive=True), False, None),
    "euler_fast": ({}, True, None),
    "config5_exact.ks": (dict(model="kerr", disk=True), False, None),
    "config5_exact.ks.strided": (dict(model="kerr", disk=True), False, "strided"),
    "config5_exact.ks.masked": (dict(model="kerr", disk=True), False, "masked"),
    "euler_exact.ks": (dict(model="kerr"), False, None),
}


def _no_force(rel, vel, r, r2, rs, spin):
    return (0.0, 0.0, 0.0)


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA path on the CPU: a CUDA device by name, unchecked
    CPU outputs, and libraries whose launches succeed and do nothing."""
    lib = types.SimpleNamespace(bhr_render_mono=lambda *a: 0, bhr_trace_planes=lambda *a: 0,
                                bhr_set_disk_lut=lambda *a: 0, bhr_shade_planes=lambda *a: 0)
    cuda = torch.device("cuda", 0)
    for mod in (trace_kernel, neural_kernel):
        monkeypatch.setattr(mod, "_kernel_device", lambda device, name: cuda)
        monkeypatch.setattr(mod, "_check_out", lambda *a: None)
    monkeypatch.setattr(trace_kernel, "_check_mask", lambda *a: None)
    monkeypatch.setattr(shade_kernel, "_kernel_device", lambda device, name: cuda)
    monkeypatch.setattr(shade_kernel, "_check_planes", lambda result, *a: (6, 8, cuda))
    monkeypatch.setattr(trace_kernel, "cuda_source", lambda accel: "")
    monkeypatch.setattr(neural_kernel, "_launch", lambda *a: None)
    for name in ("load_render_mono", "load_trace_planes", "load_trace_planes_custom",
                 "load_shade_planes"):
        monkeypatch.setattr(build, name, lambda *a: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _random_kerr_net(width):
    """A seeded Kerr-shaped net (22 -> width -> width -> 3)."""
    g = torch.Generator().manual_seed(width)
    dims = (22, width, width, 3)
    return tn.NeuralSurrogate([(0.1 * torch.randn(i, o, generator=g), torch.zeros(o))
                               for i, o in zip(dims[:-1], dims[1:])])


# nets by their model and layout (neural_kernel.kernel_plan)
NETS = {
    "kerr": lambda: tnk.load_params(tn.ASSETS_DIR / "neural_kerr.npz")[0],  # 256 wide, streamed
    "kerr128": lambda: _random_kerr_net(128),  # held
    "orbit": lambda: tn.load_params(tn.ASSETS_DIR / "neural_schwarzschild_orbit.npz")[0],  # held
    "orbit_xl": lambda: tn.load_params(tn.ASSETS_DIR / "neural_schwarzschild_orbit_xl.npz")[0],
}


def _launch(what):
    scene = T.SceneParams(screen_width=8, screen_height=6, max_steps=4)
    cam = T.Camera.default()
    planes = trace_kernel.empty_trace_result(6, 8, "cpu")
    frame = torch.empty((6, 8), dtype=torch.int32)
    net = tn.NeuralSurrogate(tn.load_params(tn.ASSETS_DIR / "neural_schwarzschild.npz")[0])
    if what.startswith(("neural_mlp.", "band.", "dirs.")):  # another net than N1
        what, key = what.split(".", 1)
        net = NETS[key]()
        scene = scene.replace(spin=0.9)
    calls = {
        "render_mono": lambda: trace_kernel.render_packed(cam, scene, device="cuda", out=frame),
        "render_mono.ks": lambda: trace_kernel.render_packed(cam, scene, KERR, device="cuda",
                                                             out=frame),
        "render_mono.ks.exact": lambda: trace_kernel.render_packed(
            cam, scene, T.TraceConfig(model="kerr"), fast_math=False, device="cuda", out=frame),
        "trace_planes": lambda: trace_kernel.trace_image(cam, scene, device="cuda", out=planes),
        "trace_planes.ks": lambda: trace_kernel.trace_image(cam, scene, KERR, device="cuda",
                                                            out=planes),
        "trace_planes.ks.fast": lambda: trace_kernel.trace_image(
            cam, scene, KERR, fast_math=True, device="cuda", out=planes),
        "strided": lambda: trace_kernel.trace_image(cam, scene, device="cuda", stride=2,
                                                    local_shape=(3, 4), out=planes),
        "masked": lambda: trace_kernel.trace_image(cam, scene, device="cuda", out=planes,
                                                   mask=torch.ones((6, 8))),
        "custom": lambda: trace_kernel.trace_image(
            cam, scene, T.TraceConfig(model="custom", custom_accel=_no_force,
                                      custom_capture_factor=1.05), device="cuda", out=planes),
        "neural_mlp": lambda: neural_kernel.neural_render_packed(net, cam, scene, device="cuda",
                                                                 out=frame),
        "band": lambda: neural_kernel.neural_render_packed(
            net, cam, scene, device="cuda", row0=2, local_shape=(2, 8), out=frame[:2]),
        "dirs": lambda: neural_kernel.neural_trace_dirs(net, cam, scene, device="cuda",
                                                        out=planes),
        "shade_planes": lambda: shade_kernel.shade_planes(planes, cam, scene, out=frame),
    }
    if what in PLANES:
        kw, fast, multires = PLANES[what]
        if kw.get("model") == "custom":
            kw = dict(kw, custom_accel=_no_force, custom_capture_factor=1.05)
        extra = (dict(stride=2, local_shape=(3, 4)) if multires == "strided" else
                 dict(mask=torch.ones((6, 8))) if multires == "masked" else {})
        trace_kernel.trace_image(cam, scene, T.TraceConfig(**kw), fast_math=fast,
                                 device="cuda", out=planes, **extra)
        return
    calls[what]()


@pytest.mark.parametrize("what, counted, kernel", [
    ("render_mono", {"launch.render_mono"}, "kernel.render_mono"),
    ("render_mono.ks", {"launch.render_mono", "launch.render_mono.ks",
                        "launch.render_mono.ks.fast"}, "kernel.render_mono"),
    ("render_mono.ks.exact", {"launch.render_mono", "launch.render_mono.ks"},
     "kernel.render_mono"),
    ("trace_planes", {"launch.trace_planes", "launch.trace_planes.fixed"},
     "kernel.trace_planes"),
    ("trace_planes.ks", {"launch.trace_planes", "launch.trace_planes.ks",
                         "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("trace_planes.ks.fast", {"launch.trace_planes", "launch.trace_planes.ks",
                              "launch.trace_planes.ks.fast"}, "kernel.trace_planes"),
    ("strided", {"launch.trace_planes", "launch.trace_planes.strided",
                 "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("masked", {"launch.trace_planes", "launch.trace_planes.masked",
                "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("custom", {"launch.trace_planes", "launch.trace_planes.custom",
                "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("config4_exact", {"launch.trace_planes", "launch.trace_planes.fixed"},
     "kernel.trace_planes"),
    ("config4_exact.strided", {"launch.trace_planes", "launch.trace_planes.strided",
                               "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("config4_exact.masked", {"launch.trace_planes", "launch.trace_planes.masked",
                              "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("config4_exact.custom", {"launch.trace_planes", "launch.trace_planes.custom",
                              "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("config4_fast", {"launch.trace_planes"}, "kernel.trace_planes"),
    ("leapfrog_disk_exact", {"launch.trace_planes"}, "kernel.trace_planes"),
    ("rk4_kerr_lt_exact", {"launch.trace_planes"}, "kernel.trace_planes"),
    ("rk4_flat_exact", {"launch.trace_planes"}, "kernel.trace_planes"),
    ("config4_exact.ks", {"launch.trace_planes", "launch.trace_planes.ks"}, "kernel.trace_planes"),
    ("rk4_adaptive_exact", {"launch.trace_planes"}, "kernel.trace_planes"),
    ("euler_fast", {"launch.trace_planes", "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    # config 5's exact frame (Euler, Kerr-Schild, the disk), whole and in either
    # pass, and the exact Kerr-Schild Euler trace without the disk
    ("config5_exact.ks", {"launch.trace_planes", "launch.trace_planes.ks",
                          "launch.trace_planes.fixed"}, "kernel.trace_planes"),
    ("config5_exact.ks.strided", {"launch.trace_planes", "launch.trace_planes.ks",
                                  "launch.trace_planes.strided", "launch.trace_planes.fixed"},
     "kernel.trace_planes"),
    ("config5_exact.ks.masked", {"launch.trace_planes", "launch.trace_planes.ks",
                                 "launch.trace_planes.masked", "launch.trace_planes.fixed"},
     "kernel.trace_planes"),
    ("euler_exact.ks", {"launch.trace_planes", "launch.trace_planes.ks"}, "kernel.trace_planes"),
    ("neural_mlp", {"launch.neural_mlp"}, "kernel.neural_mlp"),
    ("band", {"launch.neural_mlp", "launch.neural_mlp.band"}, "kernel.neural_mlp"),
    ("dirs", {"launch.neural_mlp.dirs"}, "kernel.neural_mlp"),
    # the Kerr net (N2) and the fused layout with its weights streamed, by net
    ("neural_mlp.kerr", {"launch.neural_mlp", "launch.neural_mlp.kerr",
                         "launch.neural_mlp.streamed"}, "kernel.neural_mlp"),
    ("band.kerr", {"launch.neural_mlp", "launch.neural_mlp.band", "launch.neural_mlp.kerr",
                   "launch.neural_mlp.streamed"}, "kernel.neural_mlp"),
    ("dirs.kerr", {"launch.neural_mlp.dirs", "launch.neural_mlp.kerr",
                   "launch.neural_mlp.streamed"}, "kernel.neural_mlp"),
    ("neural_mlp.kerr128", {"launch.neural_mlp", "launch.neural_mlp.kerr"}, "kernel.neural_mlp"),
    ("neural_mlp.orbit", {"launch.neural_mlp"}, "kernel.neural_mlp"),
    ("neural_mlp.orbit_xl", {"launch.neural_mlp", "launch.neural_mlp.streamed"},
     "kernel.neural_mlp"),
    ("shade_planes", {"launch.shade_planes"}, "kernel.shade_planes"),
])
def test_each_launch_counts_once_under_its_keys(fake_cuda, monkeypatch, what, counted, kernel):
    monkeypatch.setattr(trace_kernel, "_CONST_BLOCKS", {})  # the block is built in this launch
    before = {k: COUNTS[k] for k in KEYS}
    tracing.drain()
    with tracing.recording():
        _launch(what)
    spans = tracing.drain()
    assert {k: COUNTS[k] - before[k] for k in KEYS} == {k: int(k in counted) for k in KEYS}
    assert [s.name for s in spans if s.name.startswith("kernel.")] == [kernel]
    if kernel in ("kernel.render_mono", "kernel.trace_planes"):  # the neural launch is faked
        params = [s for s in spans if s.name == "host.params"]
        assert len(params) == 1 and spans[params[0].parent].name == kernel
        ks = [s for s in spans if s.name == "host.params.ks"]  # the Kerr capture radius, built
        assert len(ks) == (".ks" in what)
        assert all(spans[s.parent].name == "host.params" for s in ks)


def test_every_launch_key_is_registered_in_the_recorder():
    """Each key a wrapper counts, the Kerr-Schild ones among them, is named
    in utils/tracing's list of counters."""
    listed = {line.split()[0] for line in tracing.__doc__.splitlines()
              if line.startswith("  launch.")}
    assert set(KEYS) <= listed
    assert {"launch.render_mono.ks", "launch.trace_planes.ks", "launch.render_mono.ks.fast",
            "launch.trace_planes.ks.fast"} <= listed


def test_the_cpu_path_launches_nothing():
    before = {k: COUNTS[k] for k in KEYS}
    for route in sorted(ROUTES):
        _animator(route).render_frames(1, packed=True)
    assert {k: COUNTS[k] for k in KEYS} == before
    assert not [k for k in COUNTS if k.startswith("launch.") and k not in KEYS
                and not k.startswith("launch.probe_")]


# ---- the tool's readings, on synthetic spans and trace events ---------------


def _frame(t0, extra=0):
    """One exact frame's spans from t0 (ns): host.frames > camera, launch >
    params, epilogue > background; `extra` ns more in the background."""
    return [Span("host.frames", t0, t0 + 1000 + extra, None, 0),
            Span("host.camera", t0 + 10, t0 + 110, 0, 0),
            Span("kernel.trace_planes", t0 + 120, t0 + 320, 0, 0),
            Span("host.params", t0 + 130, t0 + 180, 2, 0),
            Span("epilogue", t0 + 330, t0 + 990 + extra, 0, 0),
            Span("epilogue.background", t0 + 400, t0 + 800 + extra, 4, 0)]


def _frames(n, stall_at=None, extra=0):
    spans = []
    for i in range(n):
        part = _frame(10_000 * i, extra if i == stall_at else 0)
        off = len(spans)
        spans += [s._replace(parent=None if s.parent is None else s.parent + off, frame=i)
                  for s in part]
    issue = [("bench.issue", 10_000 * i - 5, 10_000 * i + 1000 + (extra if i == stall_at else 0)
              + 5) for i in range(n)]
    return spans, issue


def test_stage_self_times_a_frame():
    spans, _ = _frames(4)
    ms = fs.stage_ms(spans, 4)
    assert ms["camera"] == pytest.approx(100e-6) and ms["params"] == pytest.approx(50e-6)
    assert ms["launch"] == pytest.approx(150e-6)
    assert ms["epilogue"] == pytest.approx(660e-6)
    assert ms["frames"] == pytest.approx((1000 - 100 - 200 - 660) * 1e-6)
    assert fs.stage_ms([], 1) == {}


def test_setup_program_s_sums_the_outermost_setup_spans():
    spans = [Span("setup.import", 0, 100, None, None),
             Span("setup.load", 200, 500, None, None),
             Span("setup.build", 210, 400, 1, None),
             Span("host.params", 600, 900, None, None),
             Span("setup.neural_prepare", 650, 850, 3, None)]
    assert fs.setup_program_s(spans) == pytest.approx((100 + 300 + 200) * 1e-9)


def test_coverage_of_the_issue():
    spans, issue = _frames(3)
    cov = fs.coverage(spans, issue)
    assert cov["frames_over_issue"] == pytest.approx(3000 / 3030)
    assert cov["frames_self_share"] == pytest.approx(40 / 1000)


def test_device_time_of_the_ops_launched_inside_a_span():
    spans, _ = _frames(2)
    where = fs.Innermost(spans)
    host = [("cudaLaunchKernel", 500, 510, 1), ("cudaLaunchKernel", 900, 905, 2),
            ("cudaLaunchKernel", 10_450, 10_460, 3), ("cudaLaunchKernel", 20_000, 20_001, 4)]
    device = [("k1", 2000, 2300, 1), ("k2", 2300, 2400, 2), ("k3", 12_000, 12_500, 3),
              ("k4", 30_000, 30_100, 4)]
    assert fs.launched_by(host, where) == {1: "epilogue.background", 2: "epilogue",
                                           3: "epilogue.background"}
    assert fs.device_ms_in("epilogue.background", device, host, where, 2) == pytest.approx(
        (300 + 500) * 1e-6 / 2)
    assert fs.device_ms_in("gc", device, host, where, 2) is None
    clk = fs.clock(host, where)
    assert clk["launch_calls"] == 4 and clk["inside_share"] == pytest.approx(0.75)
    assert clk["largest_offset_us"] == pytest.approx(1.0e-3 * (20_000 - 11_000))


def test_the_background_and_the_shading_kernel_read_their_own_spans():
    spans, _ = _frames(2)

    def renamed(name):
        return [s._replace(name=name) if s.name == "epilogue.background" else s for s in spans]

    host = [("cudaLaunchKernel", 500, 510, 1), ("cudaLaunchKernel", 10_450, 10_460, 2)]
    device = [("shade_planes_kernel", 2000, 2100, 1), ("shade_planes_kernel", 12_000, 12_300, 2)]
    ms = pytest.approx((100 + 300) * 1e-6 / 2)
    keys = ("background_device_ms", "shade_kernel_device_ms")
    for sp, want in ((spans, (ms, None)), (renamed("kernel.shade_planes"), (None, ms)),
                     (renamed("other"), (None, None))):
        got = fs.epilogue_device_ms(device, host, fs.Innermost(sp), 2)
        assert tuple(got[k] for k in keys) == want


def test_idle_gaps_name_the_innermost_program_span():
    spans, issue = _frames(1)
    bench = fs.Innermost([Span(*i, None, None) for i in issue])
    calls = fs.Innermost([Span("cudaLaunchKernel", 500, 510, None, None)])
    where = fs.Innermost(spans)
    ops = [("k", 0.0, 502e-9), ("k", 505e-9, 850e-9), ("k", 2000e-9, 3000e-9)]
    gaps = fs.idle_gaps(ops, 4000e-9, lambda t: fs.doing(round(t * 1e9), bench, where, calls))
    assert gaps == [["bench.issue > epilogue", pytest.approx(1150e-9)],
                    ["host idle", pytest.approx(1000e-9)],
                    ["bench.issue > epilogue.background > cudaLaunchKernel",
                     pytest.approx(3e-9)]]
    # without a program span, the harness's label is what it was
    assert fs.doing(2500, bench, fs.Innermost([]), fs.Innermost([])) == "host idle"
    assert fs.doing(200, bench, fs.Innermost([]), fs.Innermost([])) == "bench.issue"


def test_a_stall_is_named_by_the_label_that_took_the_extra_time():
    spans, issue = _frames(9, stall_at=4, extra=600)
    host = [("Command_Buffer_Full", 10_000 * 6 + 450, 10_000 * 6 + 460, 0)]
    st = fs.stalls(issue, spans, host)
    assert st["frames"] == 9 and st["stalled"] == 1
    assert st["stalled_extra_ms"] == pytest.approx(600e-6)
    assert st["by_label"] == {"epilogue.background": [1, pytest.approx(600e-6)]}
    labels = fs.frame_labels(issue, spans, host)
    assert labels[6]["epilogue.background > Command_Buffer_Full"] == 10
    assert labels[6]["epilogue.background"] == 390 and labels[0]["outside"] == 10
