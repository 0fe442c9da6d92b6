"""The program's spans as the benchmark reads them: self times, the
innermost open span, the outermost set-up spans, the readers of the host
stages, the shading kernel and the set-up phases on synthetic records;
each device operation tied to the program span that launched it, and the
idle gaps named by it; and a --trace 1 run of the harness on the CPU, with
the profiler stubbed (the CPU build of torch traces no CUDA activity)."""

import time
import types

import pytest
from bhr_tpu_torch.utils import tracing

from bench_torch import harness
from bench_torch import spans as sp
from bench_torch import trace as tr

US = 1e-6


def frame(t0):
    """One staged frame's spans from t0 (s): host.frames > camera, launch >
    params > params.ks, epilogue > background, shade kernel."""
    return [("host.frames", t0, t0 + 1000 * US, None, 0),
            ("host.camera", t0 + 10 * US, t0 + 110 * US, 0, 0),
            ("kernel.trace_planes", t0 + 120 * US, t0 + 320 * US, 0, 0),
            ("host.params", t0 + 130 * US, t0 + 180 * US, 2, 0),
            ("host.params.ks", t0 + 140 * US, t0 + 160 * US, 3, 0),
            ("epilogue", t0 + 330 * US, t0 + 990 * US, 0, 0),
            ("epilogue.background", t0 + 400 * US, t0 + 800 * US, 5, 0),
            ("kernel.shade_planes", t0 + 850 * US, t0 + 900 * US, 5, 0)]


def frames(n):
    out = []
    for i in range(n):
        off = len(out)
        out += [(nm, a, b, None if p is None else p + off, i)
                for nm, a, b, p, _ in frame(i * 0.01)]
    return out


def records(**kw):
    base = dict(kernels=[], host=[], window_s=1.0, frames=2, frame_interval_ms=1.0, issue_ms=[],
                spans=[], launched_by=[], setup_spans=[], setup_host=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_self_time_is_the_recorders_rule():
    spans = frames(3)
    ns = [tracing.Span(n, round(a * 1e9), round(b * 1e9), p, f) for n, a, b, p, f in spans]
    assert [round(x * 1e9) for x in sp.self_times(spans)] == tracing.self_ns(ns)
    own = dict(zip((s[0] for s in spans[:8]), sp.self_times(spans)[:8]))
    assert own["host.params"] == pytest.approx(30 * US) and own["kernel.trace_planes"] == (
        pytest.approx(150 * US))
    assert own["epilogue"] == pytest.approx((660 - 400 - 50) * US)


def test_stage_self_times_a_frame():
    ms = sp.stage_ms(frames(4), 4)
    assert ms["camera"] == pytest.approx(0.100) and ms["params"] == pytest.approx(0.050)
    assert ms["launch"] == pytest.approx(0.200) and ms["epilogue"] == pytest.approx(0.610)
    assert ms["frames"] == pytest.approx(1.0 - 0.100 - 0.200 - 0.660)
    assert sum(ms.values()) == pytest.approx(1.0)
    assert sp.stage_ms([], 1) == {} and sp.stage("setup.nvcc") == "setup"


def test_relative_clips_and_remaps_parents():
    ns = [("setup.import", 0, 100, None, None), ("setup.load", 200, 500, None, None),
          ("setup.build", 210, 400, 1, None), ("gc", 450, 700, 1, None)]
    out = sp.relative(ns, 150, 600)
    assert out == [("setup.load", pytest.approx(50e-9), pytest.approx(350e-9), None, None),
                   ("setup.build", pytest.approx(60e-9), pytest.approx(250e-9), 0, None),
                   ("gc", pytest.approx(300e-9), pytest.approx(450e-9), 0, None)]


def test_outermost_setup_spans():
    spans = [("setup.import", 0.0, 0.1, None, None), ("setup.load", 0.2, 0.5, None, None),
             ("setup.build", 0.21, 0.4, 1, None), ("host.params", 0.6, 0.9, None, 0),
             ("setup.neural_prepare", 0.65, 0.85, 3, 0)]
    assert [s[0] for s in sp.outer_setup(spans)] == ["setup.import", "setup.load",
                                                       "setup.neural_prepare"]
    rec = records(setup_spans=spans, setup_host=[("bench.build", 0.0, 0.55),
                                                 ("bench.warmup", 0.56, 1.2)])
    assert read("setup.program_s", rec) == pytest.approx(0.1 + 0.3 + 0.2)
    assert read("setup.build_s", rec) == pytest.approx(0.55)
    assert read("setup.warmup_s", rec) == pytest.approx(0.64)
    for name in ("setup.program_s", "setup.build_s", "setup.warmup_s"):
        assert read(name, records()) is None


def test_innermost_open_span():
    where = sp.Innermost(frames(2))
    assert where.at(150 * US)[0] == "host.params.ks"
    assert where.at(170 * US)[0] == "host.params"
    assert where.at(0.01 + 500 * US)[0] == "epilogue.background"
    assert where.at(0.005) is None


@pytest.mark.parametrize("split", ["", ".neural"])
def test_host_stage_readers(split):
    rec = records(spans=frames(2), frames=2)
    want = {"camera": 0.100, "params": 0.050, "launch": 0.200, "epilogue": 0.610}
    for stage, ms in want.items():
        if stage != "epilogue" or not split:
            assert read(f"host.{stage}_ms{split}", rec) == pytest.approx(ms)
    # a monolithic frame with no parameter span: host.frames > camera, launch
    mono = frame(0.0)[:3]
    assert read(f"host.params_ms{split}", records(spans=mono)) is None
    assert read("host.epilogue_ms", records(spans=mono)) is None
    assert read(f"host.launch_ms{split}", records(spans=mono, frames=1)) == pytest.approx(0.2)
    for stage in want:
        assert read(f"host.{stage}_ms{split}", records()) is None


def test_the_shading_kernel_by_its_launching_span():
    kernels = [("trace_planes_kernel", 0.0, 0.010), ("shade_planes_kernel", 0.010, 0.0102),
               ("Memset (Device)", 0.0102, 0.0103)] * 2
    by = [None, "kernel.shade_planes", "epilogue"] * 2
    rec = records(kernels=kernels, launched_by=by, frames=2)
    assert read("epilogue.shade_kernel_device_ms", rec) == pytest.approx(0.2)
    assert read("epilogue.device_ms", rec) == pytest.approx(0.3)
    assert read("epilogue.shade_kernel_device_ms", records(kernels=kernels,
                                                          launched_by=[None] * 6)) is None


def test_launched_by_follows_the_correlation_id():
    program = frames(1)
    host = [("bench.issue", -5 * US, 1005 * US),
            ("cudaLaunchKernel", 300 * US, 305 * US, 11),
            ("cudaLaunchKernel", 870 * US, 875 * US, 12),
            ("cudaMemsetAsync", 500 * US, 501 * US, 13),
            ("cudaLaunchKernel", 2000 * US, 2001 * US, 14)]
    dev = [("k", 400 * US, 700 * US, 11), ("shade", 900 * US, 950 * US, 12),
           ("Memset", 960 * US, 961 * US, 13), ("late", 2100 * US, 2200 * US, 14),
           ("orphan", 2300 * US, 2400 * US, 0)]
    assert tr.launched_by(dev, host, program) == [
        "kernel.trace_planes", "kernel.shade_planes", "epilogue.background", None, None]


def test_idle_gaps_are_named_by_the_program_span():
    program = frames(1)
    host = [("bench.issue", -5 * US, 1005 * US), ("cudaLaunchKernel", 300 * US, 310 * US),
            ("bench.wait", 1010 * US, 1800 * US), ("cudaEventSynchronize", 1020 * US, 1790 * US)]
    dev = [("k", 0.0, 50 * US), ("k", 305 * US, 1030 * US), ("k", 1500 * US, 2000 * US)]
    index = tr.HostIndex(host, program)
    assert index.doing(307 * US) == "bench.issue > kernel.trace_planes > cudaLaunchKernel"
    assert index.doing(60 * US) == "bench.issue > host.camera"
    assert index.doing(1100 * US) == "bench.wait > cudaEventSynchronize"
    b = tr.breakdown(dev, host, 2500 * US, program=program)
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "bench.issue > host.camera": pytest.approx(255 * US),
        "bench.wait > cudaEventSynchronize": pytest.approx(470 * US),
        "host idle": pytest.approx(500 * US)}
    # without the program's spans, the label is what it was
    assert tr.HostIndex(host).doing(60 * US) == "bench.issue"


def test_in_window_keeps_the_correlation_ids():
    dev = [("k", 0, 2000, 5), ("k2", 3000, 3500, 6)]
    host = [("bench.window", 1000, 4000), ("cudaLaunchKernel", 1100, 1200, 6)]
    assert tr.window(host) == (1000, 4000) and tr.window([]) is None
    d, h, w = tr.in_window(dev, host)
    assert [x[3] for x in d] == [5, 6] and h[0][3] == 6 and w == pytest.approx(3e-6)


class NoCudaTrace:
    """torch.profiler.profile's place on the CPU: a trace with no events."""

    profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: []))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("name, metrics_of, want", [
    # the plugin's construction records setup.plugin on the CPU too
    ("pw4k.orbit_exact", "rk4disk1080.orbit_exact",
     {"host.camera_ms", "host.launch_ms", "host.epilogue_ms", "setup.program_s", "setup.build_s",
      "setup.warmup_s"}),
    ("sch1080.orbit_neural", "sch1080.orbit_neural",
     {"host.camera_ms.neural", "host.launch_ms.neural", "setup.build_s", "setup.warmup_s"})])
def test_a_trace_1_run_reads_the_programs_spans(monkeypatch, name, metrics_of, want):
    """The CPU's plain versions record no host.params span: it sits on the
    card's launch path."""
    monkeypatch.setattr(harness, "profile", NoCudaTrace)
    cell = harness.load_cell(name)
    cell.per_layer = harness.load_cell(metrics_of).per_layer
    cell.config["scene"].update(width=24, height=16, max_steps=40)
    cell.traffic.update(sample_within=2, compare_frames=1, warmup_frames=1)
    out = harness.run_cell(cell, 2**31 + 11, 0.5, True, t_start=time.perf_counter(),
                           device="cpu")
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] and want <= set(got), got
    assert all(got[k] > 0 for k in want)
    assert got.get("setup.program_s", 0.0) <= got["setup.build_s"] + got["setup.warmup_s"]
    assert tracing.drain() == []  # the run drained what it recorded
