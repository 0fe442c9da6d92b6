"""The window's frame arithmetic, the trace reduction and every per-layer
reader on synthetic inputs, against hand-worked numbers."""

import json
from pathlib import Path

import pytest

from bench_torch import harness
from bench_torch import trace as tr

BENCH_DIR = Path(__file__).resolve().parents[1]
COUNTS = {c: json.loads((BENCH_DIR / "counts" / f"{c}.json").read_text())
          for c in harness.COUNTS}


def test_frame_stats_of_a_steady_window():
    frame_ms, p95 = harness.frame_stats([1.0 * (i + 1) for i in range(100)])
    assert frame_ms == pytest.approx(1.0) and p95 == pytest.approx(1.0)


def test_a_stall_moves_both_frame_ms_and_the_tail():
    ends, t = [], 0.0
    for i in range(100):
        t += 10.0 if i % 10 == 5 else 1.0  # one frame in ten waits 10 ms
        ends.append(t)
    frame_ms, p95 = harness.frame_stats(ends)
    assert frame_ms == pytest.approx(190.0 / 100)
    assert p95 == pytest.approx(10.0)  # 10 of 100 intervals are 10 ms
    steady_ms, steady_p95 = harness.frame_stats([1.0 * (i + 1) for i in range(100)])
    assert frame_ms > steady_ms and p95 > steady_p95


def test_window_keeps_its_sampled_frames_and_the_last():
    clock = harness.Clock("cpu")
    issued = []

    def render(k):
        issued.append(k)
        return k

    end_ms, issue_s, kept, k_next = harness.run_window(render, clock, 0.05, 2, 100, {101, 103})
    assert issued == list(range(100, k_next)) and len(end_ms) == len(issued) == len(issue_s)
    assert {101, 103, k_next - 1} <= set(kept) and kept[101] == 101
    assert end_ms == sorted(end_ms)


def test_busy_union_and_gaps():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 3.0)]
    assert tr.busy_s(ops) == pytest.approx(2.5)
    assert tr.gaps(ops, 4.0) == [(1.5, 2.0), (3.0, 4.0)]


def test_in_window_clips_and_labels():
    ns = 1_000_000_000
    dev = [("k1", 0, ns // 2), ("k2", 2 * ns, int(2.5 * ns)), ("k3", 4 * ns, 6 * ns)]
    host = [("bench.window", ns, 5 * ns), ("bench.wait", ns, int(1.6 * ns)),
            ("cudaEventSynchronize", ns, int(1.5 * ns)),
            ("bench.issue", int(3.2 * ns), int(3.8 * ns))]
    d, h, w = tr.in_window(dev, host)
    assert w == pytest.approx(4.0)
    assert [x[0] for x in d] == ["k2", "k3"] and d[1][2] == pytest.approx(4.0)
    index = tr.HostIndex(h)
    assert index.doing(0.2) == "bench.wait > cudaEventSynchronize"
    assert index.doing(0.55) == "bench.wait"
    assert index.doing(2.5) == "bench.issue"
    assert index.doing(2.9) == "host idle"
    b = tr.breakdown(d, h, w)
    assert b["device_ops"] == [["k3", pytest.approx(1.0)], ["k2", pytest.approx(0.5)]]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "bench.wait > cudaEventSynchronize": pytest.approx(1.0),
        "host idle": pytest.approx(1.5)}


def records(**kw):
    base = dict(kernels=[], host=[], window_s=1.0, frames=1, frame_interval_ms=1.0,
                issue_ms=[], ray_steps=None, counts=COUNTS, pixels=1920 * 1080, net=None,
                config={"renderer": {"model": "schwarzschild", "integrator": "euler",
                                     "adaptive": False, "disk": False}},
                traffic={})
    base.update(kw)
    return type("Records", (), base)


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_idle_share_is_one_less_the_union():
    rec = records(kernels=[("a", 0.0, 0.4), ("b", 0.2, 0.6), ("c", 0.8, 0.9)], window_s=1.0)
    assert read("device.idle_pct", rec) == pytest.approx(30.0)
    assert read("device.idle_pct", records()) is None


def test_epilogue_is_every_op_but_the_geodesic_kernel():
    kernels = [("void bhr::trace_planes_kernel<false, 1, false, -1>", 0.0, 0.010),
               ("vectorized_elementwise_kernel<add>", 0.010, 0.012),
               ("Memset (Device)", 0.012, 0.013)] * 2
    rec = records(kernels=kernels, frames=2)
    assert read("epilogue.device_ms", rec) == pytest.approx(3.0)
    assert read("epilogue.launches", rec) == pytest.approx(2.0)
    mono = records(kernels=[("render_mono_kernel<true, 0>", 0.0, 0.001)])
    assert read("epilogue.device_ms", mono) is None and read("epilogue.launches", mono) is None


def test_geodesic_roofline_from_the_copied_counts():
    # the main path: 960,386,610 ray-steps of 50 operations at 67 TFLOP/s is 0.7167 ms
    rec = records(kernels=[("render_mono_kernel<true, 0, false, 0>", 0.0, 1.4e-3)],
                  ray_steps=960_386_610)
    least = 960_386_610 * 50 / 67e12
    assert read("geodesic.roofline_pct", rec) == pytest.approx(100 * least / 1.4e-3)
    assert COUNTS["ops_per_step"]["counts"]["schwarzschild.rk4.adaptive.disk"] == 222
    assert read("geodesic.roofline_pct", records(ray_steps=1)) is None


def test_neural_roofline_and_mfu_from_the_widths():
    net = [(16, 128), (128, 128), (128, 128), (128, 2)]
    px = 1920 * 1080
    mlp = 2 * (16 * 128 + 2 * 128 * 128 + 128 * 2) * px
    assert mlp == pytest.approx(1.4545e11, rel=1e-3)
    rec = records(kernels=[("neural_fused_kernel<false, 128>", 0.0, 0.985e-3)], net=net,
                  frame_interval_ms=1.1)
    assert read("neural.roofline_pct", rec) == pytest.approx(100 * mlp / 989e12 / 0.985e-3)
    assert read("neural.mfu_pct", rec) == pytest.approx(100 * mlp / (1.1e-3 * 989e12))
    assert read("neural.roofline_pct", records(net=net)) is None


def test_host_issue_is_the_mean():
    assert read("host.issue_ms", records(issue_ms=[1.0, 2.0, 3.0])) == pytest.approx(2.0)
    assert read("host.issue_ms", records()) is None


def test_a_metric_split_by_cells_reads_with_its_base():
    rec = records(issue_ms=[1.0, 3.0], kernels=[("k", 0.0, 0.5)], window_s=1.0)
    assert read("host.issue_ms.neural", rec) == read("host.issue_ms", rec) == pytest.approx(2.0)
    assert read("device.idle_pct.neural", rec) == pytest.approx(50.0)
