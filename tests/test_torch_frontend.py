"""The port's front end against bhr_tpu's: PerformanceStats and PerfLogger,
TimestampQuery and the timing helpers, render_frame(timestamp_query=),
block_on, PathAnimator (custom camera paths, render_to_dir with its
manifest and resume, save_video, save_gif), the MJPEG writer and the native
PNG queue, and the package's exports.

PathAnimator's frames are held against bhr_tpu's (its XLA oracle in a
lax.scan, the CPU default) at the chaos-aware bars of
tests/test_pallas_parity.py:46-61 as tests/test_torch_render.py applies
them to animations: the two programs compute the path's cameras apart, a
camera an ulp off moves a few photon-sphere pixels, so black masks agree,
channels are within 1 level and words are bit-equal, each on >= 99.5% of
pixels. The GPU checks are marked `gpu` and skip where there is no card.
"""

import csv
import inspect
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhr_tpu as J
import bhr_tpu_torch as T
from bhr_tpu.io import video as jvideo
from bhr_tpu.utils import perf as jperf
from bhr_tpu_torch.io import image as timage
from bhr_tpu_torch.io import native as tnative
from bhr_tpu_torch.io import video as tvideo
from bhr_tpu_torch.utils import perf as tperf
from bhr_tpu_torch.utils import timing as ttiming
from bhr_tpu_torch.utils.tracing import COUNTS

FAST_MIN = 0.995
SIZE = (48, 32, 120)
SMALL = dict(screen_width=32, screen_height=16, max_steps=40)


def _u8(packed) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(packed))
    return a.view(np.uint8).reshape(*a.shape, 4).astype(np.int32)


# ---- exports --------------------------------------------------------------------


def test_the_seven_names_import_from_the_package():
    from bhr_tpu_torch import (  # noqa: F401
        QUAD_VERTICES,
        PathAnimator,
        PerfLogger,
        PerformanceStats,
        TimestampQuery,
        Vertex,
        block_on,
    )

    assert issubclass(T.OrbitAnimator, T.PathAnimator)
    assert "timestamp_query" in inspect.signature(T.BlackHoleRenderer.render_frame).parameters
    for name in ("block_on", "PathAnimator", "PerfLogger", "PerformanceStats", "TimestampQuery",
                 "QUAD_VERTICES", "Vertex"):
        assert name in T.__all__
    assert [v.position for v in T.QUAD_VERTICES] == [v.position for v in J.QUAD_VERTICES]


def test_queue_is_the_contexts_device_as_in_bhr_tpu():
    # tests/test_renderer.py:119 holds bhr_tpu's accessor the same way
    ctx = T.CudaContext.new("cpu")
    r = T.BlackHoleRenderer(8, 8, context=ctx)
    assert r.device is ctx.device
    assert r.queue is ctx.device
    jr = J.BlackHoleRenderer(8, 8)
    assert jr.queue is jr.context.device


def test_block_on_runs_awaitables_and_passes_values():
    async def answer():
        return 42

    assert T.block_on(answer()) == 42
    ctx = T.CudaContext.new("cpu")
    assert T.block_on(ctx) is ctx


# ---- perf statistics and the CSV logger ----------------------------------------------


def _feed(mod, times):
    s = mod.PerformanceStats(max_samples=7)
    for k, t in enumerate(times):
        s.record_frame_time_ms(t)
        s.update_cpu_time(0.25 * t + k % 3)
        s.update_gpu_time(0.5 * t)
    return s


def test_perf_stats_match_bhr_tpu():
    rng = np.random.RandomState(3)
    times = list(rng.uniform(2.0, 40.0, 30))
    j, t = _feed(jperf, times), _feed(tperf, times)
    for name in ("avg_fps", "min_fps", "max_fps", "std_dev_fps", "avg_cpu_time", "avg_gpu_time"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert list(t.frame_times) == list(j.frame_times) and len(t.frame_times) == 7
    assert t.measuring and t.current_gpu_time == j.current_gpu_time
    assert tperf.WARMUP_FRAMES == jperf.WARMUP_FRAMES == 10


def test_perf_logger_rows_match_bhr_tpu(tmp_path):
    times = np.random.RandomState(4).uniform(1.0, 30.0, 25)
    rows = {}
    for mod in (jperf, tperf):
        logger = mod.PerfLogger("frontend", directory=str(tmp_path / mod.__name__))
        s = mod.PerformanceStats()
        for t in times:
            s.record_frame_time_ms(float(t))
            s.update_cpu_time(1.5)
            s.update_gpu_time(float(t) / 2)
            logger.log_frame(s)
        logger.close()
        assert os.path.basename(logger.filename).startswith("perf_log_frontend_")
        with open(logger.filename) as fh:
            rows[mod] = list(csv.reader(fh))
    assert tperf.CSV_HEADER == jperf.CSV_HEADER and len(tperf.CSV_HEADER) == 12
    assert rows[tperf][0] == rows[jperf][0] == tperf.CSV_HEADER
    assert len(rows[tperf]) == len(rows[jperf]) == 26
    for got, want in zip(rows[tperf][1:], rows[jperf][1:]):
        assert got[1:] == want[1:]  # all but the elapsed-time stamp


# ---- timing ---------------------------------------------------------------------


def test_timestamp_query_lifecycle_on_the_cpu():
    q = T.TimestampQuery(device="cpu")
    assert q.gpu_time_ms is None
    q.begin()
    q.end()
    assert q.gpu_time_ms is not None and q.gpu_time_ms >= 0.0
    floored = T.TimestampQuery(overhead_ms=1e6)
    floored.begin("cpu")
    time.sleep(0.001)
    floored.end()
    assert floored.gpu_time_ms == 0.0
    slept = T.TimestampQuery()
    slept.begin("cpu")
    time.sleep(0.005)
    slept.end()
    assert slept.gpu_time_ms >= 4.0


def test_timestamp_query_names_the_card_without_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.TimestampQuery().begin()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttiming.time_fn(lambda: None)


def test_render_frame_fills_the_timestamp_query():
    r = T.BlackHoleRenderer(24, 16, device="cpu")
    q = T.TimestampQuery()
    frame = r.render_frame(scene=T.SceneParams(**{**SMALL, "screen_width": 24}),
                           timestamp_query=q)
    assert frame.shape == (16, 24, 4)
    assert q.gpu_time_ms is not None and q.gpu_time_ms > 0.0


def test_time_fn_calibration_and_profiler_on_the_cpu(tmp_path):
    assert ttiming.time_fn(lambda x: x + 1, torch.ones(8), warmup=1, iters=3) >= 0.0
    assert 0.0 <= ttiming.calibrate_dispatch_overhead_ms(reps=3, device="cpu") < 10_000.0
    with pytest.raises(ValueError, match="CUDA"):
        ttiming.device_time_ms(lambda x: x + 1, torch.ones(8))
    with ttiming.profiler_trace(str(tmp_path / "trace")):
        torch.ones(16).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


# ---- PathAnimator ---------------------------------------------------------------


def _flyin_jax(t):
    pos = jnp.stack([15.0 - t * 2.0, jnp.zeros_like(t) + 5.0, jnp.zeros_like(t)])
    return J.Camera.new(pos, jnp.zeros(3), jnp.asarray([0.0, 1.0, 0.0]))


def _flyin_torch(t):
    pos = torch.stack([15.0 - t * 2.0, torch.zeros_like(t) + 5.0, torch.zeros_like(t)])
    return T.Camera.new(pos, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))


def test_path_animator_matches_bhr_tpu():
    w, h, steps = SIZE
    js = J.SceneParams(screen_width=w, screen_height=h, max_steps=steps)
    want = np.asarray(J.PathAnimator(J.BlackHoleRenderer(w, h), _flyin_jax).render_frames(
        3, fps=4.0, scene=js, packed=True))
    ts = T.SceneParams(screen_width=w, screen_height=h, max_steps=steps)
    got = T.PathAnimator(T.BlackHoleRenderer(w, h, device="cpu"), _flyin_torch).render_frames(
        3, fps=4.0, scene=ts, packed=True)
    assert got.shape == (3, h, w) and got.dtype == torch.int32
    for k in range(3):
        g, wt = _u8(got[k].numpy()), _u8(want[k])
        same = (got[k].numpy().view(np.uint32) == want[k].view(np.uint32)).mean()
        black = ((g[..., :3] == 0).all(-1) == (wt[..., :3] == 0).all(-1)).mean()
        within_1 = (np.abs(g - wt).max(-1) <= 1).mean()
        assert min(same, black, within_1) >= FAST_MIN, (k, same, black, within_1)
    assert not torch.equal(got[0], got[2])  # the camera moves


def test_path_animator_frames_are_direct_renders_and_orbit_is_a_path():
    r = T.BlackHoleRenderer(32, 16, device="cpu")
    scene = T.SceneParams(**SMALL)
    frames = T.PathAnimator(r, _flyin_torch).render_frames(2, fps=10.0, scene=scene)
    assert frames.shape == (2, 16, 32, 4) and frames.dtype == torch.uint8
    direct = r.render_frame(_flyin_torch(torch.tensor(0.1, dtype=torch.float32)), scene)
    torch.testing.assert_close(frames[1], direct, rtol=0, atol=0)
    orbit = T.OrbitAnimator(r)
    as_path = T.PathAnimator(r, lambda t: T.orbit_camera(t))
    torch.testing.assert_close(orbit.render_frames(3, scene=scene, packed=True),
                               as_path.render_frames(3, scene=scene, packed=True), rtol=0, atol=0)
    launches = COUNTS["launch.render_mono"]
    orbit.render_frames(2, scene=scene)
    assert COUNTS["launch.render_mono"] == launches  # the CPU path launches no kernel


def _png(path) -> np.ndarray:
    return timage.read_png(str(path))


def test_render_to_dir_writes_a_sequence_and_a_manifest(tmp_path):
    r = T.BlackHoleRenderer(32, 16, device="cpu")
    anim = T.OrbitAnimator(r)
    scene = T.SceneParams(**SMALL)
    paths = anim.render_to_dir(str(tmp_path), 5, fps=60.0, chunk_size=2, scene=scene)
    assert len(paths) == 5
    assert sorted(os.listdir(tmp_path)) == [f"frame_{i:05d}.png" for i in range(5)] + [
        "manifest.json"]
    frames = anim.render_frames(5, fps=60.0, scene=scene).numpy()
    for k, p in enumerate(paths):
        np.testing.assert_array_equal(_png(p), frames[k])
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["max_steps"] == SMALL["max_steps"]
    assert manifest["camera_path"] == "orbit:speed=0.3,radius=15.0,height=5.0"
    # the same keys and values as bhr_tpu's manifest for the same settings
    jr = J.BlackHoleRenderer(32, 16)
    want = J.OrbitAnimator(jr)._manifest(5, 60.0, 0, J.SceneParams(**SMALL))
    assert manifest == json.loads(json.dumps(want))


def test_render_to_dir_resume_skips_existing_frames(tmp_path):
    anim = T.PathAnimator(T.BlackHoleRenderer(32, 16, device="cpu"), _flyin_torch)
    scene = T.SceneParams(**SMALL)
    anim.render_to_dir(str(tmp_path), 3, fps=60.0, chunk_size=2, scene=scene)
    first = {p: os.path.getmtime(tmp_path / p) for p in os.listdir(tmp_path)
             if p != "manifest.json"}
    time.sleep(0.01)
    paths = anim.render_to_dir(str(tmp_path), 6, fps=60.0, chunk_size=2, scene=scene,
                               resume=True)
    assert len(paths) == 6 and len(os.listdir(tmp_path)) == 7
    for name, mtime in first.items():
        assert os.path.getmtime(tmp_path / name) == mtime
    fresh = anim.render_frames(6, fps=60.0, scene=scene).numpy()
    np.testing.assert_array_equal(_png(tmp_path / "frame_00005.png"), fresh[5])
    assert json.load(open(tmp_path / "manifest.json"))["camera_path"].startswith("custom:")


def test_render_to_dir_manifest_guards_resume(tmp_path):
    anim = T.OrbitAnimator(T.BlackHoleRenderer(32, 16, device="cpu"))
    scene = T.SceneParams(**SMALL)
    anim.render_to_dir(str(tmp_path), 2, fps=60.0, chunk_size=2, scene=scene)
    other = T.SceneParams(**{**SMALL, "max_steps": 80})
    with pytest.raises(ValueError, match="max_steps"):
        anim.render_to_dir(str(tmp_path), 4, fps=60.0, chunk_size=2, scene=other, resume=True)
    anim.render_to_dir(str(tmp_path), 2, fps=60.0, chunk_size=2, scene=other)
    assert json.load(open(tmp_path / "manifest.json"))["max_steps"] == 80


def test_save_video_and_gif(tmp_path):
    anim = T.OrbitAnimator(T.BlackHoleRenderer(32, 16, device="cpu"))
    scene = T.SceneParams(**{**SMALL, "max_steps": 20})
    p = str(tmp_path / "orbit.avi")
    anim.save_video(p, 3, fps=12.0, scene=scene)
    info = tvideo.read_avi_info(p)
    assert info["frames"] == 3 and (info["width"], info["height"]) == (32, 16)
    assert info["codec"] == "MJPG" and abs(info["fps"] - 12.0) < 0.1
    g = str(tmp_path / "orbit.gif")
    anim.save_gif(g, 3, fps=30.0, scene=scene)
    from PIL import Image

    assert Image.open(g).n_frames == 3


def test_mjpeg_avi_is_bhr_tpus_file(tmp_path):
    """The structure tests/test_video.py checks, and the same bytes as
    bhr_tpu's writer for the same frames."""
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, (5, 32, 48, 4)).astype(np.uint8)
    frames[..., 3] = 255
    got, want = str(tmp_path / "port.avi"), str(tmp_path / "jax.avi")
    tvideo.write_mjpeg_avi(got, frames, fps=24.0)
    jvideo.write_mjpeg_avi(want, frames, fps=24.0)
    info = tvideo.read_avi_info(got)
    assert info == jvideo.read_avi_info(want)
    assert info["frames"] == 5 and (info["width"], info["height"]) == (48, 32)
    assert info["codec"] == "MJPG" and abs(info["fps"] - 24.0) < 0.1
    assert open(got, "rb").read() == open(want, "rb").read()


# ---- the native PNG writer ------------------------------------------------------


def test_native_png_queue_round_trips(tmp_path):
    rng = np.random.RandomState(1)
    rgba = rng.randint(0, 256, (12, 20, 4)).astype(np.uint8)
    fallback = str(tmp_path / "fallback.png")
    tnative.write_png_fallback(fallback, rgba)
    np.testing.assert_array_equal(_png(fallback), rgba)
    queued = [str(tmp_path / f"q{k}.png") for k in range(3)]
    for k, p in enumerate(queued):
        tnative.submit_frame(p, np.roll(rgba, k, axis=1))
    assert tnative.drain() == 0 and tnative.pending() == 0
    for k, p in enumerate(queued):
        np.testing.assert_array_equal(_png(p), np.roll(rgba, k, axis=1))
    if tnative.available():
        sync = str(tmp_path / "sync.png")
        tnative.write_png(sync, rgba)
        np.testing.assert_array_equal(_png(sync), rgba)


# ---- on the card ------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
def test_timestamp_query_on_the_card_adds_no_sync():
    _need_cuda()
    r = T.BlackHoleRenderer(320, 192, device="cuda")
    scene = T.SceneParams(screen_width=320, screen_height=192, max_steps=200)
    r.render_frame(scene=scene)
    torch.cuda.synchronize()
    q = T.TimestampQuery()
    launches = COUNTS["launch.render_mono"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.render_frame(scene=scene, timestamp_query=q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert COUNTS["launch.render_mono"] == launches + 1
    assert q.gpu_time_ms > 0.0
    kernel_ms = ttiming.device_time_ms(lambda: r.render_frame(scene=scene), iters=4)
    assert 0.0 < kernel_ms < 10 * q.gpu_time_ms


@pytest.mark.gpu
def test_path_animator_on_the_card_equals_orbit_animator():
    _need_cuda()
    r = T.BlackHoleRenderer(96, 64, device="cuda", fast_math=True)
    scene = T.SceneParams(screen_width=96, screen_height=64, max_steps=200)
    want = T.OrbitAnimator(r).render_frames(4, scene=scene, packed=True)
    launches = COUNTS["launch.render_mono"]
    got = T.PathAnimator(r, lambda t: T.orbit_camera(t)).render_frames(4, scene=scene,
                                                                        packed=True)
    torch.cuda.synchronize()
    assert COUNTS["launch.render_mono"] == launches + 4
    assert torch.equal(got, want)
