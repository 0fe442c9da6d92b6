"""The benchmark of the raytracer's PyTorch and CUDA port: one cell a run.

A cell (an entry of BENCHMARK.json's "workloads") names a configuration
(configs/<config>.json: the scene, the integrator, the camera path, the
plain reference that checks it) and a traffic mix (traffic/<mix>.json:
the route and tier, the net, frames in flight, what the seed sets, how
many frames are compared). limits/<cell>.json holds the limit of each
number compared, and metrics/<metric>.py one reader for each per-layer
metric. Everything is found by name, so a cell, mix or metric is added by
adding files.

The window is the reference application's frame loop, closed: frame k is
one call of OrbitAnimator.render_frames(1, start_frame=k, packed=True),
kept on the device; before issuing frame k the host waits for the end of
frame k - in_flight, as a swap chain would, and a CUDA event is recorded
after each frame. The events are read after the window, so the window
makes no other host sync. Once the window has closed and the program's
state is freed, the frames sampled from the seed (and the last) are held
against the plain reference.

A --trace 1 run also records the program's own spans (utils/tracing):
through the build ("bench.build") and the warm-up ("bench.warmup"), and
through the traced half of the window, inside the profiler. The untraced
half, which gives host.issue_ms, and a --trace 0 run record none.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import random
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

from . import spans as sp
from . import trace as tr
from .reference.common import orbit_camera

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
COUNTS = ("ops_per_step", "neural_pixel_ops", "bytes_per_pixel", "peaks")
JAX_NAMES = {"jax", "jaxlib", "flax", "bhr_tpu"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    counts: dict


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench_file: Path = REPO / "BENCHMARK.json") -> Cell:
    """The cell `name` of BENCHMARK.json with its files, found by name."""
    bench = _load(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in {bench_file}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(REPO / cfg["file"])
    reports = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reports else [])]
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_load(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_load(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if m["name"] in reports],
        per_layer=per_layer,
        counts={c: _load(BENCH_DIR / "counts" / f"{c}.json") for c in COUNTS},
    )


def reference_module(cell: Cell):
    """The plain reference that checks the cell: the traffic's, else the
    configuration's (reference/<name>.py)."""
    name = cell.traffic.get("reference", cell.config["reference"])
    return importlib.import_module(f"{__package__}.reference.{name}")


def metric_reader(name: str):
    """metrics/<name>.py's `read(records) -> float | None`; a metric split
    by cells ("host.issue_ms.neural") without a file of its own reads with
    its base's ("host.issue_ms")."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- what the seed sets ------------------------------------------------------


def seeded(cell: Cell, seed: int) -> dict:
    """The run's inputs from its seed: the orbit's start frame, the star
    field's seed and the window's frames held against the reference
    (offsets from the start). No size changes with the seed."""
    rng = random.Random(seed)
    period = cell.config["camera"]["frames_per_orbit"]
    t = cell.traffic
    return {"phase": rng.randrange(period), "star_seed": rng.getrandbits(31),
            "sample": sorted(rng.sample(range(t["sample_within"]), t["compare_frames"]))}


# ---- the program -------------------------------------------------------------


def build_program(cell: Cell, star_seed: int, device):
    """The animator of the port (bhr_tpu_torch) for the cell, and a
    function k -> the packed frame k on the device, through the public
    entry points only."""
    import bhr_tpu_torch as bt

    sc, cam = cell.config["scene"], cell.config["camera"]
    kw = {**cell.config["renderer"], **cell.traffic.get("renderer", {})}
    if "asset" in cell.traffic:
        kw["neural_params"] = str(asset_path(cell))
    renderer = bt.BlackHoleRenderer(sc["width"], sc["height"], device=device,
                                    skybox_seed=star_seed, **kw)
    renderer.scene = bt.SceneParams(
        screen_width=sc["width"], screen_height=sc["height"], max_steps=sc["max_steps"],
        schwarzschild_radius=sc["schwarzschild_radius"], fov=sc["fov"],
        black_hole_position=sc["black_hole_position"], spin=sc["spin"])
    anim = bt.OrbitAnimator(renderer, rotation_speed=cam["rotation_speed"],
                            radius=cam["radius"], height=cam["height"])

    def render(k: int) -> torch.Tensor:
        return anim.render_frames(1, fps=cam["fps"], start_frame=k, packed=True)

    return anim, render


def recorder():
    """The program's span recorder (bhr_tpu_torch.utils.tracing), imported
    where a --trace 1 run first records."""
    from bhr_tpu_torch.utils import tracing

    return tracing


@contextmanager
def setup_phase(bench, name: str):
    """In a --trace 1 run (`bench`, the benchmark's HostSpans), the
    benchmark's span `name` around the block, with the program's recording
    on inside it; nothing in a --trace 0 run (`bench` None)."""
    if bench is None:
        yield
        return
    with bench(name), recorder().recording():
        yield


def profile():
    """The traced half's profiler: CUDA activity alone."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


class Clock:
    """CUDA events on the card; the host clock where the device is the CPU
    (the CPU tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def record(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, ev) -> None:
        if self.cuda:
            ev.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def frame_stats(end_ms: list[float]) -> tuple[float, float]:
    """(frame_ms, frame_ms_p95) of a window from its frames' end times in
    ms after its start event: the window's time over its frames, and the
    95th percentile (linear between order statistics) of the intervals
    between consecutive ends, the first from the start."""
    if not end_ms:
        raise ValueError("no frame completed in the window")
    intervals = [b - a for a, b in zip([0.0] + end_ms[:-1], end_ms)]
    if len(intervals) < 2:
        return end_ms[-1], intervals[0]
    p95 = statistics.quantiles(intervals, n=20, method="inclusive")[-1]
    return end_ms[-1] / len(end_ms), p95


def run_window(render, clock: Clock, seconds: float, in_flight: int, k0: int, keep: set,
               span=None):
    """Issue frames k0, k0 + 1, ... for `seconds` of host time, at most
    `in_flight` on the device -> (end times in ms after the start event,
    host issue seconds of each frame, {k: frame} of the kept frames and the
    last, next k)."""
    span = span or (lambda name: nullcontext())
    ends, issue_s, kept = [], [], {}
    last = None
    clock.sync()
    with span(tr.WINDOW_SPAN):
        start = clock.record()
        t_begin = time.perf_counter()
        k = k0
        while True:
            if len(ends) >= in_flight:
                with span("bench.wait"):
                    clock.wait(ends[-in_flight])
            if time.perf_counter() - t_begin >= seconds:
                break
            t0 = time.perf_counter()
            with span("bench.issue"):
                frame = render(k)
            issue_s.append(time.perf_counter() - t0)
            ends.append(clock.record())
            if k in keep:
                kept[k] = frame
            last = (k, frame)
            k += 1
        clock.sync()
    if last is not None:
        kept[last[0]] = last[1]
    return [clock.ms(start, e) for e in ends], issue_s, kept, k


# ---- correctness -------------------------------------------------------------


def numbers(frame: torch.Tensor, ref: torch.Tensor) -> dict:
    """A packed frame against its reference: the share of pixels whose word
    differs (neq_pct) and whose largest channel gap, alpha included, is
    over one level (off1_pct), in percent."""
    f = frame.reshape(ref.shape).contiguous()
    a = f.view(torch.uint8).view(*f.shape, 4).to(torch.int16)
    b = ref.contiguous().view(torch.uint8).view(*ref.shape, 4).to(torch.int16)
    off = (a - b).abs().amax(-1)
    return {"neq_pct": 100.0 * (f != ref).double().mean().item(),
            "off1_pct": 100.0 * (off > 1).double().mean().item()}


def check(cell: Cell, kept: dict, star_seed: int, device) -> tuple[dict, int, list]:
    """Hold each kept frame against the plain reference of its camera ->
    (the worst reading of each number the cell's limits name, the frames
    over a limit, the reference's ray-steps of each frame or None)."""
    ref = reference_module(cell)
    worst = {n: 0.0 for n in cell.limits["numbers"]}
    failed, ray_steps = 0, []
    for k in sorted(kept):
        cam = orbit_camera(k, cell.config["camera"])
        want, steps = ref.render(cell, cam, seed=star_seed, device=device)
        got = numbers(kept[k].to(want.device), want)
        over = False
        for n, spec in cell.limits["numbers"].items():
            worst[n] = max(worst[n], got[n])
            over |= got[n] > spec["limit"]
        failed += over
        ray_steps.append(None if steps is None else int(steps.sum().item()))
        del want, steps
    return worst, failed, ray_steps


# ---- one run -----------------------------------------------------------------


def jax_loaded(modules=None) -> list[str]:
    """The top-level names among the loaded modules (sys.modules) that are
    JAX's or the JAX package's, compared whole: the port's own name,
    bhr_tpu_torch, begins with the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & JAX_NAMES)


def power_limit_w():
    """The card's power limit from nvidia-smi, or None where it cannot be
    read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", wrap=None) -> dict:
    """One run of `cell` -> the result object that run.py prints. `wrap`
    (tests only) takes (render, k) and stands between the window and the
    program."""
    device = torch.device(device)
    t = cell.traffic
    s = seeded(cell, seed)
    k0 = s["phase"]
    in_flight = int(t["frames_in_flight"])
    setup = tr.HostSpans() if trace else None
    with setup_phase(setup, "bench.build"):
        anim, render = build_program(cell, s["star_seed"], device)
    if wrap is not None:
        program = render

        def render(k):
            return wrap(program, k)

    clock = Clock(device)
    # warm-up: every shape the window uses, with as many frames alive at
    # once as the window holds (those in flight, the one being issued, the
    # kept ones), so that the allocator's cache already holds their blocks
    # and the window never waits on cudaMalloc
    alive = in_flight + 2 + t["compare_frames"]
    with setup_phase(setup, "bench.warmup"):
        warm = [render(k) for k in range(k0, k0 + max(t["warmup_frames"], alive))]
        clock.sync()
    del warm
    if trace:
        # the program's set-up spans, in seconds from the start of the build
        # (spans of an earlier import in the process fall outside it)
        (_, b0, _), (_, _, w1) = setup.spans
        setup_spans = sp.relative(recorder().drain(), b0, w1)
        setup_host = [(n, (a - b0) * 1e-9, (b - b0) * 1e-9) for n, a, b in setup.spans]
    if trace and clock.cuda:  # the profiler's first session starts CUPTI: set-up
        with profile():
            render(k0)
            clock.sync()
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    keep = {k0 + j for j in s["sample"]}
    setup_s = time.perf_counter() - t_start
    dev_extra, brk, records = {}, None, None
    if not trace:
        end_ms, issue_s, kept, k_next = run_window(render, clock, seconds, in_flight, k0, keep)
        frame_ms, p95 = frame_stats(end_ms)
        attempted = len(end_ms)
        measured = {"frame_ms": frame_ms, "frame_ms_p95": p95, "setup_s": setup_s}
        # a metric split by cells ("frame_ms.neural") is its base quantity
        values = {m["name"]: measured[m["name"].split(".")[0]] for m in cell.end_to_end}
    else:
        # the host's issue time from an untraced first half; the device's
        # work from a traced second half
        end_ms, issue_s, kept, k_next = run_window(render, clock, seconds / 2, in_flight, k0,
                                                   keep)
        attempted = len(end_ms)
        spans = tr.HostSpans()
        prof = profile()
        with prof, recorder().recording():
            end2, _, kept2, _ = run_window(render, clock, seconds / 2, in_flight, k_next, keep,
                                           span=spans)
        program = recorder().drain()
        kept.update(kept2)
        attempted += len(end2)
        dev, host = tr.collect(prof)
        del prof
        host += spans.spans
        program = sp.relative(program, *tr.window(host))
        dev, host, window_s = tr.in_window(dev, host)
        launched = tr.launched_by(dev, host, program)
        dev, host = [d[:3] for d in dev], [h[:3] for h in host]
        frame_ms2, _ = frame_stats(end2)
        records = dict(kernels=dev, host=host, window_s=window_s, frames=len(end2),
                       frame_interval_ms=frame_ms2, issue_ms=[x * 1e3 for x in issue_s],
                       spans=program, launched_by=launched, setup_spans=setup_spans,
                       setup_host=setup_host)
        dev_extra = {"busy_s": tr.busy_s(dev), "window_s": window_s}
        brk = tr.breakdown(dev, host, window_s, program=program)
    peak = torch.cuda.max_memory_allocated(device) if clock.cuda else 0
    # free the program's state before the reference runs
    del anim, render, end_ms, issue_s
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    worst, failed, ray_steps = check(cell, kept, s["star_seed"], device)
    if trace:
        steps = [x for x in ray_steps if x is not None]
        records.update(ray_steps=sum(steps) / len(steps) if steps else None,
                       config=cell.config, traffic=cell.traffic, counts=cell.counts,
                       pixels=cell.config["scene"]["width"] * cell.config["scene"]["height"],
                       net=_net_shapes(cell))
        rec = type("Records", (), records)
        values = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(rec)
            if v is not None:
                values[m["name"]] = v
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result_metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items() if n in units}
    correct = failed == 0 and len(kept) > 0 and all(
        worst[n] <= spec["limit"] for n, spec in cell.limits["numbers"].items())
    out = {
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": result_metrics,
        "device": {"platform": "gpu" if clock.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if clock.cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak), **dev_extra,
                   "power_limit_w": power_limit_w() if clock.cuda else None},
    }
    if brk is not None:
        out["breakdown"] = brk
    out["frames_compared"] = sorted(kept)
    out["ray_steps"] = ray_steps
    out["checks"] = {n: {"value": worst[n], "limit": spec["limit"]}
                     for n, spec in cell.limits["numbers"].items()}
    return out


def asset_path(cell: Cell) -> Path:
    """The traffic's net, in the benchmark's own copy, checked against the
    digest the traffic pins."""
    path = BENCH_DIR / cell.traffic["asset"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cell.traffic["asset_sha256"]:
        raise ValueError(f"{path} has sha256 {digest}, the traffic pins "
                         f"{cell.traffic['asset_sha256']}")
    return path


def _net_shapes(cell: Cell):
    """(in, out) of each layer of the traffic's net, read from the
    benchmark's copy; None without one."""
    if "asset" not in cell.traffic:
        return None
    from .reference.neural_schwarzschild import load_net

    return [w.shape for w, _ in load_net(asset_path(cell))]
