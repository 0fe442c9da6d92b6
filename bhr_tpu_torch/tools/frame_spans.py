"""Where a frame's host issue and the program's setup go: the program's
spans (utils/tracing) read against a CUDA trace of the benchmark's window.

    python3 bhr_tpu_torch/tools/frame_spans.py --workload rk4disk1080.orbit_exact \\
        --seed 7 --seconds 4 --pairs 3 [--out FILE]

From the root of a checkout, on a machine with a CUDA device. Like
bench_torch/run.py, it imports torch before the program. It builds the
benchmark cell's program as bench_torch/harness.py does, with recording on
through the build and the warm-up, then runs `pairs` triples of traced
windows of the harness's closed frame loop (torch.profiler, CUDA activity
only): one with recording off and one with it on, in alternating order,
then one that records every odd frame. It prints one JSON line a window
and one for the run:

- every window: the mean host issue of a frame (the harness's span
  "bench.issue"), the frame interval, and the harness's per-layer metrics
  that need no plain reference (device.idle_pct, neural.mfu_pct, ...);
- a window with recording on, besides: the self time a frame of each host
  stage (camera, params, launch, epilogue, the frame call's own, gc), the
  device time a frame of the operations launched inside
  "epilogue.background" (tied to their runtime calls by the trace's
  correlation ids) and, apart, of the kernel launched inside
  "kernel.shade_planes" (each None where its span never ran), how
  much of the issue the "host.frames" spans cover, the share of the
  cudaLaunchKernel calls inside a program span, the idle gaps named by the
  innermost program span open when each began, and the frames whose issue
  stalled, with the label that took the extra time;
- the run: the seconds of the outermost setup.* spans (`setup_program_s`,
  the package's import included, and by name) beside the run's own set-up
  time, and the on cost of recording: the mean issue of the windows with
  recording on less that of those with it off, and in each alternating
  window the mean issue of its recorded frames less that of the others
  (`on_cost_paired_ms`; the toggle itself counts with the recorded).

Host times in the traced windows include CUPTI's cost a runtime call.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":  # run as a script: the checkout's packages
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402,F401  (before the program: its import is not the program's)

from bhr_tpu_torch.utils import tracing  # noqa: E402

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
STAGES = {"host.frames": "frames", "host.camera": "camera", "host.params": "params",
          "epilogue": "epilogue", "epilogue.background": "epilogue", "gc": "gc"}
STALL = 1.25  # a frame whose issue is over STALL x the median issue stalled


def stage(name: str) -> str:
    """The host stage of a span name: camera, params, launch (kernel.*),
    epilogue, frames (host.frames' own time), gc or setup."""
    if name.startswith("kernel."):
        return "launch"
    if name.startswith("setup."):
        return "setup"
    return STAGES.get(name, name)


def stage_ms(spans, n_frames: int) -> dict:
    """The self time a frame, in ms, of each stage of `spans`."""
    out = collections.defaultdict(float)
    for s, own in zip(spans, tracing.self_ns(spans)):
        out[stage(s.name)] += own * 1e-6 / n_frames
    return dict(out)


def outer_setup(spans) -> list:
    """The outermost setup.* spans: those with no setup.* span among their
    ancestors."""
    def outer(s):
        p = s.parent
        while p is not None:
            if spans[p].name.startswith("setup."):
                return False
            p = spans[p].parent
        return True

    return [s for s in spans if s.name.startswith("setup.") and outer(s)]


def setup_program_s(spans) -> float:
    """The summed seconds of the outermost setup.* spans."""
    return sum(s.end_ns - s.start_ns for s in outer_setup(spans)) * 1e-9


class Innermost:
    """The innermost program span open at a time (None outside every span),
    by bisection among the spans' starts: spans nest, so the latest-started
    one still open at t is the innermost."""

    def __init__(self, spans, lookback: int = 64):
        self.spans = sorted(spans, key=lambda s: s.start_ns)
        self.starts = [s.start_ns for s in self.spans]
        self.lookback = lookback

    def at(self, t: int):
        i = bisect.bisect_right(self.starts, t)
        for s in reversed(self.spans[max(0, i - self.lookback):i]):
            if s.end_ns > t:
                return s
        return None


def coverage(spans, issue) -> dict:
    """How much of the harness's issue spans (name, t0, t1) the host.frames
    spans cover, and the share of host.frames that no stage below it
    accounts for (its self time)."""
    own = tracing.self_ns(spans)
    frames = [(s, o) for s, o in zip(spans, own) if s.name == "host.frames"]
    issued = sum(b - a for _, a, b in issue)
    dur = sum(s.end_ns - s.start_ns for s, _ in frames)
    return {"frames_over_issue": dur / issued if issued else None,
            "frames_self_share": sum(o for _, o in frames) / dur if dur else None}


def clock(host, where: Innermost) -> dict:
    """The share of the launch calls inside a program span, and the largest
    distance in us from an outside one to the nearest span."""
    calls = [h for h in host if h[0].startswith(LAUNCH_CALLS)]
    outside = [h for h in calls if where.at(h[1]) is None]
    edges = sorted(t for s in where.spans for t in (s.start_ns, s.end_ns))

    def gap(t):
        i = bisect.bisect_left(edges, t)
        return min(abs(t - edges[j]) for j in (i - 1, i) if 0 <= j < len(edges))

    return {"launch_calls": len(calls),
            "inside_share": 1.0 - len(outside) / len(calls) if calls else None,
            "largest_offset_us": max((gap(h[1]) * 1e-3 for h in outside), default=0.0)
            if edges else None}


def launched_by(host, where: Innermost) -> dict:
    """correlation id -> the name of the innermost program span open when
    its runtime call began, for the calls inside a span."""
    out = {}
    for name, a, _, corr in host:
        s = where.at(a)
        if s is not None and corr:
            out[corr] = s.name
    return out


def device_ms_in(span_name: str, device, host, where: Innermost, n_frames: int):
    """Device time a frame, in ms, of the operations whose runtime call
    began inside the span `span_name` (innermost); None without any."""
    by = launched_by(host, where)
    ns = [b - a for _, a, b, corr in device if by.get(corr) == span_name]
    return sum(ns) * 1e-6 / n_frames if ns else None


def epilogue_device_ms(device, host, where: Innermost, n_frames: int) -> dict:
    """Device time a frame, in ms, of the epilogue's two routes, each None
    where its span never ran: `background_device_ms`, the ops launched
    inside "epilogue.background" (the plain epilogue's star field or
    texture), and `shade_kernel_device_ms`, the kernel launched inside
    "kernel.shade_planes" (star field, disk and quantizer in one)."""
    return {"background_device_ms": device_ms_in("epilogue.background", device, host, where,
                                                 n_frames),
            "shade_kernel_device_ms": device_ms_in("kernel.shade_planes", device, host, where,
                                                   n_frames)}


def doing(t: int, bench: Innermost, where: Innermost, calls: Innermost) -> str:
    """The host at t: the harness's span, the innermost program span and the
    runtime call open then."""
    parts = [x.name for x in (bench.at(t), where.at(t), calls.at(t)) if x is not None]
    return " > ".join(parts) or "host idle"


def idle_gaps(ops, window_s: float, label, top: int = 10) -> list:
    """The device's idle time in seconds by what the host was doing when
    each gap began (label(t)), the largest first; `ops` are (name, start,
    end) in seconds from the window's start, as bench_torch/trace.py keeps
    them."""
    from bench_torch import trace as tr

    by = collections.defaultdict(float)
    for a, b in tr.gaps(ops, window_s):
        by[label(a)] += b - a
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def frame_labels(issue, spans, host) -> list[dict]:
    """For each issue span (name, t0, t1): ns by label, where a runtime call
    counts as "<innermost span> > <call>" and the rest of a span's self
    time as its name; time in no program span is "outside"."""
    where = Innermost(spans)
    own = tracing.self_ns(spans)
    span_starts = [s.start_ns for s in spans]  # drain() keeps them in order of start
    calls = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in calls]
    out = []
    for _, a, b in issue:
        lab = collections.defaultdict(int)
        inside = [i for i in range(bisect.bisect_left(span_starts, a),
                                   bisect.bisect_right(span_starts, b)) if spans[i].end_ns <= b]
        for i in inside:
            lab[spans[i].name] += own[i]
        lab["outside"] += (b - a) - sum(spans[i].end_ns - spans[i].start_ns for i in inside
                                        if spans[i].name == "host.frames")
        for name, c0, c1, _ in calls[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]:
            s = where.at(c0)
            key = s.name if s is not None else "outside"
            lab[f"{key} > {name}"] += c1 - c0
            lab[key] -= c1 - c0
        out.append(dict(lab))
    return out


def stalls(issue, spans, host) -> dict:
    """The frames whose issue took over STALL x the median, and for each
    label (frame_labels) how many of them it took the most extra time in,
    and how much extra in all (ms), against its median over the frames."""
    if not issue:
        return {}
    dur = [b - a for _, a, b in issue]
    med = statistics.median(dur)
    labels = frame_labels(issue, spans, host)
    keys = {k for d in labels for k in d}
    typical = {k: statistics.median(d.get(k, 0) for d in labels) for k in keys}
    count, extra = collections.Counter(), collections.defaultdict(float)
    stalled = [i for i, d in enumerate(dur) if d > STALL * med]
    for i in stalled:
        over = {k: labels[i].get(k, 0) - typical[k] for k in keys}
        k = max(over, key=over.get)
        count[k] += 1
        extra[k] += over[k] * 1e-6
    return {"frames": len(dur), "median_ms": med * 1e-6,
            "p99_ms": statistics.quantiles(dur, n=100)[-1] * 1e-6 if len(dur) > 1 else None,
            "max_ms": max(dur) * 1e-6,
            "stalled": len(stalled), "stalled_extra_ms": sum(dur[i] - med for i in stalled) * 1e-6,
            "by_label": {k: [count[k], extra[k]] for k in count}}


def kineto_events(prof):
    """(device ops, host events) of a finished torch.profiler.profile, each
    a list of (name, start_ns, end_ns, correlation id)."""
    from torch._C._autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        item = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return device, host


def analyse(bench_spans, device, host, spans, end_ms, readers, rec_base) -> dict:
    """One window's numbers (see the module's docstring)."""
    from bench_torch import harness
    from bench_torch import trace as tr

    _, w0, w1 = max((s for s in bench_spans if s[0] == tr.WINDOW_SPAN), key=lambda s: s[1])
    device = [d for d in device if d[2] > w0 and d[1] < w1]
    host = [h for h in host if h[2] > w0 and h[1] < w1]
    issue = [s for s in bench_spans if s[0] == "bench.issue"]
    n = len(issue)
    rel = [(nm, (max(a, w0) - w0) * 1e-9, (min(b, w1) - w0) * 1e-9) for nm, a, b, _ in device]
    frame_ms, _ = harness.frame_stats(end_ms)
    rec = types.SimpleNamespace(**rec_base, kernels=sorted(rel), window_s=(w1 - w0) * 1e-9,
                                frames=n, frame_interval_ms=frame_ms, host=[], issue_ms=[])
    out = {"frames": n, "issue_ms": statistics.fmean(b - a for _, a, b in issue) * 1e-6,
           "frame_interval_ms": frame_ms,
           "metrics": {k: v for k, r in readers.items() if (v := r(rec)) is not None}}
    if not spans:  # recording was off; else every span is the window's
        return out
    where = Innermost(spans)
    bench = Innermost([tracing.Span(nm, a, b, None, None) for nm, a, b in bench_spans
                       if nm != tr.WINDOW_SPAN])
    calls = Innermost([tracing.Span(nm, a, b, None, None) for nm, a, b, _ in host], 8)
    out.update(
        stage_ms=stage_ms(spans, n),
        **epilogue_device_ms(device, host, where, n),
        coverage=coverage(spans, issue), clock=clock(host, where),
        idle_gaps=idle_gaps(rel, rec.window_s,
                            lambda t: doing(w0 + round(t * 1e9), bench, where, calls)),
        stalls=stalls(issue, spans, host),
        gc=[sum(1 for s in spans if s.name == "gc"),
            sum(s.end_ns - s.start_ns for s in spans if s.name == "gc") * 1e-6])
    return out


def run(workload: str, seed: int, seconds: float, pairs: int, emit, device="cuda") -> dict:
    """The tool's run of one cell (see the module's docstring); `emit`
    takes each JSON line."""
    from bench_torch import harness
    from bench_torch import trace as tr

    cell = harness.load_cell(workload)
    s = harness.seeded(cell, seed)
    k = s["phase"]
    clock_ = harness.Clock(device)
    with tracing.recording():
        anim, render = harness.build_program(cell, s["star_seed"], torch.device(device))
        warm = [render(j) for j in range(k, k + cell.traffic["warmup_frames"] + 4)]
        clock_.sync()
    del warm
    setup_spans = tracing.drain()
    setup_s = time.perf_counter() - T_START
    cuda = clock_.cuda
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    if cuda:  # the profiler's first session starts CUPTI: set-up
        with torch.profiler.profile(activities=acts):
            render(k)
            clock_.sync()
    readers = {m["name"]: harness.metric_reader(m["name"]) for m in cell.per_layer
               if m["name"].split(".")[0] in ("device", "neural", "epilogue")}
    rec_base = dict(config=cell.config, traffic=cell.traffic, counts=cell.counts,
                    pixels=cell.config["scene"]["width"] * cell.config["scene"]["height"],
                    net=harness._net_shapes(cell), ray_steps=None)
    def alternate(j):  # every odd frame recorded, the toggle inside its issue
        if j % 2 == 0:
            return render(j)
        with tracing.recording():
            return render(j)

    issue, paired = {False: [], True: []}, []
    for i in range(3 * pairs):
        # off, on, alternate, on, off, alternate, ...
        kind = ("alternate" if i % 3 == 2 else
                ("off", "on")[(i % 3 == 1) != (i // 3 % 2 == 1)])
        bench = tr.HostSpans()
        prof = torch.profiler.profile(activities=acts) if cuda else contextlib.nullcontext()
        k0 = k
        with prof, (tracing.recording() if kind == "on" else contextlib.nullcontext()):
            end_ms, _, _, k = harness.run_window(
                alternate if kind == "alternate" else render, clock_, seconds,
                int(cell.traffic["frames_in_flight"]), k, set(), span=bench)
        spans = tracing.drain()
        device_ops, host = kineto_events(prof) if cuda else ([], [])
        del prof
        if kind == "alternate":
            ms = [[(b - a) * 1e-6 for j, (_, a, b) in enumerate(
                x for x in bench.spans if x[0] == "bench.issue") if (k0 + j) % 2 == odd]
                for odd in (0, 1)]
            line = {"workload": workload, "window": i, "recording": kind,
                    "issue_ms_off": statistics.fmean(ms[0]),
                    "issue_ms_on": statistics.fmean(ms[1])}
            paired.append(line["issue_ms_on"] - line["issue_ms_off"])
        else:
            line = {"workload": workload, "window": i, "recording": kind == "on",
                    **analyse(bench.spans, device_ops, host, spans, end_ms, readers,
                              rec_base)}
            issue[kind == "on"].append(line["issue_ms"])
        emit(line)
    cost = statistics.fmean(issue[True]) - statistics.fmean(issue[False])
    summary = {"workload": workload, "seed": seed, "setup_s": setup_s,
               "setup_program_s": setup_program_s(setup_spans),
               "setup_spans_s": {n: sum(s.end_ns - s.start_ns for s in outer_setup(setup_spans)
                                        if s.name == n) * 1e-9
                                 for n in {s.name for s in outer_setup(setup_spans)}},
               "nvcc_s": sum(s.end_ns - s.start_ns for s in setup_spans
                             if s.name == "setup.nvcc") * 1e-9,
               "issue_ms_off": issue[False], "issue_ms_on": issue[True], "on_cost_ms": cost,
               "on_cost_pct": 100.0 * cost / statistics.fmean(issue[False]),
               "on_cost_paired_ms": paired,
               "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    del anim, render
    emit(summary)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frame_spans: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if sink is not None:
            sink.write(text + "\n")
            sink.flush()

    try:
        run(args.workload, args.seed, args.seconds, args.pairs, emit)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
