"""Reading a torch.profiler trace of the window: the device operations, the
host's CUDA runtime calls and the benchmark's own host spans, the busy
union, the idle gaps named by what the host was doing, the program span
that launched each device operation, and the operations that took most
time.

The profiler traces CUDA activity alone: recording every host operator
costs the host microseconds an operator, which in a frame of a few hundred
operators makes the host, not the device, set the pace. The benchmark's
spans ("bench.window", "bench.issue", "bench.wait") are taken on the host
by time.time_ns(), the wall clock that the profiler's timestamps follow.
Times are seconds from the start of the traced window, the span
"bench.window", which encloses the issue of its first frame and the wait
for its last. The program's own spans (bench_torch/spans.py's tuples) come
in apart from the runtime calls, so that a span is never taken for a call.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

from .spans import Innermost

WINDOW_SPAN = "bench.window"


class HostSpans:
    """Named host spans, (name, start_ns, end_ns) by time.time_ns(); the
    instance is the `span` context factory of the window."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def collect(prof):
    """(device ops, host events) of a finished torch.profiler.profile, each
    a list of (name, start_ns, end_ns, correlation id), read from the raw
    Kineto events; user annotations, which the profiler also places on the
    device's timeline, are left out. A device operation shares its
    correlation id with the runtime call that launched it."""
    from torch._C._autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        item = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return device, host


def window(host):
    """(start_ns, end_ns) of the last "bench.window" span, or None."""
    spans = [h for h in host if h[0] == WINDOW_SPAN]
    if not spans:
        return None
    return max(spans, key=lambda h: h[1])[1:3]


def in_window(device, host):
    """The device ops and host events inside the last "bench.window" span,
    in seconds from its start, with the window's length; device ops are
    clipped to the window. Fields after an event's end (a correlation id)
    are kept."""
    bounds = window(host)
    if bounds is None:
        return [], [], 0.0
    w0, w1 = bounds

    def rel(t):
        return (t - w0) * 1e-9

    dev = sorted((n, rel(max(a, w0)), rel(min(b, w1)), *rest) for n, a, b, *rest in device
                 if b > w0 and a < w1)
    hst = sorted(((n, rel(a), rel(b), *rest) for n, a, b, *rest in host
                  if b > w0 and a < w1 and n != WINDOW_SPAN), key=lambda h: h[1])
    return dev, hst, rel(w1)


def launched_by(device, host, program) -> list:
    """For each device op (name, start, end, correlation id), in order, the
    name of the innermost program span open when the runtime call with its
    correlation id began, or None (no such call, or no span open then)."""
    began = {h[3]: h[1] for h in host if len(h) > 3 and h[3]}
    where = Innermost(program)
    out = []
    for d in device:
        t = began.get(d[3]) if d[3] else None
        s = where.at(t) if t is not None else None
        out.append(None if s is None else s[0])
    return out


def busy_intervals(ops):
    """The union of the ops' [start, end) intervals, merged, in order."""
    merged = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(ops) -> float:
    return sum(b - a for a, b in busy_intervals(ops))


def gaps(ops, window_s: float):
    """The idle intervals of the device inside [0, window_s)."""
    out, t = [], 0.0
    for a, b in busy_intervals(ops):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window_s > t:
        out.append((t, window_s))
    return out


class HostIndex:
    """What the host was doing at a time: the benchmark's span open then,
    the innermost of the program's spans (`program`, which nest) open then,
    and the CUDA runtime call open then; the benchmark's spans and the
    calls are each found by bisection among events that do not nest (one
    host thread issues them in turn)."""

    def __init__(self, host, program=()):
        self.spans = sorted((h for h in host if h[0].startswith("bench.")), key=lambda h: h[1])
        self.calls = sorted((h for h in host if not h[0].startswith("bench.")),
                            key=lambda h: h[1])
        self.span_starts = [h[1] for h in self.spans]
        self.call_starts = [h[1] for h in self.calls]
        self.program = Innermost(program)

    @staticmethod
    def _open(events, starts, t, lookback: int = 8):
        i = bisect.bisect_right(starts, t)
        for name, _, b in reversed(events[max(0, i - lookback):i]):
            if b > t:
                return name
        return None

    def doing(self, t: float) -> str:
        """"bench span > innermost program span > runtime call", of those
        open at t, or "host idle"."""
        span = self._open(self.spans, self.span_starts, t)
        inner = self.program.at(t)
        call = self._open(self.calls, self.call_starts, t)
        return " > ".join(x for x in (span, inner and inner[0], call) if x) or "host idle"


def breakdown(dev, host, window_s: float, top: int = 10, program=()) -> dict:
    """The device ops that took most time, and the idle time by what the
    host was doing when each gap began (HostIndex.doing); each a list of
    [name, seconds], at most `top` long."""
    by_op = defaultdict(float)
    for name, a, b in dev:
        by_op[name] += b - a
    index = HostIndex(host, program)
    by_host = defaultdict(float)
    for a, b in gaps(dev, window_s):
        by_host[index.doing(a)] += b - a

    def top_of(d):
        return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_host)}
