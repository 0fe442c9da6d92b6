"""Device timing: the analog of wgpu timestamp queries (PyTorch port of
bhr_tpu/utils/timing.py; reference: src/main.rs:510-531, 887-921,
src/lib.rs:569-577).

On a CUDA device a `TimestampQuery` records a CUDA event on the current
stream where the frame's work begins and another where it ends, so
`gpu_time_ms` is device time and recording it adds no host sync: the
query waits for its end event only when `gpu_time_ms` is read. On the CPU
(the device the caller named) it keeps bhr_tpu's host bracket. `time_fn`
is a median by CUDA events after warm-up, `device_time_ms` the device
time of work shorter than its host-side issue, `calibrate_dispatch_overhead_ms`
the launch-to-completion cost of a trivial kernel, and `profiler_trace`
wraps torch.profiler.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


def _device(device) -> torch.device:
    """The named device; none named is the card (the port's default)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device timing on 'cuda' needs a CUDA device, and none is "
                           "available; name device='cpu' for the host bracket")
    return device


class TimestampQuery:
    """Populated by BlackHoleRenderer.render_frame(..., timestamp_query=q).

    `begin(device)` and `end()` bracket the frame's work; the renderer
    passes its own device. On CUDA, `gpu_time_ms` is the time between the
    two events on the device and reading it waits for the end event; on
    the CPU it is the host bracket. `overhead_ms` (e.g. from
    `calibrate_dispatch_overhead_ms`) is subtracted from the bracket,
    floored at 0, as in bhr_tpu. None until a bracket has ended.
    """

    def __init__(self, overhead_ms: float = 0.0, device=None):
        self.overhead_ms = float(overhead_ms)
        self.device = device
        self._events = None
        self._t0: float | None = None
        self._pending = False
        self._ms: float | None = None

    def begin(self, device=None) -> None:
        dev = _device(device if device is not None else self.device)
        self._pending = False
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
            self._t0 = None
        else:
            self._events = None
            self._t0 = time.perf_counter()

    def end(self) -> None:
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._events[0].device))
            self._pending = True
        elif self._t0 is not None:
            self._ms = self._floor((time.perf_counter() - self._t0) * 1000.0)

    def _floor(self, bracket_ms: float) -> float:
        return max(bracket_ms - self.overhead_ms, 0.0)

    @property
    def gpu_time_ms(self) -> float | None:
        if self._pending:
            start, stop = self._events
            stop.synchronize()
            self._ms = self._floor(start.elapsed_time(stop))
            self._pending = False
        return self._ms


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_dispatch_overhead_ms(reps: int = 5, device=None) -> float:
    """Median host time from launching a trivial kernel (x * 2 + 1 on one
    float) to its completion: the fixed per-dispatch cost that a host
    bracket adds to device time. On the CPU, the same op's host time."""
    dev = _device(device)
    x = torch.full((1,), 0.5, device=dev)
    _sync(dev)
    x * 2.0 + 1.0  # warm-up: the first launch loads the kernel
    _sync(dev)
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        x * 2.0 + 1.0
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def time_fn(fn, *args, warmup: int = 3, iters: int = 10, device=None) -> float:
    """Median time (ms) of one call fn(*args) after `warmup` calls. On CUDA
    (the device of the first tensor argument, else `device`, else the
    card) each call is bracketed by CUDA events on the current stream; on
    the CPU by the host clock."""
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    dev = _device(device)
    for _ in range(warmup):
        fn(*args)
    times = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            pairs = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                stop.record()
                pairs.append((start, stop))
            torch.cuda.synchronize(dev)
            times = [a.elapsed_time(b) for a, b in pairs]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


_SPIN_CYCLES_PER_MS: dict = {}


def _spin_cycles_per_ms(device: torch.device) -> float:
    """Cycles of torch.cuda._sleep the card spins through in a millisecond,
    measured once per device."""
    if device not in _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        stop.record()
        stop.synchronize()
        _SPIN_CYCLES_PER_MS[device] = cycles / start.elapsed_time(stop)
    return _SPIN_CYCLES_PER_MS[device]


def device_time_ms(fn, *args, iters: int = 20, repeats: int = 3, device=None) -> float:
    """Median device time (ms) of one call fn(*args) on CUDA, for work
    shorter than the host's issue of it, where time_fn would time the host:
    `iters` calls are enqueued behind a spin kernel (torch.cuda._sleep) that
    outlasts their issue, so the device runs them back to back and the
    events around them time the device alone; the median over `repeats`
    batches. Fewer calls a batch where one takes the host over 10 ms."""
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    dev = _device(device)
    if dev.type != "cuda":
        raise ValueError("device_time_ms times a CUDA device; use time_fn on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.device(dev):
        fn(*args)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(*args)
        issue_ms = (time.perf_counter() - t0) * 1000.0
        torch.cuda.synchronize(dev)
        n = max(1, min(iters, int(200.0 / max(issue_ms, 1e-3))))
        spin = int(_spin_cycles_per_ms(dev) * (1.5 * n * issue_ms + 1.0))
        runs = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(n):
                fn(*args)
            stop.record()
            stop.synchronize()
            runs.append(start.elapsed_time(stop) / n)
    return statistics.median(runs)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler over the block (the CPU, and the card where there is
    one); the Chrome trace is written to `logdir`/trace.json on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
