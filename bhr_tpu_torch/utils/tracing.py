"""The program's spans and counters: the one recorder of the package.

A span is `Span(name, start_ns, end_ns, parent, frame)`, timed by
time.time_ns(), the clock that torch.profiler's Kineto timestamps follow,
so the spans and a CUDA trace of the same run share one time line.
`parent` is the index, in the list `drain()` returns, of the enclosing span
(the one that caused it), or None; `frame` is the frame index that
PathAnimator.render_frames is rendering, or None outside its frame loop.

    from bhr_tpu_torch.utils import tracing

    with tracing.recording():
        anim.render_frames(4, packed=True)
    spans = tracing.drain()

Spans are recorded only inside `recording()`. Outside it, `span(name)`
tests one module flag and returns a shared null context: it allocates,
synchronizes and launches nothing. Spans sit at stage boundaries, about
ten a frame, never in a loop that runs per tensor op, pixel or step. The
package's import ("setup.import") is recorded always, since nothing can
switch recording on before it. While recording, a gc.callbacks hook
records each collection as a span "gc".

The span names:
  host.frames           PathAnimator.render_frames, the whole call
  host.camera           the frame times and each frame's camera_fn(t)
  host.params           the kernels' parameter vector and MLP descriptor
  host.params.ks        its exact Kerr capture radius, 1.05 r_+ (when built)
  kernel.render_mono    the wrappers, from entry through the ctypes
  kernel.trace_planes   call (on a CPU device, their plain versions)
  kernel.neural_mlp
  kernel.shade_planes   ops/shade_kernel.shade_planes, inside `epilogue`
  epilogue              renderer.shade_image, BlackHoleRenderer.disk_params
  epilogue.background   the background's colours in shade_planes_packed
                        (the plain epilogue only)
  setup.import          the package's import
  setup.load            each ctypes library's build check, CDLL and signatures
  setup.build           utils/build.build: the hash check, and nvcc...
  setup.nvcc            ...when it compiles
  setup.neural_prepare  the neural kernel's operands prepared on the device
  setup.disk_lut        the fast kernel's blackbody table copied to the device
  setup.plugin          BlackHoleRenderer(custom_physics=): the plugin loaded
                        and, for a CUDA device, recorded into CUDA source
  gc                    a collection of the garbage collector

COUNTS counts at all times, recording or not. Each launch key is incremented by
a kernel's wrapper right after a successful launch, and nowhere else:
  launch.render_mono              render_packed; of those, exact Kerr
  launch.render_mono.ks           (the Kerr-Schild loop, .ks), and of
  launch.render_mono.ks.fast      those the fast tier's (.ks.fast)
  launch.trace_planes             trace_image; of those, with stride != 1
  launch.trace_planes.strided     (.strided), with a mask (.masked), with
  launch.trace_planes.masked      plugin physics (.custom) and exact Kerr
  launch.trace_planes.custom      (.ks), and of the last the fast tier's
  launch.trace_planes.ks          (.ks.fast); and those that run an
  launch.trace_planes.ks.fast     instantiation with its flags fixed at
  launch.trace_planes.fixed       compile time (.fixed: Euler with no flag,
                                  exact rk4 with adaptive dt and the disk,
                                  exact Euler with the Kerr-Schild loop and
                                  the disk)
  launch.neural_mlp               neural_render_packed; of those, bands
  launch.neural_mlp.band
  launch.neural_mlp.dirs          neural_trace_dirs
  launch.neural_mlp.kerr          of the launches of either, a Kerr net's
  launch.neural_mlp.streamed      (.kerr), and those of the streamed
                                  layout (.streamed: kernel_plan's
                                  STREAMED_PLAN, neural_fused_kernel_ws,
                                  warpgroups on wgmma)
  launch.shade_planes             ops/shade_kernel.shade_planes
  launch.probe_<kernel><variant>  tools/hopper_probe.py's kernels
and one key counts a route taken, not a launch:
  epilogue.plain                  renderer.shade_image, for each frame on a
                                  CUDA device that takes the plain epilogue
and one the recordings of a physics plugin into the kernel's source:
  plugin.records                  utils/plugin.record; once a plugin
                                  function a process (utils/plugin.program)
and two the kernels' parameter block, its part other than the camera:
  host.params.built               ops/trace_kernel._kernel_params, each time
  host.params.reused              it is computed, and each time it is reused
launch.shade_planes over the sum of the two is the kernel's share of the
staged frames shaded on a card; host.params.reused over the sum of the
last two is the block's hit share, (F - 1) / F over F frames of one scene.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import threading
import time

Span = collections.namedtuple("Span", "name start_ns end_ns parent frame")

COUNTS: collections.Counter = collections.Counter()

_on = False
_frame = None
_ids = itertools.count()
_local = threading.local()  # .stack: the ids of this thread's open spans
# finished spans since the last drain: (id, name, start_ns, end_ns, parent id, frame)
_records: list = []


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "frame", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.frame = _frame
        stack.append(self.id)
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _stack().pop()
        _records.append((self.id, self.name, self.t0, t1, self.parent, self.frame))
        return False


def span(name: str):
    """A context that records the span `name` while recording, else the
    shared null context."""
    if not _on:
        return _NULL
    return _Span(name)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span that has already ended, under the innermost open span
    of this thread."""
    stack = _stack()
    _records.append((next(_ids), name, start_ns, end_ns, stack[-1] if stack else None, _frame))


def set_frame(index) -> None:
    """The frame index that later spans carry (None: outside a frame)."""
    global _frame
    _frame = index


_gc_start: list = []


def _gc_callback(phase: str, info) -> None:
    if phase == "start":
        _gc_start.append(time.time_ns())
    elif _gc_start:
        record("gc", _gc_start.pop(), time.time_ns())


@contextlib.contextmanager
def recording():
    """Record spans, and the collector's pauses, inside the block. A
    `recording()` inside another records as the outer one does."""
    global _on
    if _on:
        yield
        return
    _on = True
    gc.callbacks.append(_gc_callback)
    try:
        yield
    finally:
        gc.callbacks.remove(_gc_callback)
        _gc_start.clear()
        _on = False


def drain() -> list[Span]:
    """The spans finished since the last drain, in order of their start,
    each `parent` an index into this list (None where the enclosing span
    had not ended or was drained before); the recorder keeps none."""
    global _records
    recs, _records = _records, []
    recs.sort(key=lambda r: (r[2], r[0]))
    index = {r[0]: i for i, r in enumerate(recs)}
    return [Span(name, t0, t1, index.get(parent), frame)
            for _, name, t0, t1, parent, frame in recs]


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's self time: its duration less the part of it that its
    children (the spans whose parent it is) cover."""
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for i, s in enumerate(spans):
        covered, t = 0, s.start_ns
        for a, b in sorted(children.get(i, ())):
            a, b = max(a, t), min(b, s.end_ns)
            if b > a:
                covered += b - a
                t = b
        out.append(s.end_ns - s.start_ns - covered)
    return out
