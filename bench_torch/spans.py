"""Reading the program's spans: self times, the innermost span open at a
time, the outermost set-up spans and the host stage of a span name.

A span here is a plain tuple (name, start, end, parent, frame): `parent`
is the index, in the same list, of the span that encloses it, or None;
`frame` the frame index the program was rendering, or None. The harness
turns the program's recorded spans (bhr_tpu_torch.utils.tracing) into such
tuples, in seconds from the start of a window, so that this module and the
metric readers need nothing of the program.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

STAGES = {"host.frames": "frames", "host.camera": "camera", "host.params": "params",
          "host.params.ks": "params", "epilogue": "epilogue", "epilogue.background": "epilogue",
          "gc": "gc"}


def stage(name: str) -> str:
    """The host stage of a span name: camera, params (host.params and its
    host.params.ks), launch (kernel.*: a wrapper's checks and its ctypes
    call), epilogue (epilogue and epilogue.background), frames (the frame
    call's own time), gc or setup; any other name is its own stage."""
    if name.startswith("kernel."):
        return "launch"
    if name.startswith("setup."):
        return "setup"
    return STAGES.get(name, name)


def relative(spans, t0: int, t1: int) -> list[tuple]:
    """The spans (name, start_ns, end_ns, parent, frame) that overlap
    [t0, t1), clipped to it, in seconds from t0; each parent an index into
    the list returned (None where the enclosing span was left out)."""
    keep = [i for i, s in enumerate(spans) if s[2] > t0 and s[1] < t1]
    index = {i: j for j, i in enumerate(keep)}
    out = []
    for i in keep:
        name, a, b, parent, frame = spans[i]
        out.append((name, (max(a, t0) - t0) * 1e-9, (min(b, t1) - t0) * 1e-9,
                    index.get(parent), frame))
    return out


def self_times(spans) -> list:
    """Each span's self time: its duration less the part of it that its
    children (the spans whose parent it is) cover."""
    children = defaultdict(list)
    for s in spans:
        if s[3] is not None:
            children[s[3]].append((s[1], s[2]))
    out = []
    for i, (_, start, end, _, _) in enumerate(spans):
        covered, t = 0, start
        for a, b in sorted(children.get(i, ())):
            a, b = max(a, t), min(b, end)
            if b > a:
                covered += b - a
                t = b
        out.append(end - start - covered)
    return out


def stage_ms(spans, n_frames: int) -> dict:
    """The self time a frame, in ms, of each stage of `spans` (times in
    seconds); a stage whose spans never ran is absent."""
    out = defaultdict(float)
    for s, own in zip(spans, self_times(spans)):
        out[stage(s[0])] += own * 1e3 / n_frames
    return dict(out)


def outer_setup(spans) -> list:
    """The outermost setup.* spans: those with no setup.* span among their
    ancestors."""
    def outer(s):
        p = s[3]
        while p is not None:
            if spans[p][0].startswith("setup."):
                return False
            p = spans[p][3]
        return True

    return [s for s in spans if s[0].startswith("setup.") and outer(s)]


class Innermost:
    """The innermost span open at a time (None outside every span), by
    bisection among the spans' starts: spans nest, so the latest-started
    one still open at t is the innermost."""

    def __init__(self, spans, lookback: int = 64):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]
        self.lookback = lookback

    def at(self, t):
        i = bisect.bisect_right(self.starts, t)
        for s in reversed(self.spans[max(0, i - self.lookback):i]):
            if s[2] > t:
                return s
        return None
