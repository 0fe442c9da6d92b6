"""device.idle_pct: the share of the traced window in which no device
operation runs (one less the union of the profiler's device intervals over
the window), in percent."""

from bench_torch.trace import busy_s


def read(rec):
    if rec.window_s <= 0 or not rec.kernels:
        return None
    return 100.0 * (1.0 - busy_s(rec.kernels) / rec.window_s)
