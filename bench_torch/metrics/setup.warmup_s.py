"""setup.warmup_s: the seconds of the benchmark's span bench.warmup, around
the warm-up frames and the sync after them (the first launches, the
operands prepared on the device, the allocator's blocks), on the host's
clock."""


def read(rec):
    return next((b - a for n, a, b in rec.setup_host if n == "bench.warmup"), None)
