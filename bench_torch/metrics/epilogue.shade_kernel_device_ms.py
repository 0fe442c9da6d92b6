"""epilogue.shade_kernel_device_ms: device time a traced frame of the
operations launched inside the program's span kernel.shade_planes (the
staged epilogue's one shading kernel: star field, disk and quantizer),
tied to their runtime calls by the trace's correlation ids
(rec.launched_by). disk_params' fills, which epilogue.device_ms counts
too, are not in it. Nothing to read where the kernel never ran."""


def read(rec):
    if rec.frames <= 0:
        return None
    ops = [b - a for (_, a, b), by in zip(rec.kernels, rec.launched_by)
           if by == "kernel.shade_planes"]
    return 1e3 * sum(ops) / rec.frames if ops else None
