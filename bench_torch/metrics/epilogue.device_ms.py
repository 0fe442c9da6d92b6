"""epilogue.device_ms: device time a frame of every operation except the
geodesic kernel (render_mono_kernel, trace_planes_kernel): in a staged
frame the epilogue (renderer.shade_image: one shade_planes_kernel for a
star-field frame, else the plain epilogue's ops/shading, ops/starfield)
and disk_params' fills of the per-frame scalars, which it counts too.
epilogue.shade_kernel_device_ms reads the shading kernel alone. Nothing
to read where no geodesic kernel ran or nothing else did."""

GEODESIC = ("render_mono_kernel", "trace_planes_kernel")


def read(rec):
    if rec.frames <= 0 or not any(any(g in n for g in GEODESIC) for n, _, _ in rec.kernels):
        return None
    rest = [b - a for n, a, b in rec.kernels if not any(g in n for g in GEODESIC)]
    if not rest:
        return None
    return 1e3 * sum(rest) / rec.frames
