"""epilogue.device_ms: device time a frame of every operation except the
geodesic kernel (render_mono_kernel, trace_planes_kernel): in a staged
frame the plain epilogue (renderer.shade_image -> ops/shading,
ops/starfield) and the per-frame scalars it fills. Nothing to read where
no geodesic kernel ran or nothing else did."""

GEODESIC = ("render_mono_kernel", "trace_planes_kernel")


def read(rec):
    if rec.frames <= 0 or not any(any(g in n for g in GEODESIC) for n, _, _ in rec.kernels):
        return None
    rest = [b - a for n, a, b in rec.kernels if not any(g in n for g in GEODESIC)]
    if not rest:
        return None
    return 1e3 * sum(rest) / rec.frames
