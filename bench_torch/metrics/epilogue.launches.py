"""epilogue.launches: device operations (kernels, copies, fills) launched a
frame besides the geodesic kernel (render_mono_kernel,
trace_planes_kernel): in a staged frame, the epilogue's (one
shade_planes_kernel for a star-field frame) and disk_params' fills, which
it counts too (6 of 7 in a staged disk frame). Nothing to read where no
geodesic kernel ran or nothing else did."""

GEODESIC = ("render_mono_kernel", "trace_planes_kernel")


def read(rec):
    if rec.frames <= 0 or not any(any(g in n for g in GEODESIC) for n, _, _ in rec.kernels):
        return None
    rest = sum(1 for n, _, _ in rec.kernels if not any(g in n for g in GEODESIC))
    return rest / rec.frames if rest else None
