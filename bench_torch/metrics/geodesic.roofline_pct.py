"""geodesic.roofline_pct: the least time the card could take for the
geodesic kernel's work a frame, over that kernel's device time a frame,
in percent. The least time is the larger of (ray-steps x operations a
step) at the fp32 peak and the bytes the kernel writes at the memory
peak. Ray-steps are the plain reference's, over the frames the run
compared; operations a step the tier-independent count of
counts/ops_per_step.json; peaks counts/peaks.json."""

GEODESIC = ("render_mono_kernel", "trace_planes_kernel")


def read(rec):
    ops = [(n, b - a) for n, a, b in rec.kernels if any(g in n for g in GEODESIC)]
    if not ops or not rec.ray_steps or rec.frames <= 0:
        return None
    r = rec.config["renderer"]
    key = ".".join([r["model"], r["integrator"]] + (["adaptive"] if r["adaptive"] else [])
                   + (["disk"] if r["disk"] else []))
    peaks = rec.counts["peaks"]
    t_ops = rec.ray_steps * rec.counts["ops_per_step"]["counts"][key] / peaks["fp32_flops_per_s"]
    bpp = max(v for k, v in rec.counts["bytes_per_pixel"]["counts"].items()
              if any(k in n for n, _ in ops))
    t_bytes = rec.pixels * bpp / peaks["hbm_bytes_per_s"]
    device_s = sum(d for _, d in ops) / rec.frames
    return 100.0 * max(t_ops, t_bytes) / device_s
