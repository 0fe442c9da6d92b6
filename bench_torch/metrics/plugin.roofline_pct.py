"""plugin.roofline_pct: the least time the card could take for the plugin
kernel's work a frame, over that kernel's device time a frame, in percent.
The plugin kernel is trace_planes_kernel built with a physics plugin's
acceleration (the configuration's renderer.model "custom"). The least time
is the larger of (ray-steps x operations a step) at the fp32 peak and the
bytes the kernel writes at the memory peak. Ray-steps are the plain
reference's, over the frames the run compared; operations a step
counts/plugin_ops_per_step.json's, keyed by the plugin file's stem and the
integrator, which this reader loads itself; bytes and peaks the harness's
counts. Nothing to read in a cell without a plugin."""

import json
from pathlib import Path

KERNEL = "trace_planes_kernel"
OPS = Path(__file__).resolve().parents[1] / "counts" / "plugin_ops_per_step.json"


def read(rec):
    r = rec.config["renderer"]
    ops = [b - a for n, a, b in rec.kernels if KERNEL in n]
    if r.get("model") != "custom" or not ops or not rec.ray_steps or rec.frames <= 0:
        return None
    key = f"custom.{Path(r['custom_physics']).stem}.{r['integrator']}"
    per_step = json.loads(OPS.read_text())["counts"][key]
    peaks = rec.counts["peaks"]
    t_ops = rec.ray_steps * per_step / peaks["fp32_flops_per_s"]
    bpp = rec.counts["bytes_per_pixel"]["counts"][KERNEL]
    t_bytes = rec.pixels * bpp / peaks["hbm_bytes_per_s"]
    return 100.0 * max(t_ops, t_bytes) / (sum(ops) / rec.frames)
