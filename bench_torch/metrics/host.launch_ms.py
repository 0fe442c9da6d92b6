"""host.launch_ms: the host's time a traced frame in the kernels' wrappers,
the program's spans kernel.* (render_mono, trace_planes, neural_mlp,
shade_planes), their self time: the checks and the ctypes call, the
parameter block (host.params) left out. Read from the spans the program
recorded through the traced half; the launch's runtime call carries
CUPTI's cost, which an untraced frame does not pay. Nothing to read where
no wrapper ran."""

from bench_torch.spans import stage_ms


def read(rec):
    if rec.frames <= 0:
        return None
    return stage_ms(rec.spans, rec.frames).get("launch")
