"""host.camera_ms: the host's time a traced frame in the program's span
host.camera (the frame times and each frame's camera_fn(t)), its self
time: the span less the program spans inside it. Read from the spans the
program recorded through the traced half (times include CUPTI's cost a
runtime call). Nothing to read where the span never ran."""

from bench_torch.spans import stage_ms


def read(rec):
    if rec.frames <= 0:
        return None
    return stage_ms(rec.spans, rec.frames).get("camera")
