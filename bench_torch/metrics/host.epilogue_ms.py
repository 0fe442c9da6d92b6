"""host.epilogue_ms: the host's time a traced frame in the staged
epilogue, the program's spans epilogue (renderer.shade_image and
BlackHoleRenderer.disk_params) and epilogue.background (the plain
epilogue's star field), their self time: the shading kernel's wrapper
(kernel.shade_planes) counts under host.launch_ms. Read from the spans the
program recorded through the traced half (times include CUPTI's cost a
runtime call). Nothing to read in a frame with no epilogue."""

from bench_torch.spans import stage_ms


def read(rec):
    if rec.frames <= 0:
        return None
    return stage_ms(rec.spans, rec.frames).get("epilogue")
