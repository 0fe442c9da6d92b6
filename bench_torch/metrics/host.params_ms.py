"""host.params_ms: the host's time a traced frame in the program's spans
host.params (the kernels' parameter block, the MLP's descriptor) and
host.params.ks (the exact Kerr capture radius), their self time. Read from
the spans the program recorded through the traced half (times include
CUPTI's cost a runtime call). Nothing to read where neither span ran."""

from bench_torch.spans import stage_ms


def read(rec):
    if rec.frames <= 0:
        return None
    return stage_ms(rec.spans, rec.frames).get("params")
