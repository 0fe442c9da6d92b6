"""A benchmark run records none of the program's spans: its end-to-end
metrics are measured with bhr_tpu_torch's recording (utils/tracing) off,
so a span costs each frame one flag test. On the CPU, with the harness's
own run_cell at a small size; a `--trace 1` run needs the card's profiler."""

import time

from bhr_tpu_torch.utils import tracing

from bench_torch import harness


def test_a_trace_0_run_records_no_span():
    cell = harness.load_cell("rk4disk1080.orbit_exact")
    cell.config["scene"].update(width=24, height=16, max_steps=40)
    cell.traffic.update(sample_within=2, compare_frames=1, warmup_frames=1)
    issued = []

    def wrap(program, k):
        issued.append(k)
        return program(k)

    tracing.drain()
    out = harness.run_cell(cell, 2**31 + 7, 0.5, False, t_start=time.perf_counter(),
                           device="cpu", wrap=wrap)
    assert out["correct"] and issued
    assert tracing.drain() == []
