"""setup.program_s: the seconds of the program's own set-up spans, the
outermost setup.* spans recorded through the build and the warm-up
(setup.import, setup.load with setup.build and setup.nvcc inside it,
setup.neural_prepare, setup.disk_lut, setup.plugin), summed. Nothing to
read where none ran."""

from bench_torch.spans import outer_setup


def read(rec):
    outer = outer_setup(rec.setup_spans)
    return sum(b - a for _, a, b, _, _ in outer) if outer else None
