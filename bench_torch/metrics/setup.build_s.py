"""setup.build_s: the seconds of the benchmark's span bench.build, around
its build of the program (the package's import, the renderer and the
animator, the kernels' libraries loaded or built), on the host's clock."""


def read(rec):
    return next((b - a for n, a, b in rec.setup_host if n == "bench.build"), None)
