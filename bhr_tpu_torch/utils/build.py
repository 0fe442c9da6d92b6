"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources under bhr_tpu_torch/csrc/ have a plain C interface, so a build
is one nvcc call (seconds, no PyTorch headers). The shared library lands in
build/bhr_tpu_torch/ at the root of the checkout, named by a hash of the
sources and flags: it is built at first use and rebuilt whenever a source
changes. Nothing is built when the module is imported. probes.cu, the
kernels of tools/hopper_probe.py, and shade_planes.cu, the staged
epilogue's kernel, are libraries of their own. Plugin physics
builds trace_planes.cu once more per plugin, with the plugin's recorded
acceleration (utils/plugin.py) written into build/ as a header and
included first; its text is part of the hash.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from . import tracing

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bhr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)
RENDER_MONO_SOURCES = ("render_mono.cu",)
TRACE_PLANES_SOURCES = ("trace_planes.cu",)
NEURAL_MLP_SOURCES = ("neural_mlp.cu",)
SHADE_PLANES_SOURCES = ("shade_planes.cu",)
PROBE_SOURCES = ("probes.cu",)
MAX_LAYERS = 8  # kMaxLayers of csrc/neural_mlp.cu


class KernelParams(ctypes.Structure):
    """bhr::Params of csrc/common.cuh: the 32-float parameter vector,
    passed to the kernel by value."""

    _fields_ = [("v", ctypes.c_float * 32)]


class MlpDesc(ctypes.Structure):
    """bhr::MlpDesc of csrc/neural_mlp.cu, passed by value: the layer count,
    the widths (dims[0] the padded inputs, dims[l + 1] layer l's outputs),
    the block's pixels, the channels per weight chunk (default tier) or
    the W rows per weight slab (highest) and the number of chunk buffers
    (0: the fused layout holds every weight), the fused layout's register
    width (0 for the chunked layout and the highest tier), and each layer's
    weights and bias as device pointers."""

    _fields_ = [
        ("n_layers", ctypes.c_int),
        ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
        ("pix", ctypes.c_int),
        ("n_chunk", ctypes.c_int),
        ("nbuf", ctypes.c_int),
        ("regs", ctypes.c_int),
        ("w", ctypes.c_void_p * MAX_LAYERS),
        ("b", ctypes.c_void_p * MAX_LAYERS),
    ]


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc call; 0.0 when already built
    log: str  # nvcc's output (ptxas resource usage); "" when already built


def nvcc_path() -> str:
    """The nvcc of $CUDA_HOME, else the one on PATH, else the toolkit's
    conventional location. Raises FileNotFoundError when there is none."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise FileNotFoundError(f"nvcc not found (looked at {candidates}); set CUDA_HOME")


def _source_hash(sources, include: str = "") -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(sources).encode())
    h.update(include.encode())
    return h.hexdigest()[:16]


def build(name: str, sources=RENDER_MONO_SOURCES, include: str = "") -> BuildInfo:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so,
    unless that library already exists; `include`, if given, is the text
    of a header included before each source (-include; its own #include
    lines find csrc/). Raises CalledProcessError with nvcc's output when
    the build fails."""
    with tracing.span("setup.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        digest = _source_hash(sources, include)
        lib = BUILD_DIR / f"lib{name}-{digest}.so"
        if lib.exists():
            return BuildInfo(lib, 0.0, "")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        extra = []
        if include:
            header = BUILD_DIR / f"{name}-{digest}.cuh"
            header.write_text(include)
            extra = ["-I", str(CSRC_DIR), "-include", str(header)]
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in sources)]
        t0 = time.perf_counter()
        with tracing.span("setup.nvcc"):
            proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise subprocess.CalledProcessError(
                proc.returncode, cmd, output=proc.stdout, stderr=proc.stderr
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        return BuildInfo(lib, seconds, proc.stdout + proc.stderr)


@functools.cache
def load_render_mono() -> ctypes.CDLL:
    """Build (at first use) and load the monolithic render kernel's library,
    with the C signatures of csrc/render_mono.cu declared."""
    with tracing.span("setup.load"):
        lib = ctypes.CDLL(str(build("render_mono").path))
        lib.bhr_render_mono.argtypes = [
            KernelParams,  # params, by value
            ctypes.c_uint32,  # seed_term
            ctypes.c_int,  # fast
            ctypes.c_int,  # integrator
            ctypes.c_int,  # flags
            ctypes.c_int,  # height
            ctypes.c_int,  # width
            ctypes.c_int,  # max_steps
            ctypes.c_int,  # device
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # stream
        ]
        lib.bhr_render_mono.restype = ctypes.c_int
        lib.bhr_set_disk_lut.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.bhr_set_disk_lut.restype = ctypes.c_int
        lib.bhr_error_string.argtypes = [ctypes.c_int]
        lib.bhr_error_string.restype = ctypes.c_char_p
        return lib


@functools.cache
def load_trace_planes() -> ctypes.CDLL:
    """Build (at first use) and load the staged trace kernel's library,
    with the C signatures of csrc/trace_planes.cu declared."""
    with tracing.span("setup.load"):
        return _declare_trace_planes(ctypes.CDLL(str(build("trace_planes",
                                                           TRACE_PLANES_SOURCES).path)))


@functools.cache
def load_trace_planes_custom(plugin_source: str) -> ctypes.CDLL:
    """Build (at first use, once per plugin) and load trace_planes.cu with
    the plugin's acceleration: `plugin_source` is the header of
    utils/plugin.Program.cuda_source, which defines BHR_CUSTOM_ACCEL."""
    with tracing.span("setup.load"):
        info = build("trace_planes_custom", TRACE_PLANES_SOURCES, include=plugin_source)
        return _declare_trace_planes(ctypes.CDLL(str(info.path)))


def _declare_trace_planes(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bhr_trace_planes.argtypes = [
        KernelParams,  # params, by value
        ctypes.c_int,  # fast
        ctypes.c_int,  # integrator
        ctypes.c_int,  # flags
        ctypes.c_int,  # height
        ctypes.c_int,  # width
        ctypes.c_int,  # max_steps
        ctypes.c_int,  # device
        ctypes.c_void_p,  # mask (null: every ray)
        ctypes.c_void_p,  # pos
        ctypes.c_void_p,  # vel
        ctypes.c_void_p,  # status
        ctypes.c_void_p,  # steps
        ctypes.c_void_p,  # stream
    ]
    lib.bhr_trace_planes.restype = ctypes.c_int
    lib.bhr_error_string.argtypes = [ctypes.c_int]
    lib.bhr_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_shade_planes() -> ctypes.CDLL:
    """Build (at first use) and load the staged epilogue's kernel library,
    with the C signatures of csrc/shade_planes.cu declared."""
    with tracing.span("setup.load"):
        lib = ctypes.CDLL(str(build("shade_planes", SHADE_PLANES_SOURCES).path))
        ptr, f32 = ctypes.c_void_p, ctypes.c_float
        lib.bhr_shade_planes.argtypes = [
            ctypes.c_int64,  # n pixels
            ctypes.c_uint32,  # seed_term
            ctypes.c_int,  # disk
            f32, f32, f32, f32, f32, f32, f32,  # rs, black hole xyz, camera xyz
            ptr, ptr, ptr,  # r_isco, r_outer, t_isco (one fp32 each, on the device)
            ptr,  # lut (512, 3)
            ptr, ptr, ptr,  # pos (null without the disk), vel, status
            ptr,  # out
            ctypes.c_int,  # device
            ptr,  # stream
        ]
        lib.bhr_shade_planes.restype = ctypes.c_int
        lib.bhr_error_string.argtypes = [ctypes.c_int]
        lib.bhr_error_string.restype = ctypes.c_char_p
        return lib


@functools.cache
def load_neural_mlp() -> ctypes.CDLL:
    """Build (at first use) and load the neural surrogate's kernel library,
    with the C signatures of csrc/neural_mlp.cu declared."""
    with tracing.span("setup.load"):
        lib = ctypes.CDLL(str(build("neural_mlp", NEURAL_MLP_SOURCES).path))
        lib.bhr_neural_render.argtypes = [
            KernelParams,  # params, by value
            ctypes.c_uint32,  # seed_term
            ctypes.c_int,  # kerr
            ctypes.c_int,  # highest
            ctypes.c_int,  # height
            ctypes.c_int,  # width
            MlpDesc,  # the MLP, by value
            ctypes.c_int,  # device
            ctypes.c_void_p,  # out: the packed frame, or null
            ctypes.c_void_p,  # vel: the direction planes (N3), or null
            ctypes.c_void_p,  # status
            ctypes.c_void_p,  # stream
        ]
        lib.bhr_neural_render.restype = ctypes.c_int
        lib.bhr_error_string.argtypes = [ctypes.c_int]
        lib.bhr_error_string.restype = ctypes.c_char_p
        return lib


@functools.cache
def load_probes() -> ctypes.CDLL:
    """Build (at first use) and load the probe kernels' library, with the C
    signatures of csrc/probes.cu declared."""
    with tracing.span("setup.load"):
        lib = ctypes.CDLL(str(build("probes", PROBE_SOURCES).path))
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.bhr_probe_ieee.argtypes = [c_int, ptr, ptr, ptr, ctypes.c_int64, c_int, c_int, c_int,
                                       c_int, ptr]
        lib.bhr_probe_ieee.restype = c_int
        # src, tbl, th, tw, idx, pattern, seed, height, width, out, device, stream
        lib.bhr_probe_gather.argtypes = [c_int, ptr, c_int, c_int, ptr, c_int, ctypes.c_uint32,
                                         c_int, c_int, ptr, c_int, ptr]
        lib.bhr_probe_gather.restype = c_int
        # tbl, n_tbl, device, stream
        lib.bhr_probe_const_upload.argtypes = [ptr, c_int, c_int, ptr]
        lib.bhr_probe_const_upload.restype = c_int
        # prec, tanh, round_bf16, a, b, bias, out, m, k, n, device, stream
        lib.bhr_probe_dot.argtypes = [c_int, c_int, c_int, ptr, ptr, ptr, ptr, c_int, c_int, c_int,
                                      c_int, ptr]
        lib.bhr_probe_dot.restype = c_int
        # bf16_out, plane, out, n_rows, p, period, device, stream
        lib.bhr_probe_concat.argtypes = [c_int, ptr, ptr, c_int, c_int, c_int, c_int, ptr]
        lib.bhr_probe_concat.restype = c_int
        lib.bhr_error_string.argtypes = [c_int]
        lib.bhr_error_string.restype = ctypes.c_char_p
        return lib
