"""bhr_tpu_torch: the PyTorch and CUDA port of bhr_tpu, the general-
relativistic black-hole raytracer, for NVIDIA Hopper GPUs.

It renders bhr_tpu's Schwarzschild, exact Kerr, Lense-Thirring Kerr and
flat-spacetime frames -- the euler, rk4 and leapfrog integrators, fixed or
adaptive dt, the accretion disk, the analytic star field, the tonemaps and
the step heatmap, packed RGBA output -- through two CUDA kernels written
for sm_90a (csrc/render_mono.cu, trace + shade; csrc/trace_planes.cu,
trace into planes for the PyTorch shading epilogue), in the fast and the
exact math tier; and the neural surrogate's frames (integrator "neural",
the Schwarzschild or Kerr MLP) through a third, csrc/neural_mlp.cu
(ray-gen, features, the MLP on the tensor cores, rotation and star field in
one launch), at the default (bf16) or highest (fp32) precision tier, or
through the staged route ops/neural_trace. A texture skybox
(io/skybox.load_skybox; the bilinear, nearest and luma filters and the
subsampled reconstructions of ops/sampling.py) is sampled by the staged
epilogue after the planes kernel, or after the neural kernel's
direction-plane output; multires frames (ops/multires.py) integrate at a
fraction of the resolution through the planes kernel's strided and masked
ray-gen. Plugin physics (utils/plugin.py: a Python acceleration, recorded
into the CUDA source of a build of csrc/trace_planes.cu) traces the user's
metric, and parallel/ renders row bands over a grid of devices. A plain
PyTorch version stands beside each kernel. The front end follows bhr_tpu's:
PathAnimator (any camera path; render_to_dir, save_video, save_gif),
PerformanceStats and PerfLogger, and TimestampQuery on CUDA events
(render_frame(timestamp_query=)). tools/hopper_probe.py answers, with the
kernels of csrc/probes.cu, what bhr_tpu's probe scripts asked of the TPU.
It imports torch and never jax;
bhr_tpu stays the reference it is tested against. utils/tracing records
the program's spans and counts its kernel launches.
"""

import time as _time

_IMPORT_START_NS = _time.time_ns()

from .animation import OrbitAnimator, PathAnimator
from .core.camera import Camera, generate_rays, orbit_camera
from .core.math import cross, direction_to_equirectangular_uv, normalize
from .core.scene import (
    CAPTURE_FACTOR,
    DEBUG_NONE,
    DEBUG_STEPS,
    DEFAULT_DT,
    ESCAPE_RADIUS,
    SceneParams,
)
from .from_numpy import (
    camera_from_numpy,
    neural_params_from_numpy,
    scene_from_numpy,
    texture_from_numpy,
    trace_result_from_numpy,
)
from .io.skybox import load_skybox
from .models.neural import NeuralSurrogate
from .ops.display import QUAD_VERTICES, Vertex
from .ops.multires import render_multires
from .ops.trace import TraceConfig, TraceResult, trace_rays
from .ops.trace_kernel import trace_image
from .renderer import (
    BlackHoleRenderer,
    CudaContext,
    GpuContext,
    TpuContext,
    block_on,
    render_image,
    shade_image,
)
from .utils.perf import PerfLogger, PerformanceStats
from .utils.timing import TimestampQuery
from .utils import tracing

__version__ = "0.1.0"

__all__ = [
    "BlackHoleRenderer",
    "CAPTURE_FACTOR",
    "Camera",
    "CudaContext",
    "DEBUG_NONE",
    "DEBUG_STEPS",
    "DEFAULT_DT",
    "ESCAPE_RADIUS",
    "GpuContext",
    "NeuralSurrogate",
    "OrbitAnimator",
    "PathAnimator",
    "PerfLogger",
    "PerformanceStats",
    "QUAD_VERTICES",
    "SceneParams",
    "TimestampQuery",
    "TpuContext",
    "TraceConfig",
    "TraceResult",
    "Vertex",
    "block_on",
    "camera_from_numpy",
    "cross",
    "direction_to_equirectangular_uv",
    "generate_rays",
    "load_skybox",
    "neural_params_from_numpy",
    "normalize",
    "orbit_camera",
    "render_image",
    "render_multires",
    "scene_from_numpy",
    "shade_image",
    "texture_from_numpy",
    "trace_image",
    "trace_rays",
    "trace_result_from_numpy",
]

tracing.record("setup.import", _IMPORT_START_NS, _time.time_ns())
del _IMPORT_START_NS, _time
