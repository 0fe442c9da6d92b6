"""Time the geodesic kernels of one or more checkouts on the card, and read
their compiled code.

    python3 bhr_tpu_torch/tools/time_trace.py [--sass DIR] [--occupancy] [--waves]
        ROOT [ROOT ...]

Each ROOT is a checkout of the repo. First, once per distinct ROOT, the
compiled code (needs nvcc; the SASS needs cuobjdump beside it or on PATH):
* nvcc -cubin of ROOT's csrc/render_mono.cu and csrc/trace_planes.cu with
  utils/build.py's flags, and of trace_planes.cu once more with the header
  utils/plugin.py records from the paczynski_wiita.py plugin: -Xptxas -v
  registers, stack and spills of every instantiation, and each
  instantiation's sass_walk.function_hash (`sass_hash`, the plugin build's
  under "custom:"; equal hashes across roots: the same code);
* the step each case's launch really runs (`routes`): sass_walk.py's
  walk_step follows the kernel that the launch selects, as built, from its
  entry with the launch's flags known, resolving every branch they decide,
  skipping slow paths and loop exits, and counts one pass of the loop: the
  SASS and SFU (MUFU) instructions a step, flag tests, moves and branches
  included;
* the same for the geodesic loop built apart as a small kernel (`steps`):
  trace_ray.cuh's loop (the acceleration loop, or the Kerr-Schild one with
  FLAG_KS) once more per (tier, integrator, flags) with the flags a
  compile-time constant (FLAGS_OF_CASE) passed as a value, so in the
  layout of a kernel that reads them at run time (an exact Kerr-Schild
  kernel whose FLAGS are fixed takes the disk test apart, which `routes`
  sees and this does not); and the opcodes of one __fdiv_rn, one
  __fdiv_rn(1, x) and one __fsqrt_rn (ALONE).
Then one process per ROOT, in the order given, builds ROOT's kernels as
the package does and times each case of CASES (the main path's
render_mono in both tiers and trace_planes fast on the same frame,
BASELINE config 4's trace_planes rk4 exact and render_mono fast, the
other exact instantiations, config 5's Kerr-Schild
trace_planes exact and render_mono fast at 3840x2160x2000, the exact
Kerr-Schild rk4 and leapfrog traces and Euler frame at 1920x1080x500, the
fast Kerr-Schild rk4 and leapfrog frames and Euler trace with the disk at
1920x1080x500, and
the paczynski_wiita.py plugin, and multires's strided low pass and masked
pass of the main path's frame at divisor 3 in both tiers and of config
4's exact frame): the median of
REPEATS runs of 3 launches by CUDA events (utils/timing.device_time_ms:
each run queued behind a spin kernel, so that the host's issue of a short
launch, such as multires's passes, is not timed), a hash of the output (equal
across roots: bit-equal frames or planes), the ray-steps and warp-steps of
the trace's step counts, and nvidia-smi's SM clock and power draw read
while main-path exact frames run. Each case's issue floor is the step's
instructions x its warp-steps / (SMs x 4 schedulers x the SM clock read):
the least time at one warp instruction per scheduler per clock, leaving
out ray-gen and shading; `issue_floor_ms` takes the route's step,
`step_walk_floor_ms` the separate kernel's. Its op bound is
chip_smoke.py's `bound`.

Options, each on the main path's fast frame (render_mono, Euler,
1920x1080x500, Camera.default()):
* --occupancy: builds ROOT's render_mono.cu once more with every launch
  asking for dynamic shared memory (which the kernel never touches) so that
  only 1, 2, ... blocks fit an SM, up to the kernel's own count, the
  carveout at its maximum, and times the frame at each (`occupancy`: the
  blocks asked, the bytes, the blocks resident by
  cudaOccupancyMaxActiveBlocksPerMultiprocessor, ms; and the package's own
  launch). A time that falls with every block added says latency; one
  flat from a few blocks says issue or a pipe.
* --waves: the frame against its first rows cut to a whole number of
  waves of resident blocks (`waves`; 66 of the 68 block rows are 10 waves
  at 6 blocks an SM), and the tail: the frame's time less the cut's scaled
  by their warp-steps.

Prints one JSON line per ROOT run; with --sass, also writes each distinct
ROOT's SASS listings into DIR. Compare two commits within one call, in
the order parent, change, change, parent.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

if __package__:
    from . import sass_walk as sw
else:  # run as a script, before ROOT's package is on the path
    import sass_walk as sw

W, H, STEPS = 1920, 1080, 500
W5, H5, STEPS5 = 3840, 2160, 2000
REPEATS = 5
BLOCK = sw.BLOCK
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
PLUGIN = "examples/plugins/paczynski_wiita.py"
FLAG_ADAPTIVE, FLAG_DISK, FLAG_LT, FLAG_KS = 2, 4, 8, 16  # trace_ray.cuh TraceFlags
# (case, kernel, fast, integrator, model, camera, config keywords); the
# configurations of chip_smoke.py's timings (config 4: rk4, adaptive dt,
# disk, side camera; an exact render_mono takes no disk)
DISK4 = dict(adaptive=True, disk=True)
CASES = (
    ("main_exact", "render_mono", False, "euler", "schwarzschild", "default", {}),
    ("main_fast", "render_mono", True, "euler", "schwarzschild", "default", {}),
    ("planes_euler_fast", "trace_planes", True, "euler", "schwarzschild", "default", {}),
    ("config4_exact", "trace_planes", False, "rk4", "schwarzschild", "side", DISK4),
    ("config4_fast", "render_mono", True, "rk4", "schwarzschild", "side", DISK4),
    ("planes_euler_exact", "trace_planes", False, "euler", "schwarzschild", "default", {}),
    ("planes_leapfrog_exact", "trace_planes", False, "leapfrog", "schwarzschild", "side", DISK4),
    ("mono_rk4_exact", "render_mono", False, "rk4", "schwarzschild", "side",
     dict(adaptive=True)),
    ("mono_leapfrog_exact", "render_mono", False, "leapfrog", "schwarzschild", "side",
     dict(adaptive=True)),
    ("kerr_lt_exact", "trace_planes", False, "euler", "kerr_lt", "side", {}),
    ("config5_exact", "trace_planes", False, "euler", "kerr", "side", dict(disk=True)),
    ("custom_exact", "trace_planes", False, "euler", "custom", "default", {}),
    ("config5_fast", "render_mono", True, "euler", "kerr", "side", dict(disk=True)),
    ("ks_rk4_exact", "trace_planes", False, "rk4", "kerr", "side", dict(disk=True)),
    ("ks_leapfrog_exact", "trace_planes", False, "leapfrog", "kerr", "side", dict(disk=True)),
    ("ks_mono_euler_exact", "render_mono", False, "euler", "kerr", "side", {}),
    ("ks_rk4_fast", "render_mono", True, "rk4", "kerr", "side", dict(disk=True)),
    ("ks_leapfrog_fast", "render_mono", True, "leapfrog", "kerr", "side", dict(disk=True)),
    ("ks_planes_euler_fast", "trace_planes", True, "euler", "kerr", "side", dict(disk=True)),
    # multires's two launches of the main path's frame at divisor 3: the
    # strided low pass and the masked pass over its edge mask
    ("strided_euler_fast", "trace_planes", True, "euler", "schwarzschild", "default",
     dict(multires="strided")),
    ("masked_euler_fast", "trace_planes", True, "euler", "schwarzschild", "default",
     dict(multires="masked")),
    ("strided_euler_exact", "trace_planes", False, "euler", "schwarzschild", "default",
     dict(multires="strided")),
    ("masked_euler_exact", "trace_planes", False, "euler", "schwarzschild", "default",
     dict(multires="masked")),
    # and config 4's exact frame at divisor 3 (the instantiation with its
    # flags fixed at adaptive | disk takes both passes too)
    ("strided_config4_exact", "trace_planes", False, "rk4", "schwarzschild", "side",
     dict(DISK4, multires="strided")),
    ("masked_config4_exact", "trace_planes", False, "rk4", "schwarzschild", "side",
     dict(DISK4, multires="masked")),
)
DIVISOR = 3
BIG = ("config5_exact", "config5_fast")  # 3840x2160x2000; the others 1920x1080x500
INTEGRATORS = sw.INTEGRATORS
# The loop step each case runs, as (fast, integrator, flags) of the walked
# kernel (FLAG_KS: the Kerr-Schild loop, trace_ray_ks); the plugin case has
# none.
FLAGS_OF_CASE = {
    "main_exact": (False, "euler", 0), "main_fast": (True, "euler", 0),
    "planes_euler_fast": (True, "euler", 0),
    "config4_exact": (False, "rk4", FLAG_ADAPTIVE | FLAG_DISK),
    "config4_fast": (True, "rk4", FLAG_ADAPTIVE | FLAG_DISK),
    "planes_euler_exact": (False, "euler", 0),
    "planes_leapfrog_exact": (False, "leapfrog", FLAG_ADAPTIVE | FLAG_DISK),
    "mono_rk4_exact": (False, "rk4", FLAG_ADAPTIVE),
    "mono_leapfrog_exact": (False, "leapfrog", FLAG_ADAPTIVE),
    "kerr_lt_exact": (False, "euler", FLAG_LT),
    "config5_exact": (False, "euler", FLAG_DISK | FLAG_KS),
    "config5_fast": (True, "euler", FLAG_DISK | FLAG_KS),
    "ks_rk4_exact": (False, "rk4", FLAG_DISK | FLAG_KS),
    "ks_leapfrog_exact": (False, "leapfrog", FLAG_DISK | FLAG_KS),
    "ks_mono_euler_exact": (False, "euler", FLAG_KS),
    "ks_rk4_fast": (True, "rk4", FLAG_DISK | FLAG_KS),
    "ks_leapfrog_fast": (True, "leapfrog", FLAG_DISK | FLAG_KS),
    "ks_planes_euler_fast": (True, "euler", FLAG_DISK | FLAG_KS),
    "strided_euler_fast": (True, "euler", 0), "masked_euler_fast": (True, "euler", 0),
    "strided_euler_exact": (False, "euler", 0), "masked_euler_exact": (False, "euler", 0),
    "strided_config4_exact": (False, "rk4", FLAG_ADAPTIVE | FLAG_DISK),
    "masked_config4_exact": (False, "rk4", FLAG_ADAPTIVE | FLAG_DISK),
}
# Intrinsics whose SASS is listed alone: the exact tier's divide, a
# reciprocal written as a divide, and the root.
ALONE = {"fdiv_rn": "__fdiv_rn(a[threadIdx.x], b[threadIdx.x])",
         "rcp_rn": "__fdiv_rn(1.0f, b[threadIdx.x])",
         "fsqrt_rn": "__fsqrt_rn(b[threadIdx.x])"}

WALK_SOURCE = """#include "trace_ray.cuh"
namespace bhr {
template <bool FAST, int INTEG, int FLAGS>
__global__ void step_walk(const Params p, const int max_steps, float* __restrict__ out) {
  const Ray ray = trace_ray<FAST, INTEG, (FLAGS & kFlagKS) != 0>(p, FLAGS, blockIdx.y, threadIdx.x,
                                                                   max_steps);
  const int i = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  out[i] = ray.rel.x + ray.vel.x;
  out[i + 1] = ray.rel.y + ray.vel.y;
  out[i + 2] = ray.rel.z + ray.vel.z;
  out[i + 3] = static_cast<float>(ray.status * 65536 + ray.steps);
}
%s
}  // namespace bhr
"""


# ---- the compiled code -----------------------------------------------------------


def _tools():
    """(nvcc, cuobjdump or None, nvcc flags for a cubin) from this checkout's
    utils/build.py."""
    from bhr_tpu_torch.utils import build

    nvcc = build.nvcc_path()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return nvcc, sw.cuobjdump_path(nvcc), flags + ["-cubin"]


def _walk_kernels() -> list[tuple[bool, str, int]]:
    return sorted(set(FLAGS_OF_CASE.values()))


def _walk_name(fast: bool, integ: str, flags: int) -> str:
    return f"step_walkILb{int(fast)}ELi{INTEGRATORS.index(integ)}ELi{flags}E"


def _instantiations() -> str:
    alone = [f"__global__ void {k}_alone(float* a, const float* b) {{ a[threadIdx.x] = {e}; }}"
             for k, e in ALONE.items()]
    return "\n".join(alone + [
        f"template __global__ void step_walk<{str(f).lower()}, {INTEGRATORS.index(i)}, {fl}>"
        f"(const Params, const int, float* __restrict__);" for f, i, fl in _walk_kernels()])


def plugin_header(root: str) -> str:
    """The CUDA header utils/plugin.py records from ROOT's copy of PLUGIN."""
    from bhr_tpu_torch.utils import plugin

    return plugin.cuda_source(plugin.load_plugin(os.path.join(root, PLUGIN))[0])


def static(root: str, nvcc: str, cuobjdump: str | None, flags: list,
           sass_dir: str | None = None, header: str = "") -> dict:
    """Registers, spills and SASS hashes of ROOT's two geodesic sources and
    of trace_planes.cu built with the plugin's `header`, the walked step of
    each kernel of _walk_kernels(), and the step each case's launch runs in
    the kernels as built."""
    csrc = Path(root).resolve() / "bhr_tpu_torch" / "csrc"
    tmp = Path(tempfile.mkdtemp(prefix="time_trace_"))
    walk_cu = tmp / "walk.cu"
    walk_cu.write_text(WALK_SOURCE % _instantiations())
    (tmp / "plugin.cuh").write_text(header)
    jobs = {"render_mono": [csrc / "render_mono.cu"], "trace_planes": [csrc / "trace_planes.cu"],
            "trace_planes_custom": ["-I", str(csrc), "-include", str(tmp / "plugin.cuh"),
                                    csrc / "trace_planes.cu"],
            "walk": ["-I", str(csrc), walk_cu]}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = {k: pool.submit(sw.run, [nvcc, *flags, "-o", str(tmp / f"{k}.cubin"), *map(str, v)])
                for k, v in jobs.items()}
        logs = {k: f.result().stdout + f.result().stderr for k, f in done.items()}
    out = {"ptxas": {k: sw.ptxas_summary(logs[k])
                     for k in ("render_mono", "trace_planes", "trace_planes_custom")}}
    if cuobjdump is None:
        out["sass"] = "cuobjdump not found"
        shutil.rmtree(tmp, ignore_errors=True)
        return out
    hashes, totals = {}, {}
    listings = {k: sw.sass_of(tmp / f"{k}.cubin", cuobjdump) for k in jobs}
    if sass_dir:
        tag = re.sub(r"[^A-Za-z0-9]+", "_", str(Path(root).resolve())).strip("_")
        for k, text in listings.items():
            Path(sass_dir, f"{tag}.{k}.sass").write_text(text)
    funcs = {k: sw.parse_sass(listings[k])
             for k in ("render_mono", "trace_planes", "trace_planes_custom")}
    for k in funcs:
        for name, ins in funcs[k].items():
            tag = sw.kernel_tag(name)
            if not tag:
                continue
            key = ("custom:" if k == "trace_planes_custom" else "") + sw.tag_text(tag)
            hashes[key] = sw.function_hash(ins)
            totals[key] = {"instructions": len(ins),
                           "mufu": sum(x.op.startswith("MUFU") for x in ins)}
    walk = sw.parse_sass(listings["walk"])
    steps = {}
    for fast, integ, fl in _walk_kernels():
        name = next(n for n in walk if _walk_name(fast, integ, fl) in n)
        steps[f"{'fast' if fast else 'exact'},{integ},flags={fl}"] = sw.walk_step(walk[name])
    routes = {}
    for case, kernel, fast, integ, *_ in CASES:
        if case in FLAGS_OF_CASE:
            try:
                routes[case] = sw.route_step(funcs[kernel], kernel, fast, integ,
                                          FLAGS_OF_CASE[case][2])
            except RuntimeError as e:  # recorded: the other cases still count
                routes[case] = {"error": str(e)}
    out.update(sass_hash=hashes, sass_totals=totals, steps=steps, routes=routes)
    for k in ALONE:
        ins = next(ins for n, ins in walk.items() if f"{k}_alone" in n)
        ins = ins[:next(j for j, x in enumerate(ins) if x.op == "EXIT") + 1]
        out[f"{k}_opcodes"] = [f"{x.pred + ' ' if x.pred else ''}{x.op}" for x in ins]
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- the times ---------------------------------------------------------------------


# The occupancy sweep builds render_mono.cu once more, with every launch
# given a dynamic shared-memory request that leaves room for only so many
# blocks an SM (the kernel never touches that memory), the shared-memory
# carveout at its maximum, and the resident count read back from
# cudaOccupancyMaxActiveBlocksPerMultiprocessor at each launch.
SWEEP_PREFIX = """
static int tt_smem = 0;
static int tt_blocks = -1;
template <typename K>
static K tt_prep(K kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tt_smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&tt_blocks, kernel, 256, tt_smem);
  return kernel;
}
"""
SWEEP_SUFFIX = """
extern "C" void tt_set_smem(int bytes) { tt_smem = bytes; }
extern "C" int tt_blocks_per_sm() { return tt_blocks; }
"""
SM_SHARED = 233472  # bytes of shared memory an SM (228 KB), 1 KB of it reserved a block;
# a request is rounded down to whole KB, as the card allocates in coarser units
BLOCK_SHARED_MAX = 232448  # the most one block may ask for (227 KB)
LAUNCH = re.compile(
    r"((?:bhr::)?render_mono_kernel<[^<>;]*>)\s*<<<\s*grid,\s*block,\s*0,\s*s\s*>>>")


def sweep_source(text: str) -> str:
    """render_mono.cu with its launches routed through tt_prep and given
    tt_smem bytes of dynamic shared memory."""
    text, n = LAUNCH.subn(r"tt_prep(\1)<<<grid, block, tt_smem, s>>>", text)
    if not n:
        raise RuntimeError("render_mono.cu has no launch of the form the sweep rewrites")
    last = [m.end() for m in re.finditer(r"^#include .*$", text, re.M)][-1]
    return text[:last] + "\n" + SWEEP_PREFIX + text[last:] + SWEEP_SUFFIX


def build_sweep_lib(root: str):
    """The sweep's build of ROOT's render_mono.cu, loaded, with the
    package's C signatures."""
    import ctypes

    from bhr_tpu_torch.utils import build

    tmp = Path(tempfile.mkdtemp(prefix="time_trace_sweep_"))
    shutil.copytree(Path(root) / "bhr_tpu_torch" / "csrc", tmp / "csrc")
    src = tmp / "csrc" / "render_mono.cu"
    src.write_text(sweep_source(src.read_text()))
    sw.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(tmp / "sweep.so"), str(src)])
    lib = ctypes.CDLL(str(tmp / "sweep.so"))
    real = build.load_render_mono()
    for fn in ("bhr_render_mono", "bhr_set_disk_lut", "bhr_error_string"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    lib.tt_set_smem.argtypes = [ctypes.c_int]
    lib.tt_blocks_per_sm.restype = ctypes.c_int
    return lib


def occupancy_sweep(lib, launch_ms) -> list:
    """The main path's fast frame at 1, 2, ... resident blocks an SM, up to
    the kernel's own count: [{blocks asked, dynamic shared bytes, blocks
    resident, ms}]. launch_ms() times the package's launch, which the
    caller points at `lib`."""
    lib.tt_set_smem(0)
    launch_ms()
    natural = lib.tt_blocks_per_sm()
    rows = []
    for k in range(1, natural + 1):
        smem = 0 if k == natural else min(BLOCK_SHARED_MAX, (SM_SHARED // k - 1024) // 1024 << 10)
        lib.tt_set_smem(smem)
        ms = launch_ms()
        rows.append({"blocks": k, "smem": smem, "resident": lib.tt_blocks_per_sm(), "ms": ms})
    lib.tt_set_smem(0)
    return rows


def whole_waves(grid_x: int, grid_y: int, slots: int) -> int:
    """The most block rows r <= grid_y whose grid_x * r blocks fill a whole
    number of waves of `slots` resident blocks (0 if none)."""
    return next((r for r in range(grid_y, 0, -1) if grid_x * r % slots == 0), 0)


def measure(root: str, occupancy: bool = False, waves: bool = False) -> dict:
    sys.path.insert(0, root)
    import torch

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.ops import trace_kernel as tk
    from bhr_tpu_torch.ops.multires import deflection_edges
    from bhr_tpu_torch.utils import build
    from bhr_tpu_torch.utils.timing import device_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("time_trace.py needs a CUDA device")
    import chip_smoke

    smi = sw.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).stdout
    build.load_render_mono()
    build.load_trace_planes()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cams = {"default": bt.Camera.default(), "side": bt.Camera.new(*SIDE)}
    cells = []
    for case, kernel, fast, integ, model, cam_name, kw in CASES:
        cam = cams[cam_name]
        w, h, s = (W5, H5, STEPS5) if case in BIG else (W, H, STEPS)
        scene = bt.SceneParams(screen_width=w, screen_height=h, max_steps=s, spin=0.9)
        accel_ops, multires = 0, None
        if model == "custom":
            config = bt.BlackHoleRenderer(w, h, integ, custom_physics=os.path.join(root, PLUGIN),
                                          fast_math=fast, device="cuda").config
            from bhr_tpu_torch.utils import plugin

            accel_ops = plugin.program(config.custom_accel).varying_ops
        else:
            kw = dict(kw)
            multires = kw.pop("multires", None)
            config = bt.TraceConfig(integrator=integ, model=model, **kw)
        pass_kw, shape = {}, (h, w)
        if multires:
            local = (-(-h // DIVISOR), -(-w // DIVISOR))
            low = tk.trace_image(cam, scene, config, fast_math=fast, device="cuda",
                                 stride=DIVISOR, local_shape=local)
            if multires == "strided":
                pass_kw, shape = dict(stride=DIVISOR, local_shape=local), local
            else:
                edge = deflection_edges([low.final_vel[..., i] for i in range(3)], low.status,
                                        0.05)
                pass_kw = dict(mask=edge.repeat_interleave(DIVISOR, dim=0)
                               .repeat_interleave(DIVISOR, dim=1)[:h, :w].contiguous())
        if kernel == "render_mono":
            out = torch.empty((h, w), dtype=torch.int32, device="cuda")

            def launch():
                tk.render_packed(cam, scene, config, fast_math=fast, device="cuda", out=out)
        else:
            out = tk.empty_trace_result(*shape, "cuda")

            def launch():
                tk.trace_image(cam, scene, config, fast_math=fast, device="cuda", out=out,
                               **pass_kw)
        launch()  # warm-up (and the plugin's build)
        ms = device_time_ms(launch, iters=3, repeats=REPEATS, device="cuda")
        torch.cuda.synchronize()
        planes = tk.trace_image(cam, scene, config, fast_math=fast, device="cuda", **pass_kw)
        tensors = [out] if kernel == "render_mono" else [out.final_pos, out.final_vel,
                                                         out.status, out.steps]
        digest = hashlib.sha256()
        for t in tensors:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        ray_steps = int(planes.steps.sum().item())
        bound_ms, by = chip_smoke.bound(
            f"trace_planes[{multires}]" if multires else
            kernel if model != "custom" else "trace_planes", model, fast, integ, ray_steps,
            shape[0] * shape[1], adaptive=config.adaptive, disk=config.disk, accel_ops=accel_ops)
        cells.append(dict(case=case, kernel=kernel, tier="fast" if fast else "exact",
                          integrator=integ, model=model, camera=cam_name, shape=[w, h, s],
                          adaptive=config.adaptive, disk=config.disk, ms=ms,
                          output_sha256=digest.hexdigest()[:16], ray_steps=ray_steps,
                          warp_steps=sw.warp_steps(torch, planes.steps), op_bound_ms=bound_ms,
                          op_bound_by=by))
        del out, planes
    run = dict(root=root, card=smi.strip(), torch=torch.__version__, sms=sms, cells=cells)
    scene = bt.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    cam = cams["default"]
    frame = torch.empty((H, W), dtype=torch.int32, device="cuda")

    def main_fast_ms():
        def launch():
            tk.render_packed(cam, scene, fast_math=True, device="cuda", out=frame)
        return device_time_ms(launch, iters=3, repeats=REPEATS, device="cuda")

    if occupancy or waves:
        lib = build_sweep_lib(root)
        real_loader = build.load_render_mono
        build.load_render_mono = lambda: lib
        try:
            sweep = occupancy_sweep(lib, main_fast_ms)
        finally:
            build.load_render_mono = real_loader
        natural = sweep[-1]["resident"]
        if occupancy:
            run["occupancy"] = dict(case="main_fast", natural_ms=main_fast_ms(), sweep=sweep)
        if waves:
            gx, gy = -(-W // BLOCK[0]), -(-H // BLOCK[1])
            rows = whole_waves(gx, gy, sms * natural) or gy
            band = torch.empty((rows * BLOCK[1], W), dtype=torch.int32, device="cuda")

            def cut():
                tk.render_packed(cam, scene, fast_math=True, device="cuda", out=band,
                                 local_shape=tuple(band.shape))
            cut()
            steps = tk.trace_image(cam, scene, fast_math=True, device="cuda").steps
            full_ms = main_fast_ms()
            cut_ms = device_time_ms(cut, iters=3, repeats=REPEATS, device="cuda")
            ws_full = sw.warp_steps(torch, steps)
            ws_cut = sw.warp_steps(torch, steps[:band.shape[0]])
            run["waves"] = dict(case="main_fast", resident=natural, slots=sms * natural,
                                grid=[gx, gy], waves=gx * gy / (sms * natural),
                                cut_rows=rows * BLOCK[1], cut_waves=gx * rows / (sms * natural),
                                full_ms=full_ms, cut_ms=cut_ms, warp_steps_full=ws_full,
                                warp_steps_cut=ws_cut,
                                tail_ms=full_ms - cut_ms * ws_full / ws_cut)
    def main_exact():
        tk.render_packed(cam, scene, fast_math=False, device="cuda", out=frame)
    run["clocks_under_load"] = sw.sm_clock_under_load(  # main-path exact frames
        main_exact, device_time_ms(main_exact, iters=1, repeats=1, device="cuda"))
    return run


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2], "--occupancy" in sys.argv[3:],
                                 "--waves" in sys.argv[3:])), flush=True)
        return
    args = sys.argv[1:]
    sass_dir, options = None, []
    while args[:1] and args[0].startswith("--"):
        if args[0] == "--sass" and len(args) > 1:
            sass_dir = args[1]
            os.makedirs(sass_dir, exist_ok=True)
            args = args[2:]
        elif args[0] in ("--occupancy", "--waves"):
            options.append(args.pop(0))
        else:
            raise SystemExit(__doc__)
    if not args:
        raise SystemExit(__doc__)
    roots = args
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # this checkout
    nvcc, cuobjdump, flags = _tools()
    with concurrent.futures.ThreadPoolExecutor(len(set(roots))) as pool:
        statics = {r: pool.submit(static, r, nvcc, cuobjdump, flags, sass_dir, plugin_header(r))
                   for r in dict.fromkeys(roots)}
        statics = {r: f.result() for r, f in statics.items()}
    for root in roots:
        run = json.loads(sw.run([sys.executable, __file__, "--one", root, *options])
                         .stdout.splitlines()[-1])
        st = statics[root]
        clock_mhz = float(run["clocks_under_load"].split(",")[0])
        for cell in run["cells"]:
            key = FLAGS_OF_CASE.get(cell["case"])
            walked = st.get("steps", {}).get(
                f"{'fast' if key[0] else 'exact'},{key[1]},flags={key[2]}", {}) if key else {}
            route = st.get("routes", {}).get(cell["case"], {})
            cell["step_walk_floor_ms"] = (sw.issue_floor_ms(
                walked["step_instructions"], cell["warp_steps"], run["sms"], clock_mhz)
                if walked else None)
            cell["route"] = route
            cell["issue_floor_ms"] = (sw.issue_floor_ms(
                route["step_instructions"], cell["warp_steps"], run["sms"], clock_mhz)
                if "step_instructions" in route else None)
        print(json.dumps({**run, **st}), flush=True)


if __name__ == "__main__":
    main()
