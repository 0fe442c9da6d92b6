"""Time the geodesic kernels of one or more checkouts on the card, and read
their compiled code.

    python3 bhr_tpu_torch/tools/time_trace.py [--sass DIR] ROOT [ROOT ...]

Each ROOT is a checkout of the repo. First, once per distinct ROOT, the
compiled code (needs nvcc; the SASS needs cuobjdump beside it or on PATH):
* nvcc -cubin of ROOT's csrc/render_mono.cu and csrc/trace_planes.cu with
  utils/build.py's flags: -Xptxas -v registers, stack and spills of every
  instantiation, and a hash of each instantiation's SASS (equal hashes
  across roots: the same code);
* the SASS of one step of the geodesic loop: trace_ray.cuh's loop (the
  acceleration loop, or the Kerr-Schild one with FLAG_KS) built once more
  as a small kernel per (tier, integrator, flags) with the launch's flags
  fixed (FLAGS_OF_CASE; the kernels take them at run time, so theirs add
  a few flag tests a step), walked from the loop's head to its back edge,
  past the blocks a step does not run on its common path (a forward
  branch is taken when the code it skips calls a slow path or leaves the
  loop): the instructions and the SFU (MUFU) instructions of that step,
  beside the whole loop's; and the opcodes of one __fdiv_rn, one
  __fdiv_rn(1, x) and one __fsqrt_rn (ALONE).
Then one process per ROOT, in the order given, builds ROOT's kernels as
the package does and times each case of CASES (the main path's
render_mono in both tiers, BASELINE config 4's trace_planes rk4 exact and
render_mono fast, the other exact instantiations, config 5's Kerr-Schild
trace_planes exact and render_mono fast at 3840x2160x2000, the exact
Kerr-Schild rk4 and leapfrog traces and Euler frame at 1920x1080x500, and
the paczynski_wiita.py plugin): the median of
REPEATS runs of 3 launches by CUDA events, a hash of the output (equal
across roots: bit-equal frames or planes), the ray-steps and warp-steps of
the trace's step counts, and nvidia-smi's SM clock and power draw read
while main-path exact frames run. Each case's issue floor is the step's
instructions x its warp-steps / (SMs x 4 schedulers x the SM clock read):
the least time at one warp instruction per scheduler per clock, leaving
out ray-gen and shading; its op bound is chip_smoke.py's `bound`.

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
import subprocess
import sys
import tempfile
from pathlib import Path

W, H, STEPS = 1920, 1080, 500
W5, H5, STEPS5 = 3840, 2160, 2000
REPEATS = 5
SCHEDULERS = 4  # warp schedulers an SM (Hopper)
BLOCK = (16, 16)  # the kernels' blocks: a warp is 2 rows x 16 columns
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
)
BIG = ("config5_exact", "config5_fast")  # 3840x2160x2000; the others 1920x1080x500
INTEGRATORS = ("euler", "rk4", "leapfrog")
# The loop step each case runs, as (fast, integrator, flags) of the walked
# kernel (FLAG_KS: the Kerr-Schild loop, trace_ray_ks); the plugin case has
# none.
FLAGS_OF_CASE = {
    "main_exact": (False, "euler", 0), "main_fast": (True, "euler", 0),
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
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return nvcc, cuobjdump if os.access(cuobjdump, os.X_OK) else None, flags + ["-cubin"]


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


def parse_sass(text: str) -> dict:
    """{function: [(address, predicate, opcode, target address or None)]}
    from cuobjdump -sass."""
    funcs, cur, labels, pending = {}, None, {}, []
    raw = []
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = m[1]
            funcs[cur] = []
            raw.append((cur, None))
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab and cur:
            pending.append(lab[1])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and cur:
            addr = int(ins[1], 16)
            for name in pending:
                labels[(cur, name)] = addr
            pending = []
            raw.append((cur, (addr, ins[2])))
    for cur, item in raw:
        if item is None:
            continue
        addr, body = item
        toks = body.split()
        pred = toks.pop(0) if toks and toks[0].startswith("@") else None
        op = toks[0] if toks else ""
        target = None
        if op.startswith("BRA") or op.startswith("BSSY") or op.startswith("CALL"):
            m = re.search(r"`\((\.L_x_\d+)\)", body)
            if m:
                target = labels.get((cur, m[1]))
            else:
                m = re.search(r"\b0x([0-9a-f]+)\b", body)
                target = int(m[1], 16) if m else None
        funcs[cur].append((addr, pred, op, target))
    return funcs


def walk_step(ins: list) -> dict:
    """The common path of one step of the function's largest loop: from the
    loop's head to its back edge, a conditional forward branch inside the
    loop is taken when the code it skips holds a CALL, an EXIT or RET or a
    branch out of the loop (a slow path or a loop exit), else not; a branch
    out of the loop is not taken."""
    index = {a: k for k, (a, *_rest) in enumerate(ins)}
    loops = [(t, a) for a, p, op, t in ins
             if op.startswith("BRA") and t is not None and t <= a and p != "@!PT"]
    if not loops:
        return {}
    head, tail = max(loops, key=lambda x: x[1] - x[0])
    inside = lambda t: t is not None and head <= t <= tail  # noqa: E731

    def cold(k0, k1):
        for _a, _p, op, t in ins[k0:k1]:
            if op.startswith(("CALL", "EXIT", "RET")):
                return True
            if op.startswith("BRA") and not op.startswith("BRA.DIV") and t is not None \
                    and not inside(t):
                return True
        return False

    k, n, mufu, seen = index[head], 0, 0, 0
    while seen < 100000:
        seen += 1
        addr, pred, op, t = ins[k]
        n += 1
        mufu += op.startswith("MUFU")
        if addr == tail:
            break
        if op.startswith("BRA") and not op.startswith("BRA.DIV") and t is not None \
                and pred != "@!PT":
            if t == head:
                break  # a conditional back edge: the next step
            if pred in (None, "@PT"):
                if not inside(t):
                    raise RuntimeError(f"the walk left the loop at {addr:#x}")
                k = index[t]
                continue
            if inside(t) and t > addr and cold(k + 1, index[t]):
                k = index[t]
                continue
        k += 1
    region = [x for x in ins if head <= x[0] <= tail]
    return {"step_instructions": n, "step_mufu": mufu, "loop_instructions": len(region),
            "loop_mufu": sum(x[2].startswith("MUFU") for x in region)}


def _run(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, check=True, **kw)


def static(root: str, nvcc: str, cuobjdump: str | None, flags: list,
           sass_dir: str | None = None) -> dict:
    """Registers, spills and SASS hashes of ROOT's two geodesic sources, and
    the walked step of each kernel of _walk_kernels()."""
    import chip_smoke
    csrc = Path(root).resolve() / "bhr_tpu_torch" / "csrc"
    tmp = Path(tempfile.mkdtemp(prefix="time_trace_"))
    walk_cu = tmp / "walk.cu"
    walk_cu.write_text(WALK_SOURCE % _instantiations())
    jobs = {"render_mono": [csrc / "render_mono.cu"], "trace_planes": [csrc / "trace_planes.cu"],
            "walk": ["-I", str(csrc), walk_cu]}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = {k: pool.submit(_run, [nvcc, *flags, "-o", str(tmp / f"{k}.cubin"), *map(str, v)])
                for k, v in jobs.items()}
        logs = {k: f.result().stdout + f.result().stderr for k, f in done.items()}
    out = {"ptxas": {k: chip_smoke.ptxas_summary(logs[k])
                     for k in ("render_mono", "trace_planes")}}
    if cuobjdump is None:
        out["sass"] = "cuobjdump not found"
        shutil.rmtree(tmp, ignore_errors=True)
        return out
    hashes, totals = {}, {}
    listings = {k: _run([cuobjdump, "-sass", str(tmp / f"{k}.cubin")]).stdout for k in jobs}
    if sass_dir:
        tag = re.sub(r"[^A-Za-z0-9]+", "_", str(Path(root).resolve())).strip("_")
        for k, text in listings.items():
            Path(sass_dir, f"{tag}.{k}.sass").write_text(text)
    for k in ("render_mono", "trace_planes"):
        sass = listings[k]
        for name, ins in parse_sass(sass).items():
            m = re.search(r"(render_mono|trace_planes)_kernelILb([01])ELi([0-2])ELb([01])E", name)
            if not m:
                continue
            tag = (f"{m[1]}<{'fast' if m[2] == '1' else 'exact'},{INTEGRATORS[int(m[3])]}"
                   f"{',ks' if m[4] == '1' else ''}>")
            text = "\n".join(f"{p or ''} {op} {t}" for _a, p, op, t in ins)
            hashes[tag] = hashlib.sha256(text.encode()).hexdigest()[:16]
            totals[tag] = {"instructions": len(ins),
                           "mufu": sum(op.startswith("MUFU") for _a, _p, op, _t in ins)}
    walk = parse_sass(listings["walk"])
    steps = {}
    for fast, integ, fl in _walk_kernels():
        name = next(n for n in walk if _walk_name(fast, integ, fl) in n)
        steps[f"{'fast' if fast else 'exact'},{integ},flags={fl}"] = walk_step(walk[name])
    out.update(sass_hash=hashes, sass_totals=totals, steps=steps)
    for k in ALONE:
        ins = next(ins for n, ins in walk.items() if f"{k}_alone" in n)
        ins = ins[:next(j for j, x in enumerate(ins) if x[2] == "EXIT") + 1]
        out[f"{k}_opcodes"] = [f"{p + ' ' if p else ''}{op}" for _a, p, op, _t in ins]
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- the times ---------------------------------------------------------------------


def warp_steps(torch, steps) -> int:
    """Loop iterations summed over warps: a warp (2 rows x 16 columns of a
    16 x 16 block) steps while any of its rays does."""
    h, w = steps.shape
    pad = torch.zeros((-(-h // BLOCK[1]) * BLOCK[1], -(-w // BLOCK[0]) * BLOCK[0]),
                      dtype=torch.int64, device=steps.device)
    pad[:h, :w] = steps
    return int(pad.view(pad.shape[0] // 2, 2, pad.shape[1] // 16, 16).amax((1, 3)).sum().item())


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.ops import trace_kernel as tk
    from bhr_tpu_torch.utils import build

    if not torch.cuda.is_available():
        raise SystemExit("time_trace.py needs a CUDA device")
    import chip_smoke

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).stdout
    build.load_render_mono()
    build.load_trace_planes()
    cams = {"default": bt.Camera.default(), "side": bt.Camera.new(*SIDE)}
    cells = []
    for case, kernel, fast, integ, model, cam_name, kw in CASES:
        cam = cams[cam_name]
        w, h, s = (W5, H5, STEPS5) if case in BIG else (W, H, STEPS)
        scene = bt.SceneParams(screen_width=w, screen_height=h, max_steps=s, spin=0.9)
        accel_ops = 0
        if model == "custom":
            config = bt.BlackHoleRenderer(w, h, integ, custom_physics=os.path.join(root, PLUGIN),
                                          fast_math=fast, device="cuda").config
            from bhr_tpu_torch.utils import plugin

            accel_ops = plugin.record(config.custom_accel).varying_ops
        else:
            config = bt.TraceConfig(integrator=integ, model=model, **kw)
        if kernel == "render_mono":
            out = torch.empty((h, w), dtype=torch.int32, device="cuda")

            def launch():
                tk.render_packed(cam, scene, config, fast_math=fast, device="cuda", out=out)
        else:
            out = tk.empty_trace_result(h, w, "cuda")

            def launch():
                tk.trace_image(cam, scene, config, fast_math=fast, device="cuda", out=out)
        launch()  # warm-up (and the plugin's build)
        ms = chip_smoke.cuda_ms(lambda: [launch() for _ in range(3)], 3, REPEATS)
        torch.cuda.synchronize()
        planes = tk.trace_image(cam, scene, config, fast_math=fast, device="cuda")
        tensors = [out] if kernel == "render_mono" else [out.final_pos, out.final_vel,
                                                         out.status, out.steps]
        digest = hashlib.sha256()
        for t in tensors:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        ray_steps = int(planes.steps.sum().item())
        bound_ms, by = chip_smoke.bound(
            kernel if model != "custom" else "trace_planes", model, fast, integ, ray_steps,
            w * h, adaptive=config.adaptive, disk=config.disk, accel_ops=accel_ops)
        cells.append(dict(case=case, kernel=kernel, tier="fast" if fast else "exact",
                          integrator=integ, model=model, camera=cam_name, shape=[w, h, s],
                          adaptive=config.adaptive, disk=config.disk, ms=ms,
                          output_sha256=digest.hexdigest()[:16], ray_steps=ray_steps,
                          warp_steps=warp_steps(torch, planes.steps), op_bound_ms=bound_ms,
                          op_bound_by=by))
        del out, planes
    main = next(c for c in CASES if c[0] == "main_exact")
    scene = bt.SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    frame = torch.empty((H, W), dtype=torch.int32, device="cuda")
    n = int(600 / cells[0]["ms"]) + 1
    for _ in range(n):  # 0.6 s of main-path exact frames, then read the clocks
        tk.render_packed(cams[main[5]], scene, fast_math=False, device="cuda", out=frame)
    clocks = _run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                   "--format=csv,noheader,nounits"]).stdout.strip()
    torch.cuda.synchronize()
    return dict(root=root, card=smi.strip(), torch=torch.__version__,
                sms=torch.cuda.get_device_properties(0).multi_processor_count,
                clocks_under_load=clocks, cells=cells)


def issue_floor(cell: dict, steps: dict, sms: int, clock_mhz: float):
    key = FLAGS_OF_CASE.get(cell["case"])
    if key is None or not steps:
        return None
    fast, integ, fl = key
    n = steps.get(f"{'fast' if fast else 'exact'},{integ},flags={fl}", {}).get("step_instructions")
    if not n:
        return None
    return n * cell["warp_steps"] / (sms * SCHEDULERS * clock_mhz * 1e6) * 1e3


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    args = sys.argv[1:]
    sass_dir = None
    if args[:1] == ["--sass"] and len(args) > 1:
        sass_dir = args[1]
        os.makedirs(sass_dir, exist_ok=True)
        args = args[2:]
    if not args:
        raise SystemExit(__doc__)
    roots = args
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # this checkout
    nvcc, cuobjdump, flags = _tools()
    with concurrent.futures.ThreadPoolExecutor(len(set(roots))) as pool:
        statics = {r: pool.submit(static, r, nvcc, cuobjdump, flags, sass_dir)
                   for r in dict.fromkeys(roots)}
        statics = {r: f.result() for r, f in statics.items()}
    for root in roots:
        run = json.loads(_run([sys.executable, __file__, "--one", root]).stdout.splitlines()[-1])
        st = statics[root]
        clock_mhz = float(run["clocks_under_load"].split(",")[0])
        for cell in run["cells"]:
            cell["issue_floor_ms"] = issue_floor(cell, st.get("steps", {}), run["sms"], clock_mhz)
        print(json.dumps({**run, **st}), flush=True)


if __name__ == "__main__":
    main()
