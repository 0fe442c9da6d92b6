"""Time the neural surrogate's kernel of one or more checkouts on the card.

    python3 bhr_tpu_torch/tools/time_neural.py [--floor] [--variants[=PREFIX]] ROOT [ROOT ...]

Each ROOT is a checkout of the repo. The script runs itself once per ROOT in
a process of its own, which imports that checkout's bhr_tpu_torch (and
builds its csrc/neural_mlp.cu), and prints one JSON line per ROOT: nvcc's
-Xptxas -v lines for neural_render_kernel (registers, spills, shared memory
of each instantiation), the card's name and power limit, and for each case
at 1920x1080 -- N1 and N2 at the default tier (the committed nets; N2 at
spin 0.9, camera [15,5,0]), the orbit net at the default tier, N1 and N2 at
the highest (N2 on the fp32-trained Kerr net) -- the block plan, the frame
kernel's ms (utils/timing.device_time_ms: the median of REPEATS batches of
20 launches queued behind a spin kernel, so the card's time, not the
host's issue), a
hash of its output, the share of the bit-equal pixels against the plain
version, the cuBLAS MLP chain's ms (models/neural.mlp_apply at the tier, on
random features) and, at the default tier, the bf16 chain's
(tools/neural_floor.bf16_chain: bf16 torch.matmul, bias and torch.tanh);
the direction planes (N3) and a band of 270 rows (N4) of the same net with
their ms and hashes, the band against the frame's rows; and nvidia-smi's SM
clock and power draw, read while 0.6 s of frames run.

--floor adds the default tier's floor (tools/neural_floor.py): the rate of
mma.sync an SM issues and the L2 read rate at the weights' sizes, both
measured here; probe_dot<bf16> at a large shape beside the first; the
shortest SASS paths of ROOT's per-pixel phases and tanh epilogue, from
cuobjdump of ROOT's csrc/neural_mlp.cu; and for each default case the
terms (t), (i), (l) at ROOT's plan, the floor, their sum and the frame's
share of the floor.

--variants times N1 and N2 default frames of ROOT's kernel built again with
one change each (VARIANTS, those whose name starts with PREFIX; the time
only, their frames are wrong or the same). Of the chunked layout
(neural_render_kernel<KERR, false>, the committed nets' plan before the
fused kernel): tanh as the identity, no per-pixel phases, no weight copies
after the first chunk, one block an SM. Of the held fused layout
(neural_fused_kernel, "fused_", N1): tanh as the identity, no per-pixel
phases, 8 or 16 warps, a staggered start, the head unrolled or left out. Of
the streamed layout (neural_fused_kernel_ws, "streamed_", N2): tanh as the
identity, the pixel warps without the features, the head or the pixel's
end. A ROOT whose source lacks the text a variant rewrites reports it as not
applicable.

Compare two commits within one call, in the order parent, change, change,
parent.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

W, H, BAND = 1920, 1080, 270
REPEATS = 5
SIDE = ([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
# (name, model, asset, tier, spin, side camera)
CASES = (("n1", "schwarzschild", "neural_schwarzschild.npz", "default", 0.0, False),
         ("n2", "kerr", "neural_kerr.npz", "default", 0.9, True),
         ("n1_orbit", "schwarzschild", "neural_schwarzschild_orbit.npz", "default", 0.0, False),
         ("n1_fp32", "schwarzschild", "neural_schwarzschild.npz", "highest", 0.0, False),
         ("n2_fp32", "kerr", "neural_kerr_default.npz", "highest", 0.9, True))
# Each variant: (source text, replacement) pairs, each of which must occur;
# every occurrence is replaced.
VARIANTS = {
    "tanh_identity": [
        ("__floats2bfloat162_rn(tanhf(acc[j][0] + b0), tanhf(acc[j][1] + b1))",
         "__floats2bfloat162_rn(acc[j][0] + b0, acc[j][1] + b1)"),
        ("__floats2bfloat162_rn(tanhf(acc[j][2] + b0), tanhf(acc[j][3] + b1))",
         "__floats2bfloat162_rn(acc[j][2] + b0, acc[j][3] + b1)")],
    "no_pixel_phases": [
        ("    if (id < n_pixels) {\n      pixel_geometry<KERR>(p, fr, static_cast<int>(id / width),"
         " static_cast<int>(id % width), f);\n    } else {", "    {"),
        ("      shade_pixel<KERR>(p, fr, id, width, head, seed_term, frame, vel, status);\n"
         "    }\n  }\n}", "      frame[id] = __float_as_uint(head[0]);\n    }\n  }\n}")],
    "no_copies_after_first": [
        ("        stage_chunk(mlp, l1, n1, wbuf + ((s + 1) % 2) * chunk_elems, ld);",
         "        if (s == 0) stage_chunk(mlp, l1, n1, wbuf + ((s + 1) % 2) * chunk_elems, ld);")],
    "one_block_an_sm": [
        ("  const int64_t smem = smem_bytes<HI>(mlp);",
         "  const int64_t smem = smem_bytes<HI>(mlp) > 119808 ? smem_bytes<HI>(mlp) : 119808;")],
    # the fused layout (neural_fused_kernel)
    "fused_tanh_identity": [("tanhf(acc[m][j][", "(acc[m][j][")],
    "fused_no_pixel_phases": [
        ("        g = pixel_geometry<KERR>(p, fr, static_cast<int>(id / width),\n"
         "                                 static_cast<int>(id % width), f);", ""),
        ("      shade_geo<KERR>(p, fr, id, g, head, seed_term, frame, vel, status);",
         "      frame[id] = __float_as_uint(head[0]);")],
    "fused_16_warps": [
        ("return regs == 128 ? 12 : 8;", "return regs == 128 ? 16 : 8;"),
        ("m.pix != 32 * fused_warps(m.regs)", "false")],
    "fused_8_warps": [
        ("return regs == 128 ? 12 : 8;", "return regs == 128 ? 8 : 8;"),
        ("m.pix != 32 * fused_warps(m.regs)", "false")],
    "fused_stagger": [
        ("  if (held) cp_async_wait(0);\n  __syncthreads();",
         "  if (held) cp_async_wait(0);\n  __syncthreads();\n"
         "  if (held) __nanosleep(warp / 4 * 9000);")],
    "fused_head_unroll": [
        ("  for (int k = 0; k < k_head; k += 8) {\n    const uint4 v",
         "#pragma unroll 4\n  for (int k = 0; k < k_head; k += 8) {\n    const uint4 v")],
    "fused_no_head": [
        ("      fused_head<kOut>(stg + lane * F::kLd, hw, k_head, mlp.b[lh], head);",
         "      head[0] = head[1] = head[kOut - 1] = 0.0f;")],
    # the streamed layout (neural_fused_kernel_ws): its consumers' tanh the
    # identity; its pixel warps without the features, the head or the end
    "streamed_tanh_identity": [
        ("(tanhf(d[4 * j] + b0), tanhf(d[4 * j + 1] + b1))", "(d[4 * j] + b0, d[4 * j + 1] + b1)"),
        ("(tanhf(d[4 * j + 2] + b0), tanhf(d[4 * j + 3] + b1))",
         "(d[4 * j + 2] + b0, d[4 * j + 3] + b1)")],
    "streamed_no_features": [
        ("        g = pixel_geometry<KERR>(p, fr, static_cast<int>(id / width),\n"
         "                                 static_cast<int>(id % width), f);",
         "        f[0] = static_cast<float>(id % width);")],
    "streamed_no_head": [
        ("      fused_head<kOut>(stg_all + (wc * kWsM + i % kWsM) * kWsLd, hw, k_head, mlp.b[lh], "
         "head);", "      head[0] = head[kOut - 1] = 0.0f;")],
    "streamed_no_end": [
        ("      if (prev_id >= 0) shade_geo<KERR>(p, fr, prev_id, prev, head, seed_term, frame, "
         "vel, status);", "      if (prev_id >= 0) frame[prev_id] = __float_as_uint(head[0]);")],
}


def _floor_module():
    """tools/neural_floor.py of this script's own checkout, loaded apart
    from the package (ROOT's package may not have it)."""
    spec = importlib.util.spec_from_file_location(
        "neural_floor_of_time_neural", Path(__file__).with_name("neural_floor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(torch, fn, n: int) -> float:
    runs = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def _clocks_under_load(torch, fn, n: int) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, read while n
    launches of fn, issued beforehand, keep the card busy."""
    for _ in range(n):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return out.strip()


def _hash(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _plan4(plan) -> list:
    """A plan as (pixels, chunk, buffers, register width): a checkout whose
    plans have three entries has only the chunked layout (width 0)."""
    return list(plan) + [0] * (4 - len(plan))


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def floor_inputs(root: str, nf, build, torch, hopper_probe, sass_walk) -> dict:
    """neural_floor.measure_inputs with ROOT's phases and probe_dot."""
    tmp = Path(tempfile.mkdtemp(prefix="time_neural_"))
    paths = nf.build_floor(build.nvcc_path(), build.NVCC_FLAGS,
                           Path(root).resolve() / "bhr_tpu_torch" / "csrc", tmp)
    run = nf.measure_inputs(paths, torch, sass_walk,
                            sass_walk.cuobjdump_path(build.nvcc_path()), dot=hopper_probe.dot)
    shutil.rmtree(tmp, ignore_errors=True)
    return run


def variant_libs(root: str, build, prefix: str = "") -> dict:
    """{variant: loaded library or the reason it does not apply}: ROOT's
    neural_mlp.cu rewritten by each of VARIANTS whose name starts with
    `prefix`, built in parallel."""
    src = (Path(root) / "bhr_tpu_torch" / "csrc" / "neural_mlp.cu").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="time_neural_variants_"))
    shutil.copytree(Path(root) / "bhr_tpu_torch" / "csrc", tmp / "csrc")
    jobs, libs = {}, {}
    for name, edits in VARIANTS.items():
        if not name.startswith(prefix):
            continue
        text = src
        missing = [old for old, _ in edits if old not in text]
        if missing:
            libs[name] = f"not applicable: {len(missing)} of {len(edits)} rewrites do not match"
            continue
        for old, new in edits:
            text = text.replace(old, new)
        path = tmp / "csrc" / f"neural_mlp_{name}.cu"
        path.write_text(text)
        jobs[name] = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(tmp / f"{name}.so"),
                      str(path)]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(jobs))) as pool:
        done = {k: pool.submit(_run, cmd) for k, cmd in jobs.items()}
        logs = {k: f.result() for k, f in done.items()}
    real = build.load_neural_mlp()
    for name in jobs:
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in ("bhr_neural_render", "bhr_error_string"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = (lib, _ptxas(logs[name]))
    return libs


def _ptxas(log: str) -> list:
    """nvcc -Xptxas -v's register and spill lines of the neural kernels."""
    lines, tag = [], None
    for line in log.splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            tag = line.split("'")[1] if "'" in line else line.split()[-1]
        elif tag and "neural_" in tag and ("Used" in line or "spill" in line):
            lines.append(f"{tag}: {line.strip()}")
    return lines


def measure(root: str, floor: bool = False, variants: str | None = None) -> dict:
    sys.path.insert(0, root)
    import torch

    import bhr_tpu_torch as bt
    from bhr_tpu_torch.models import neural as tn
    from bhr_tpu_torch.models import neural_kerr as tnk
    from bhr_tpu_torch.ops import neural_kernel as nk
    from bhr_tpu_torch.tools import hopper_probe, sass_walk
    from bhr_tpu_torch.utils import build
    from bhr_tpu_torch.utils.timing import device_time_ms

    def kernel_ms(fn):  # the card's time of one launch, queued behind a spin kernel
        return device_time_ms(fn, iters=20, repeats=REPEATS, device="cuda")

    nf = _floor_module()
    if not torch.cuda.is_available():
        raise SystemExit("time_neural.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    ptxas = _ptxas(build.build("neural_mlp", build.NEURAL_MLP_SOURCES).log)
    inputs = floor_inputs(root, nf, build, torch, hopper_probe, sass_walk) if floor else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    cells = []
    for name, model, asset, tier, spin, side in CASES:
        params = (tnk if model == "kerr" else tn).load_params(tn.ASSETS_DIR / asset)[0].to("cuda")
        cam = bt.Camera.new(*SIDE) if side else bt.Camera.default()
        scene = bt.SceneParams(screen_width=W, screen_height=H, spin=spin)
        out = torch.empty((H, W), dtype=torch.int32, device="cuda")

        def frame():
            nk.neural_render_packed(params, cam, scene, precision=tier, device="cuda", out=out)

        frame()  # warm-up: the build and the weights' operands
        plain = nk.neural_render_packed_reference(params, cam, scene, precision=tier,
                                                  device="cuda")
        feats = torch.randn((W * H, params[0][0].shape[0]), generator=gen, device="cuda")
        tn.mlp_apply(params, feats, precision=tier)  # warm-up
        plan = _plan4(nk.kernel_plan(params, tier))
        cell = dict(case=name, tier=tier, hidden=list(params.widths), plan=plan,
                    ms=kernel_ms(frame), hash=_hash(out),
                    bit_same=(out == plain).float().mean().item(),
                    chain_ms=_ms(torch, lambda: tn.mlp_apply(params, feats, precision=tier), 1))
        cell["clocks_under_load"] = _clocks_under_load(torch, frame, int(600 / cell["ms"]) + 1)
        if tier == "default":
            bf = [(w.to(torch.bfloat16), b.to(torch.bfloat16)) for w, b in params]
            xb = feats.to(torch.bfloat16)
            nf.bf16_chain(bf, xb)  # warm-up
            cell["bf16_chain_ms"] = _ms(torch, lambda: nf.bf16_chain(bf, xb), 1)
            cell["band_bf16_chain_ms"] = _ms(torch, lambda: nf.bf16_chain(bf, xb[:W * BAND]), 1)
        dirs = nk.neural_trace_dirs(params, cam, scene, precision=tier, device="cuda")
        cell["dirs_ms"] = kernel_ms(lambda: nk.neural_trace_dirs(
            params, cam, scene, precision=tier, device="cuda", out=dirs))
        cell["dirs_hash"] = _hash(dirs.final_vel, dirs.status)
        band = torch.empty((BAND, W), dtype=torch.int32, device="cuda")
        cell["band_ms"] = kernel_ms(lambda: nk.neural_render_packed(
            params, cam, scene, precision=tier, device="cuda", out=band, row0=BAND,
            local_shape=(BAND, W)))
        cell["band_hash"] = _hash(band)
        cell["band_same_as_frame"] = (band == out[BAND:2 * BAND]).float().mean().item()
        cell["band_chain_ms"] = _ms(torch, lambda: tn.mlp_apply(
            params, feats[:W * BAND], precision=tier), 1)
        if inputs and tier == "default":
            dims = nf.mlp_dims(params, nk.padded_inputs)
            terms = nf.frame_floor(inputs, dims, plan, W * H, model == "kerr",
                                   float(cell["clocks_under_load"].split()[0]))
            terms["share"] = terms["floor_ms"] / cell["ms"]
            cell["floor"] = terms
        cells.append(cell)
        del feats, plain
    run = dict(root=root, card=smi.strip(), torch=torch.__version__, ptxas=ptxas, cells=cells)
    if inputs:
        run["floor_inputs"] = inputs
    if variants is not None:
        libs = variant_libs(root, build, variants)
        real = build.load_neural_mlp
        run["variants"] = {}
        for vname, built in libs.items():
            if isinstance(built, str):
                run["variants"][vname] = built
                continue
            lib, times = built[0], {"ptxas": built[1]}
            build.load_neural_mlp = lambda lib=lib: lib
            for name, model, asset, tier, spin, side in CASES[:2]:
                params = (tnk if model == "kerr" else tn).load_params(
                    tn.ASSETS_DIR / asset)[0].to("cuda")
                cam = bt.Camera.new(*SIDE) if side else bt.Camera.default()
                scene = bt.SceneParams(screen_width=W, screen_height=H, spin=spin)
                out = torch.empty((H, W), dtype=torch.int32, device="cuda")

                def frame():
                    nk.neural_render_packed(params, cam, scene, precision=tier, device="cuda",
                                            out=out)

                try:
                    frame()
                except RuntimeError as e:  # a variant the card refuses: recorded
                    times[name] = str(e)
                    continue
                times[name] = {"ms": kernel_ms(frame), "hash": _hash(out)}
            run["variants"][vname] = times
        build.load_neural_mlp = real
    return run


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        variants = next((a.partition("=")[2] for a in sys.argv[3:]
                         if a.startswith("--variants")), None)
        print(json.dumps(measure(sys.argv[2], "--floor" in sys.argv[3:], variants)), flush=True)
        return
    flags = [a for a in sys.argv[1:] if a == "--floor" or a.startswith("--variants")]
    roots = [a for a in sys.argv[1:] if a not in flags]
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root, *flags], check=True)


if __name__ == "__main__":
    main()
