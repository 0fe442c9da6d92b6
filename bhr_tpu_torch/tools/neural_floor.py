"""The floor of the neural kernel's default tier: the least time a frame
could take on the card, as the largest of three terms.

* (t) tensor: the frame's `mma.sync.m16n8k16` instructions (`mma_count`)
  at the rate one SM issues them, measured by `nf_mma` (below): a loop of
  eight independent products a warp from registers, 32 warps an SM.
* (i) issue: the SASS the frame must issue at one warp instruction per
  scheduler per clock. Per pixel the shortest path of the features and the
  shade (`nf_shade`: ray-gen, plane basis, features, envelope, rotation,
  star field, store) and the head's fmaf; per hidden output the shortest
  path of its epilogue (`nf_epi`: the bias, `tanhf`, the bf16 pack, less
  the loads and stores of `nf_epi_base`); per product its HMMA. The
  shortest path (`path_lengths`) skips every slow path, so the term is a
  floor of the instructions, not a count of what the kernel issues.
* (l) L2: the bf16 weight bytes a plan copies a frame (`weight_bytes`)
  over the L2 read rate, measured by `nf_l2`: every block of a full grid
  reads the same L2-resident buffer of the weights' size L2_REPS times with
  16-byte `ld.global.cg`.

`mma_count`, `tanh_count` and `weight_bytes` are plain functions of the
net's widths (`dims`: the padded inputs, each hidden width, the outputs),
the plan (ops/neural_kernel.kernel_plan) and the pixel count. The CUDA
sources are strings compiled by tools/time_neural.py: BENCH_SOURCE stands
alone, PHASE_SOURCE includes a checkout's csrc/neural_mlp.cu, so the
phases are the kernel's own functions as built. `bf16_chain` is the MLP as
a PyTorch user writes it on the tensor cores, the yardstick beside the
kernel. Nothing here imports the package, so a tool can load this file
beside another checkout's package.
"""

from __future__ import annotations

import math

SMS = 132  # streaming multiprocessors of an H100 SXM
SCHEDULERS = 4  # warp schedulers an SM
WARP = 32
MMA_M, MMA_N, MMA_K = 16, 8, 16  # mma.sync.m16n8k16: pixels, channels, inputs
L2_REPS = 64  # reads of the buffer a block of nf_l2 makes


def mlp_dims(params, padded_inputs) -> list[int]:
    """[padded inputs, hidden widths..., outputs] of a net of (W (in, out), b)
    layers, the first layer's inputs padded by `padded_inputs`."""
    layers = list(params)
    return ([padded_inputs(layers[0][0].shape[0])] + [w.shape[1] for w, _ in layers[:-1]]
            + [layers[-1][0].shape[1]])


def mma_count(dims, pixels: int) -> int:
    """mma.sync.m16n8k16 instructions of the hidden layers over `pixels`
    pixels: each tile of 16 pixels takes (in / 16) x (out / 8) a layer."""
    per_tile = sum(k // MMA_K * (n // MMA_N) for k, n in zip(dims[:-2], dims[1:-1]))
    return math.ceil(pixels / MMA_M) * per_tile


def tanh_count(dims, pixels: int) -> int:
    """Hidden outputs (one bias, tanh and bf16 rounding each) over `pixels`."""
    return pixels * sum(dims[1:-1])


def hidden_weight_bytes(dims) -> int:
    """bf16 bytes of the hidden layers' W^T (the head is read apart)."""
    return 2 * sum(k * n for k, n in zip(dims[:-2], dims[1:-1]))


def weight_bytes(dims, plan, pixels: int, resident_blocks: int = SMS) -> int:
    """Bytes of weights a plan copies from L2 into shared memory a frame.
    `plan` is kernel_plan's (pixels a block, chunk rows, buffers[, register
    width]): the chunked layout (register width 0, or a 3-tuple) and a
    streamed fused block (buffers > 0) copy every hidden layer once for
    every block of pixels; a fused block with its weights held (buffers 0)
    copies them once, and a frame has at most `resident_blocks` of those."""
    pix, _, nbuf, *rest = plan
    regs = rest[0] if rest else 0
    blocks = math.ceil(pixels / pix)
    if regs and nbuf == 0:
        blocks = min(blocks, resident_blocks)
    return blocks * hidden_weight_bytes(dims)


def head_ops(dims) -> int:
    """The head's fmaf a pixel: one for each input and output."""
    return dims[-2] * dims[-1]


def floor_terms(dims, plan, pixels: int, *, cycles_per_mma: float, issue_pixel: float,
                issue_output: float, l2_bytes_per_s: float, clock_mhz: float,
                sms: int = SMS) -> dict:
    """The three terms in ms, their largest (`floor_ms`) and their sum.
    `cycles_per_mma`: SM clocks an SM takes for one mma.sync; `issue_pixel`
    and `issue_output`: SASS a pixel (features, shade, head) and a hidden
    output (epilogue); the SM clock under load."""
    hz = clock_mhz * 1e6
    mma = mma_count(dims, pixels)
    t = mma * cycles_per_mma / (sms * hz) * 1e3
    warp_ins = (pixels * issue_pixel + tanh_count(dims, pixels) * issue_output) / WARP + mma
    i = warp_ins / (sms * SCHEDULERS * hz) * 1e3
    wb = weight_bytes(dims, plan, pixels)
    l2 = wb / l2_bytes_per_s * 1e3
    return {"mma": mma, "tanh": tanh_count(dims, pixels), "weight_bytes": wb,
            "warp_instructions": warp_ins, "tensor_ms": t, "issue_ms": i, "l2_ms": l2,
            "floor_ms": max(t, i, l2), "sum_ms": t + i + l2,
            "bound_by": ("tensor", "issue", "l2")[[t, i, l2].index(max(t, i, l2))]}


# ---- the SASS ---------------------------------------------------------------------


def path_lengths(ins) -> tuple[int, int]:
    """(shortest, longest) count of instructions from a function's entry to
    an EXIT, over sass_walk.parse_sass's Ins list, each conditional branch
    either way. A back edge is not followed (a loop's body counts once), a
    CALL counts as one instruction (its callee, a slow path, not at all)."""
    n = len(ins)
    index = {x.addr: k for k, x in enumerate(ins)}
    lo, hi = [math.inf] * (n + 1), [-math.inf] * (n + 1)
    for k in range(n - 1, -1, -1):
        x = ins[k]
        cond = x.pred not in (None, "@PT")
        if x.op.startswith(("EXIT", "RET")):
            lo[k], hi[k] = (1 + min(0, lo[k + 1]), 1 + max(0, hi[k + 1])) if cond else (1, 1)
            continue
        nxt = [k + 1]
        if x.op.startswith("BRA") and x.target is not None and x.target > x.addr:
            nxt = [k + 1, index[x.target]] if cond else [index[x.target]]
        lo[k] = 1 + min(lo[j] for j in nxt)
        hi[k] = 1 + max(hi[j] for j in nxt)
    return int(lo[0]), int(hi[0])


def phase_counts(funcs: dict) -> dict:
    """{phase: (shortest, longest)} of PHASE_SOURCE's kernels in a parsed
    listing, by the kernel's name."""
    out = {}
    for tag in ("nf_featuresILb0E", "nf_featuresILb1E", "nf_shadeILb0E", "nf_shadeILb1E",
                "nf_epi_base", "nf_epi"):
        name = next(f for f in funcs if tag in f and not (tag == "nf_epi" and "nf_epi_base" in f))
        out[tag.replace("ILb0E", "<schwarzschild>").replace("ILb1E", "<kerr>")] = \
            path_lengths(funcs[name])
    return out


def issue_per_pixel(phases: dict, dims, kerr: bool) -> tuple[float, float]:
    """(SASS a pixel, SASS a hidden output) of the issue term: the shade
    kernel's shortest path (its features included) and the head's fmaf; half
    the shortest path of the two-output epilogue less its frame."""
    model = "kerr" if kerr else "schwarzschild"
    pixel = phases[f"nf_shade<{model}>"][0] + head_ops(dims)
    output = (phases["nf_epi"][0] - phases["nf_epi_base"][0]) / 2 + 1.5  # + bias add, pack
    return pixel, output


# ---- CUDA sources ---------------------------------------------------------------------

BENCH_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

// Eight independent m16n8k16 bf16 products a warp, from registers, `iters`
// times; the sum is stored so that nothing is removed.
__global__ void nf_mma_kernel(float* out, int iters) {
  const uint32_t a = 0x3f803f80u, b = 0x35803580u;  // bf16 1.0 and 2^-20
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a), "r"(a), "r"(a), "r"(a), "r"(b), "r"(b));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Every block reads the whole buffer (n16 16-byte words) through L2,
// `reps` times.
__global__ void nf_l2_kernel(const uint4* __restrict__ buf, long n16, int reps, uint32_t* out) {
  uint32_t x = 0;
  for (int r = 0; r < reps; ++r) {
    for (long i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 v = __ldcg(buf + i);
      x ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (x == 0x9e3779b9u) out[blockIdx.x] = x;
}

extern "C" int nf_mma(float* out, int blocks, int threads, int iters, void* stream) {
  nf_mma_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_l2(const void* buf, long n16, int reps, uint32_t* out, int blocks,
                     int threads, void* stream) {
  nf_l2_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), n16, reps, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# One pixel a thread, compiled to a cubin only to be counted (tools/
# time_neural.py): the kernel's own per-pixel functions and epilogue.
PHASE_SOURCE = r"""
#include "neural_mlp.cu"

namespace bhr {

template <bool KERR>
__global__ void nf_features(const Params p, const float* frp, float* out) {
  constexpr int kF = KERR ? 22 : 16;
  const Frame fr{frp[0], frp[1], frp[2], frp[3], frp[4], frp[5]};
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  float f[kF];
  const Geo g = pixel_geometry<KERR>(p, fr, id / 1920, id % 1920, f);
  float* o = out + id * (kF + 7);
#pragma unroll
  for (int k = 0; k < kF; ++k) o[k] = f[k];
  o[kF] = g.c; o[kF + 1] = g.s; o[kF + 2] = g.whx; o[kF + 3] = g.why; o[kF + 4] = g.whz;
  o[kF + 5] = g.nyp; o[kF + 6] = g.t_env;
}

template <bool KERR>
__global__ void nf_shade(const Params p, const float* frp, const float* head, uint32_t* frame) {
  constexpr int kOut = KERR ? 3 : 2;
  const Frame fr{frp[0], frp[1], frp[2], frp[3], frp[4], frp[5]};
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  float h[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) h[o] = head[id * kOut + o];
  shade_pixel<KERR>(p, fr, id, 1920, h, 2020u, frame, nullptr, nullptr);
}

__global__ void nf_epi(const float* acc, const float* b, __nv_bfloat162* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = __floats2bfloat162_rn(tanhf(acc[2 * i] + b[0]), tanhf(acc[2 * i + 1] + b[1]));
}

__global__ void nf_epi_base(const float* acc, const float* b, __nv_bfloat162* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = __floats2bfloat162_rn(acc[2 * i] + b[0], acc[2 * i + 1] + b[1]);
}

template __global__ void nf_features<false>(const Params, const float*, float*);
template __global__ void nf_features<true>(const Params, const float*, float*);
template __global__ void nf_shade<false>(const Params, const float*, const float*, uint32_t*);
template __global__ void nf_shade<true>(const Params, const float*, const float*, uint32_t*);

}  // namespace bhr
"""


# ---- building and measuring the inputs -------------------------------------------

DOT_SHAPE = (16384, 1024, 1024)  # probe_dot<bf16>: M, K, N
MMA_BLOCKS_PER_SM, MMA_THREADS, MMA_ITERS = 4, 256, 4096
L2_SIZES = (69632, 278528)  # N1's and N2's hidden weights in bf16 (inputs padded)


def _run(cmd) -> str:
    import subprocess

    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build_floor(nvcc: str, nvcc_flags, csrc, out_dir) -> dict:
    """Compile BENCH_SOURCE into out_dir/nf_bench.so and PHASE_SOURCE
    (against the checkout's csrc/) into out_dir/nf_phase.cubin, the two nvcc
    calls in parallel -> their paths."""
    import concurrent.futures
    from pathlib import Path

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "nf_bench.cu").write_text(BENCH_SOURCE)
    (out / "nf_phase.cu").write_text(PHASE_SOURCE)
    flags = list(nvcc_flags)
    cubin = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    jobs = [[nvcc, *flags, "-o", str(out / "nf_bench.so"), str(out / "nf_bench.cu")],
            [nvcc, *cubin, "-cubin", "-I", str(csrc), "-o", str(out / "nf_phase.cubin"),
             str(out / "nf_phase.cu")]]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_run, cmd) for cmd in jobs]:
            f.result()
    return {"bench": out / "nf_bench.so", "phase": out / "nf_phase.cubin"}


def _ms(torch, fn, n: int, repeats: int = 5) -> float:
    import statistics

    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs)


def measure_inputs(paths: dict, torch, sass_walk, cuobjdump: str, dot=None) -> dict:
    """The floor's measured inputs on the current card: the shortest paths
    of the phases in paths["phase"], the mma rate (nf_mma over a full
    grid) with the SM clock read under it, the L2 read rate at each of
    L2_SIZES, and, if `dot` (hopper_probe.dot) is given, probe_dot<bf16>'s
    cycles an mma at DOT_SHAPE."""
    import ctypes

    phases = phase_counts(sass_walk.parse_sass(sass_walk.sass_of(paths["phase"], cuobjdump)))
    lib = ctypes.CDLL(str(paths["bench"]))
    lib.nf_mma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
    lib.nf_l2.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    blocks = sms * MMA_BLOCKS_PER_SM
    out = torch.empty(blocks * MMA_THREADS, device="cuda")

    def mma():
        if lib.nf_mma(out.data_ptr(), blocks, MMA_THREADS, MMA_ITERS, stream):
            raise RuntimeError("nf_mma launch failed")

    mma()
    mma_ms = _ms(torch, mma, 3)
    n_mma = blocks * MMA_THREADS // WARP * 8 * MMA_ITERS
    clocks = sass_walk.sm_clock_under_load(mma, mma_ms)
    mhz = float(clocks.split(",")[0])
    l2 = {}
    for nbytes in L2_SIZES:
        buf = torch.zeros(nbytes // 4, dtype=torch.int32, device="cuda")
        sink = torch.zeros(sms * 2, dtype=torch.int32, device="cuda")

        def read():
            if lib.nf_l2(buf.data_ptr(), nbytes // 16, L2_REPS, sink.data_ptr(), sms * 2, 512,
                         stream):
                raise RuntimeError("nf_l2 launch failed")

        read()
        ms = _ms(torch, read, 3)
        l2[str(nbytes)] = {"ms": ms, "bytes_per_s": sms * 2 * L2_REPS * nbytes / (ms * 1e-3)}
    run = {"phases": phases, "sms": sms, "l2_read": l2,
           "mma_rate": {"ms": mma_ms, "mma": n_mma, "clocks_under_load": clocks,
                        "cycles_per_mma_sm": mma_ms * 1e-3 * mhz * 1e6 * sms / n_mma}}
    if dot is not None:
        gen = torch.Generator(device="cuda").manual_seed(1)
        m, k, n = DOT_SHAPE
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        dot(a, b, prec="bf16")
        dot_ms = _ms(torch, lambda: dot(a, b, prec="bf16"), 1)
        dot_mma = (m // MMA_M) * (n // MMA_N) * (k // MMA_K)
        run["probe_dot_bf16"] = {"shape": DOT_SHAPE, "ms": dot_ms, "mma": dot_mma,
                                 "cycles_per_mma_sm": dot_ms * 1e-3 * mhz * 1e6 * sms / dot_mma}
    return run


def frame_floor(inputs: dict, dims, plan, pixels: int, kerr: bool, clock_mhz: float) -> dict:
    """floor_terms for a net of `dims` at `plan` over `pixels`, from
    measure_inputs' numbers, the L2 rate taken at the nearer weight size."""
    pix, out = issue_per_pixel(inputs["phases"], dims, kerr)
    size = min(L2_SIZES, key=lambda b: abs(b - hidden_weight_bytes(dims)))
    terms = floor_terms(dims, plan, pixels, cycles_per_mma=inputs["mma_rate"]["cycles_per_mma_sm"],
                        issue_pixel=pix, issue_output=out, clock_mhz=clock_mhz,
                        l2_bytes_per_s=inputs["l2_read"][str(size)]["bytes_per_s"],
                        sms=inputs["sms"])
    terms.update(issue_pixel=pix, issue_output=out)
    return terms


def bf16_chain(layers, feats):
    """The MLP as a PyTorch user writes it on the tensor cores: bf16
    operands and `torch.matmul`, the bias and `torch.tanh` layer by layer,
    every intermediate in bf16. `layers` are (W (in, out), b) already in
    bf16, `feats` (pixels, in) in bf16. Each layer's sum is rounded to bf16
    before its bias, so it is not the kernel's function, only its nearest
    library call."""
    import torch

    x = feats
    for i, (w, b) in enumerate(layers):
        x = torch.matmul(x, w) + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x
