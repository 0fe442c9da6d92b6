"""The floor of the neural kernel's default tier: the least time a frame
could take on the card, as the largest of three terms.

* (t) tensor: the held and chunked layouts' `mma.sync.m16n8k16`
  instructions (`mma_count`) at the rate one SM issues them, measured by
  `nf_mma` (below): a loop of eight independent products a warp from
  registers, 32 warps an SM. The streamed layout's
  `wgmma.m64n64k16` instructions (`wgmma_count`) at the rate `nf_wgmma`
  measures: two warpgroups an SM, each issuing groups of 16 k-steps with A
  from registers and B from shared memory, one group in flight while the
  next is issued -- the streamed kernel's pattern.
* (i) issue: the SASS the frame must issue at one warp instruction per
  scheduler per clock. Per pixel the shortest path of the features and the
  shade (`nf_shade`: ray-gen, plane basis, features, envelope, rotation,
  star field, store) and the head's fmaf; per hidden output the shortest
  path of its epilogue (`nf_epi`: the bias, `tanhf`, the bf16 pack, less
  the loads and stores of `nf_epi_base`); per product its HMMA (mma.sync
  only: a wgmma is one instruction a warp for 64 x 64 x 16, which the term
  leaves out). The shortest path (`path_lengths`) skips every slow path,
  so the term is a floor of the instructions, not a count of what the
  kernel issues.
* (l) L2: the bf16 weight bytes a plan copies a frame (`weight_bytes`)
  over the L2 read rate, measured by `nf_l2`: every block of a full grid
  reads the same L2-resident buffer of the weights' size L2_REPS times with
  16-byte `ld.global.cg`.

`mma_count`, `wgmma_count`, `tanh_count` and `weight_bytes` are plain
functions of the net's widths (`dims`: the padded inputs, each hidden width, the outputs),
the plan (ops/neural_kernel.kernel_plan) and the pixel count. The CUDA
sources are strings compiled by tools/time_neural.py: BENCH_SOURCE stands
alone, PHASE_SOURCE includes a checkout's csrc/neural_mlp.cu, so the
phases are the kernel's own functions as built. `layer_bits` holds one
layer's sums by wgmma k-steps against mma.sync's, bit for bit, on
BENCH_SOURCE's `nf_layer_bits`. `bf16_chain` is the MLP as
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
WGMMA_M, WGMMA_N = 64, 64  # wgmma.m64n64k16 of the streamed layout: pixels, channels
# the streamed plan's register width, ring slots and pixels a round (its
# mma.sync predecessor had 2 slots)
STREAMED_REGS, STREAMED_STAGES, STREAMED_ROUND = 256, 4, 256
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


def wgmma_count(dims, pixels: int, round_px: int = STREAMED_ROUND) -> int:
    """wgmma.m64n64k16 instructions (a warpgroup's) of the hidden layers of
    the streamed layout over `pixels` pixels, taken in rounds of `round_px`
    (the last one's missing pixels computed too): each tile of 64 pixels
    takes (in / 16) x (out / 64) a layer."""
    per_tile = sum(k // MMA_K * (n // WGMMA_N) for k, n in zip(dims[:-2], dims[1:-1]))
    return math.ceil(pixels / round_px) * (round_px // WGMMA_M) * per_tile


def streamed(plan) -> bool:
    """A plan of the streamed layout on wgmma (kernel_plan's STREAMED_PLAN)."""
    return len(plan) > 3 and plan[3] == STREAMED_REGS and plan[2] == STREAMED_STAGES


def tanh_count(dims, pixels: int) -> int:
    """Hidden outputs (one bias, tanh and bf16 rounding each) over `pixels`."""
    return pixels * sum(dims[1:-1])


def hidden_weight_bytes(dims) -> int:
    """bf16 bytes of the hidden layers' W^T (the head is read apart)."""
    return 2 * sum(k * n for k, n in zip(dims[:-2], dims[1:-1]))


def weight_bytes(dims, plan, pixels: int, resident_blocks: int = SMS) -> int:
    """Bytes of weights a plan copies from L2 into shared memory a frame.
    `plan` is kernel_plan's (pixels a block, chunk rows, buffers[, register
    width]): the chunked layout (register width 0, or a 3-tuple) copies
    every hidden layer once for every block of pixels, the streamed one once
    for every round of a cluster (its `pixels a block`, 256); a held block
    (buffers 0) copies them once, and a frame has at most `resident_blocks`
    of those."""
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
                sms: int = SMS, cycles_per_wgmma: float | None = None) -> dict:
    """The three terms in ms, their largest (`floor_ms`) and their sum.
    `cycles_per_mma` / `cycles_per_wgmma`: SM clocks an SM takes for one
    mma.sync / wgmma.m64n64k16 (the streamed plan's, which needs it);
    `issue_pixel` and `issue_output`: SASS a pixel (features, shade, head)
    and a hidden output (epilogue); the SM clock under load. `mma` counts
    the plan's tensor instructions: mma.sync, or wgmma where streamed."""
    hz = clock_mhz * 1e6
    if streamed(plan):
        mma = wgmma_count(dims, pixels)
        t = mma * cycles_per_wgmma / (sms * hz) * 1e3
        hmma = 0  # asynchronous, one instruction a warp for 64 x 64 x 16
    else:
        mma = hmma = mma_count(dims, pixels)
        t = mma * cycles_per_mma / (sms * hz) * 1e3
    warp_ins = (pixels * issue_pixel + tanh_count(dims, pixels) * issue_output) / WARP + hmma
    i = warp_ins / (sms * SCHEDULERS * hz) * 1e3
    wb = weight_bytes(dims, plan, pixels)
    l2 = wb / l2_bytes_per_s * 1e3
    return {"mma": mma, "tanh": tanh_count(dims, pixels), "weight_bytes": wb,
            "instruction": "wgmma.m64n64k16" if streamed(plan) else "mma.sync.m16n8k16",
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

// The streamed layout's products (csrc/neural_mlp.cu ws_products):
// wgmma.m64n64k16, A from registers, B from shared memory as K-major core
// matrices without swizzle (LBO 1024 bytes, SBO 128), k-steps 2048 bytes
// apart.
__device__ __forceinline__ uint64_t nf_desc(const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((s & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void nf_wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void nf_mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two warpgroups a block, each issuing groups of 16 k-steps (a chunk of 64
// channels each) into two accumulators in turn, one group in flight while
// the next is issued, `iters` times (2 x 16 x iters wgmma a warpgroup).
__global__ void __launch_bounds__(256, 1) nf_wgmma_kernel(float* out, int iters) {
  extern __shared__ __align__(128) unsigned char sm[];  // 16 k-steps of B, 32 KB
  for (int i = threadIdx.x; i < 32768 / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0x35803580u, 0x35803580u, 0x35803580u,
                                                 0x35803580u);  // bf16 2^-20
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};  // bf16 1.0
  float d0[32], d1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.0f;
  const uint64_t desc = nf_desc(sm);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) nf_wgmma_n64(d0, a, desc + 128 * ks, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) nf_wgmma_n64(d1, a, desc + 128 * ks, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += d0[i] + d1[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ uint32_t nf_ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One layer's sums two ways for 64 rows a block (128 threads) of A (m x k
// bf16, row-major) against W^T (n x k bf16, row-major), k <= 256 a multiple
// of 16, n of 64: out_mma by mma.sync.m16n8k16 k-steps in order from a zero
// accumulator (the held layout's), out_wg by wgmma.m64n64k16 k-steps in
// order (the streamed layout's, B staged as its chunks), fp32 (m x n).
__global__ void nf_layer_bits_kernel(const uint16_t* __restrict__ a,
                                     const uint16_t* __restrict__ wt, int k, int n,
                                     float* __restrict__ out_mma, float* __restrict__ out_wg) {
  extern __shared__ __align__(128) unsigned char sm[];  // one chunk: 64 x k bf16
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const long r0 = blockIdx.x * 64L + 16 * warp + g, r1 = r0 + 8;
  uint32_t af[16][4];
#pragma unroll
  for (int ks = 0; ks < 16; ++ks) {
    if (16 * ks >= k) break;
    af[ks][0] = nf_ld32(a + r0 * k + 16 * ks + 2 * t);
    af[ks][1] = nf_ld32(a + r1 * k + 16 * ks + 2 * t);
    af[ks][2] = nf_ld32(a + r0 * k + 16 * ks + 8 + 2 * t);
    af[ks][3] = nf_ld32(a + r1 * k + 16 * ks + 8 + 2 * t);
  }
  for (int n0 = 0; n0 < n; n0 += 64) {
    for (int j = 0; j < 8; ++j) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint16_t* b = wt + static_cast<long>(n0 + 8 * j + g) * k + 2 * t;
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) {
        if (16 * ks >= k) break;
        nf_mma16816(c, af[ks], nf_ld32(b + 16 * ks), nf_ld32(b + 16 * ks + 8));
      }
      const int col = n0 + 8 * j + 2 * t;
      out_mma[r0 * n + col] = c[0];
      out_mma[r0 * n + col + 1] = c[1];
      out_mma[r1 * n + col] = c[2];
      out_mma[r1 * n + col + 1] = c[3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * k; i += blockDim.x) {  // 16 bytes: (k group, 8 rows, row)
      const int r = i % 8, ci = (i / 8) % 8, kg = i / 64;
      *reinterpret_cast<uint4*>(sm + kg * 1024 + ci * 128 + r * 16) =
          *reinterpret_cast<const uint4*>(wt + static_cast<long>(n0 + 8 * ci + r) * k + 8 * kg);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.0f;
    const uint64_t desc = nf_desc(sm);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      if (16 * ks >= k) break;
      nf_wgmma_n64(d, af[ks], desc + 128 * ks, ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      out_wg[r0 * n + col] = d[4 * j];
      out_wg[r0 * n + col + 1] = d[4 * j + 1];
      out_wg[r1 * n + col] = d[4 * j + 2];
      out_wg[r1 * n + col + 1] = d[4 * j + 3];
    }
    __syncthreads();
  }
}

extern "C" int nf_wgmma(float* out, int blocks, int iters, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(nf_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 32768);
  if (err != cudaSuccess) return static_cast<int>(err);
  nf_wgmma_kernel<<<blocks, 256, 32768, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_layer_bits(const void* a, const void* wt, int m, int k, int n, float* out_mma,
                             float* out_wg, void* stream) {
  nf_layer_bits_kernel<<<m / 64, 128, 64 * k * 2, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(wt), k, n, out_mma, out_wg);
  return static_cast<int>(cudaGetLastError());
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
WGMMA_ITERS = 2048  # nf_wgmma: 2 x 16 x WGMMA_ITERS wgmma a warpgroup, two warpgroups an SM
BITS_ROWS = 8192  # nf_layer_bits: rows of A a layer
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
    grid) with the SM clock read under it, the wgmma rate (nf_wgmma, one
    block an SM), the L2 read rate at each of L2_SIZES, and, if `dot`
    (hopper_probe.dot) is given, probe_dot<bf16>'s cycles an mma at
    DOT_SHAPE."""
    import ctypes

    phases = phase_counts(sass_walk.parse_sass(sass_walk.sass_of(paths["phase"], cuobjdump)))
    lib = ctypes.CDLL(str(paths["bench"]))
    lib.nf_mma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
    lib.nf_l2.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nf_wgmma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    wg_out = torch.empty(sms * 256, device="cuda")

    def wgmma():
        if lib.nf_wgmma(wg_out.data_ptr(), sms, WGMMA_ITERS, stream):
            raise RuntimeError("nf_wgmma launch failed")

    wgmma()
    wgmma_ms = _ms(torch, wgmma, 3)
    wg_clocks = sass_walk.sm_clock_under_load(wgmma, wgmma_ms)
    n_wgmma = sms * 2 * 2 * 16 * WGMMA_ITERS
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
                        "cycles_per_mma_sm": mma_ms * 1e-3 * mhz * 1e6 * sms / n_mma},
           "wgmma_rate": {"ms": wgmma_ms, "wgmma": n_wgmma, "clocks_under_load": wg_clocks,
                          "cycles_per_wgmma_sm": wgmma_ms * 1e-3 * float(wg_clocks.split(",")[0])
                          * 1e6 * sms / n_wgmma}}
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
                        sms=inputs["sms"],
                        cycles_per_wgmma=inputs["wgmma_rate"]["cycles_per_wgmma_sm"])
    terms.update(issue_pixel=pix, issue_output=out)
    return terms


def layer_bits(path, torch, wts) -> list:
    """For each W^T (out, in) in `wts` (bf16 on the card; in a multiple of
    16 up to 256, out of 64): the share of the sums of BITS_ROWS rows of
    random bf16 activations in [-1, 1) whose fp32 bits agree between
    wgmma.m64n64k16 k-steps in order (nf_layer_bits, B as the streamed
    layout's chunks) and mma.sync's, and the largest difference."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    lib.nf_layer_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = BITS_ROWS
    out = []
    for wt in wts:
        n, k = wt.shape
        a = (torch.rand((rows, k), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
        want = torch.empty((rows, n), device="cuda")
        got = torch.empty((rows, n), device="cuda")
        if lib.nf_layer_bits(a.data_ptr(), wt.contiguous().data_ptr(), rows, k, n,
                             want.data_ptr(), got.data_ptr(),
                             torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("nf_layer_bits launch failed")
        torch.cuda.synchronize()
        same = (want.view(torch.int32) == got.view(torch.int32)).double().mean().item()
        out.append({"shape": [n, k], "bit_same": same,
                    "max_abs_diff": (want - got).abs().max().item()})
    return out


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
