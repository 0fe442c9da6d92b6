// Neural-surrogate render kernel for Hopper (sm_90a): N1 (Schwarzschild)
// and N2 (Kerr) in one source, N3, their direction-plane output, and N4,
// their row band.
//
// Replaces bhr_tpu/ops/neural_pallas.py:_build_kernel (the kernel of
// `_render`, :135-364): emit="frame", reached there through
// neural_render_packed, and emit="dirs" (:338-343), reached through
// neural_trace_dirs for frames with a texture skybox. Per pixel: ray-gen
// from the 32-float parameter struct (the layout of
// ops/trace_kernel.build_params), the plane basis,
// 16 features (22 for Kerr) in the order of models/neural.ray_features
// (models/neural_kerr.ray_features_kerr), the tanh MLP, the envelope, the
// in-plane rotation by delta (and for Kerr the tilt chi out of the plane),
// the analytic star field (starfield.cuh), captured rays black, and one
// packed RGBA word -- the only store to device memory.
//
// N3 is the same kernel up to the unit direction and the capture logit;
// where the launch gives direction planes instead of a frame, the thread
// stores the TraceResult's planes directly -- vel fp32 (H, W, 3) and status
// int32 (kCaptured where the logit is positive, else kEscaped), which the
// TPU wrapper assembles from four fp32 planes in a second pass -- and skips
// the star field. The switch is a runtime branch at the store, uniform over
// the launch, not a template parameter: everything before it is shared
// code, the branch costs one predicate a pixel, and the four instantiations
// (and their build time) stay four.
//
// N4 (bhr_tpu's neural_render_packed_band, neural_pallas.py:519-550, which
// its mesh calls for a band of rows) is the same launch over a band:
// `height` is the band's rows and P_ROW0 its first row in the frame, which
// the ray-gen adds to the local row and divides by the frame's height P_HF,
// so a band is bit for bit the same rows of the whole frame. A runtime
// argument again, not an instantiation; the outputs are indexed locally.
//
// Tiers, the arithmetic of models/neural.py:
//  * default: bf16 operands, fp32 accumulation, by
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on the tensor
//    cores, pixels as M, output channels as N, input channels as K (the
//    Kerr net's 22 features padded with zeros to K = 32, which is exact);
//    each output tile's k-steps are summed in order from 0 into one
//    accumulator; the bias and tanhf are fp32 and the result is rounded to
//    bf16 for the next layer; the head is an fmaf chain over k in order.
//    Three layouts (below) compute the same bits.
//  * highest (neural_render_kernel<KERR, true>): fp32 operands and fmaf
//    on the CUDA cores, over k in order for every output, then the bias,
//    then tanhf; no TF32.
// The per-pixel arithmetic around the MLP is written with correctly
// rounded, uncontracted operations (Arith<false>) and the full-precision
// tanhf, logf, log1pf, expf, sinf and cosf, in the order of the plain
// version ops/neural_kernel.neural_render_packed_reference, so that kernel
// and plain version differ only where the matrix sums are taken in another
// order. No --use_fast_math.
//
// Layout, default tier, held (neural_fused_kernel<KERR, 128>; the plan of
// every net up to 128 wide whose weights fit beside the staging rows). What
// holds it on this card, at 1920x1080 (tools/time_neural.py --floor,
// PERF.md): instruction issue -- each hidden output's tanhf is 16 SASS and 2
// SFU operations, beside which its 2.5 of products and loads are small --
// then the tensor cores, then the per-pixel phases. So:
//  * a warp owns 32 pixels (two m16 tiles) from the features to the store,
//    one pixel a lane in the per-pixel phases, and keeps a layer's input in
//    registers as A fragments (KMAX / 16 k-steps x 2 tiles x 4 registers);
//    its outputs go through its own staging rows in shared memory, read
//    back by ldmatrix as the next layer's fragments. No block barrier
//    between layers or for the per-pixel phases.
//  * the products of 16 output channels are woven with the tanh epilogue
//    of the 16 before them (step16), so that one warp's instruction stream
//    feeds the tensor cores and the ALU / SFU together.
//  * persistent blocks, one an SM (162 registers a thread), taking rounds of
//    32 pixels a warp in turn; the weights (N1's 74 KB) copied once a block
//    and held. (Its streamed branch, a ring of two 64-row chunks, is the
//    older design of wider nets, which no plan takes now: kept so that the
//    held instantiations stay the code they were.)
//  * the per-pixel geometry is computed once, with the features, and kept
//    in shared memory for the end.
//
// Layout, default tier, streamed (neural_fused_kernel_ws<KERR>; every other
// net up to 256 wide, N2's 22-256-256-256-3 among them). The same issue
// bound at 256 wide; with mma.sync on one instruction stream a warp, eight
// warps at 235 registers and a two-chunk ring the kernel took the sum of its
// tensor, issue and L2 terms. So the work is split among warpgroups that
// run at once, and the products leave the issue stream:
//  * two consumer warpgroups, 64 pixels each (wgmma's M): a layer is chunks
//    of 64 output channels (wgmma.m64n64k16, k-steps in order from 0 into
//    one accumulator, A from registers, B from the ring). Once a chunk's
//    products are done the next chunk's are issued, and the done chunk's
//    bias + tanhf + bf16 rounding runs beside them: the tensor cores no
//    longer take issue slots from tanhf. The first layer's outputs go
//    straight into the second's A fragments (FlashAttention-3's P.V
//    layout); later layers' through the warp's staging rows and ldmatrix.
//  * a producer warp keeps a ring of four 32-KB slots full (full and empty
//    mbarriers; consumers only wait and arrive): a slot holds one layer's
//    chunks that fit (the first layer's all), one cp.async.bulk by each
//    block of a cluster of two, multicast to both, so a chunk read from L2
//    feeds 256 pixels as before. A consumer warp releases a slot with the
//    default (block-scope) release: at cluster scope the arrival fenced
//    every earlier access and cost a third of the frame.
//  * a pixel warpgroup, one pixel a thread, runs the per-pixel phases beside
//    the MLP: round j's features, then round j - 1's head (the fmaf chain
//    over the warpgroup's staging rows) and end.
//  * setmaxnreg moves the registers: 192 a consumer thread, 104 a pixel
//    thread, 24 the producer's warpgroup (ptxas: 128 at entry for 512
//    threads, no spills). wgmma.m64n64k16 reaches 76% of the bf16 peak with
//    A from registers (m64n32k16 47%; tools/neural_floor.py's nf_wgmma), and
//    its k-step chain gives mma.sync's bits, so every frame is the held and
//    the chunked layouts' (nf_layer_bits). The card holds 66 clusters; at
//    4K what holds it is the pixel warpgroup's serial work beside the
//    consumers' tanhf (PERF.md).
//
// Layout, default tier, chunked (neural_render_kernel<KERR, false>; nets
// wider than 256, up to 1152). A block of `pix` pixels and 256 threads
// holds two activation buffers and one or two chunks of a layer's weights
// in shared memory. A layer streams its weights through the chunks,
// n_chunk output channels at a time, from device memory by cp.async; with
// two chunk buffers the next chunk's copy overlaps this chunk's products,
// and the first chunk's copy overlaps the features. Each warp computes 16
// pixels x 64 channels at a time. The head (2 or 3 outputs) is a per-pixel
// fmaf loop. The host picks pix, n_chunk and the buffers so that the block
// fits (ops/neural_kernel.kernel_plan).
//
// Layout, fp32 tier. What bounds it is the FMA pipe: 2 x (22 x 256 +
// 2 x 256 x 256 + 256 x 3) FLOPs a pixel of the 256-wide Kerr net against
// the fp32 peak, beside which a pixel's few hundred other operations and
// its 4 bytes are small. So the design keeps the FMA pipes fed:
//  * register tiles. A thread holds 8 pixels x 16 output channels, 128
//    accumulators, of a warp tile of 32 pixels x 128 channels. A k-step
//    reads two float4 of activations (4 distinct in the warp, broadcast)
//    and four of weights (8 distinct, one 128-byte row each) for 128 fmaf:
//    0.75 bytes of shared memory a FMA, without bank conflicts.
//  * a layer's whole output in registers. The block's 8 warps cover
//    pix x n_out <= 32768 outputs (pix = 256 for the 128-wide nets, 128 for
//    the 256-wide ones, 64 up to 512, 32 up to 1024; a layer narrower than
//    the widest leaves warps idle), so one activation buffer, hmax rows of
//    pix + 4 floats, channel-major, is enough: after a layer's last product
//    a barrier, then tanh(acc + b) overwrites it in place. A block of 128
//    pixels reads the 256-wide nets' weights from L2 half as often as one
//    of 64.
//  * weights in k-slabs: n_chunk rows of W (in, out) by all of the layer's
//    outputs, contiguous in device memory, copied by cp.async into one of
//    two slab buffers while the other one's products run, so a slab costs
//    one barrier and a layer one more. Slabs are 32 rows, or 16 where two of
//    32 do not fit; a single 16-row buffer, and a barrier more a slab, where
//    two do not fit either (896 and 1024 wide); the first slab's copy
//    overlaps the features.
//  * the head on every thread: its pix x (2 or 3) sums are fmaf chains
//    over k in order, spread over the 256 threads, and their outputs go
//    over the first slab buffer. The chains are not split over k: the
//    hidden layers' sums and cuBLAS's run in k order, so the frames stay
//    bit-equal to the plain version, where a split head's partial sums
//    would round otherwise and move directions near the capture fold.
// The per-pixel phases (features, envelope, rotation, star field, store)
// run one pixel a thread: on every thread for the 128-wide nets, on half
// of them for the 256-wide ones, whose 137,472 FMAs a pixel outweigh its
// 543 other operations 250 to 1.
//
// Bound, at 1920x1080 (chip_smoke.py counts it): the MLP's FLOPs over the
// tensor cores' bf16 peak (default) or the fp32 peak (highest), the
// per-pixel fp32 operations over the fp32 peak, or the 4 bytes a pixel
// written over the memory rate, whichever is largest -- the FLOPs, for
// every committed net.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "starfield.cuh"

namespace bhr {

constexpr int kMaxLayers = 8;

// The MLP as the wrapper prepared it (utils/build.py:MlpDesc), by value.
struct MlpDesc {
  int n_layers;
  int dims[kMaxLayers + 1];  // dims[0]: padded inputs; dims[l + 1]: layer l's outputs
  int pix;                   // pixels per block (streamed: a cluster's round)
  int n_chunk;               // default: output channels a weight chunk; fp32: W rows a slab
  int nbuf;                  // weight-chunk buffers: 2 overlaps copy and products; 0: all held
  int regs;                  // default tier: 0 chunked, 128 held fused, 256 streamed
  const void* w[kMaxLayers];   // layer l: W^T bf16 (see prep_weights), or W fp32
  const float* b[kMaxLayers];  // layer l: bias (dims[l + 1],), fp32
};

namespace {

constexpr int kThreads = 256;
constexpr int32_t kStatusEscaped = 1, kStatusCaptured = 2;  // ops/trace.py STATUS_*
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr float kBcFactor = static_cast<float>(2.598076211);
// h(p) of models/neural_kerr.bc_factor_kerr, lowest order first
__constant__ const float kBcPoly[7] = {3.196512167f,  -0.406504577f, -0.102461550f,
                                       -0.006447487f, 0.033141079f,  -0.081345290f,
                                       -0.090476836f};

template <bool HI>
struct Elem;

template <>
struct Elem<false> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T from(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float to(T x) { return __bfloat162float(x); }
};

template <>
struct Elem<true> {
  using T = float;
  static __device__ __forceinline__ T from(float x) { return x; }
  static __device__ __forceinline__ float to(T x) { return x; }
};

__host__ __device__ __forceinline__ int widest(const MlpDesc& m) {
  int h = 0;
  for (int l = 0; l < m.n_layers; ++l) h = m.dims[l] > h ? m.dims[l] : h;
  return h;
}

// Shared-memory layout. Default tier: two activation buffers, pixel-major,
// pix rows of hmax + 8 bf16 (16 bytes of padding: ldmatrix rows land in
// distinct banks), and each weight chunk n_chunk rows of W^T at the same
// stride. fp32 tier: one activation buffer, channel-major, hmax rows of
// pix + 4 floats (a float4 of 4 pixels a read; the 4 floats of padding put
// a warp's write-back rows in alternate halves of the banks), and each slab
// n_chunk rows of a layer's outputs, at most hmax floats.
template <bool HI>
__host__ __device__ __forceinline__ int act_stride(int hmax, int pix) {
  return HI ? pix + 4 : hmax + 8;
}

template <bool HI>
__host__ __device__ __forceinline__ int act_rows(int hmax, int pix) {
  return HI ? hmax : pix;
}

template <bool HI>
__host__ __device__ __forceinline__ int chunk_stride(int hmax) {
  return HI ? hmax : hmax + 8;
}

// The activation buffers and nbuf weight chunks (slabs), in bytes.
template <bool HI>
__host__ __device__ __forceinline__ int64_t smem_bytes(const MlpDesc& m) {
  const int h = widest(m);
  return ((HI ? 1 : 2) * static_cast<int64_t>(act_rows<HI>(h, m.pix)) * act_stride<HI>(h, m.pix) +
          static_cast<int64_t>(m.nbuf) * m.n_chunk * chunk_stride<HI>(h)) *
         static_cast<int64_t>(sizeof(typename Elem<HI>::T));
}

using A = Arith<false>;

// Per-frame constants: the radial unit vector from the hole to the camera.
struct Frame {
  float rs, r0, ux, uy, uz, spin;
};

__device__ __forceinline__ Frame frame_constants(const Params& p) {
  const Vec3 rel{A::sub(p.v[P_CAM], p.v[P_BH]), A::sub(p.v[P_CAM + 1], p.v[P_BH + 1]),
                 A::sub(p.v[P_CAM + 2], p.v[P_BH + 2])};
  const float r0 = A::sqrt(dot<false>(rel, rel));
  return Frame{p.v[P_RS], r0, A::div(rel.x, r0), A::div(rel.y, r0), A::div(rel.z, r0),
               p.v[P_SPIN]};
}

// One pixel's ray in the plane basis, its criticality coordinate (t, or
// Kerr's xi-shifted tk) and, into `f`, its features.
struct Geo {
  float c, s, whx, why, whz, nyp, t_env;
};

template <bool KERR>
__device__ __forceinline__ Geo pixel_geometry(const Params& p, const Frame& fr, int row, int col,
                                              float* f) {
  // ray-gen, as core/camera.generate_rays, normalised by a correctly
  // rounded rsqrt as bhr_tpu's kernel does; `row` is the band's local row,
  // P_ROW0 its first row in the frame (N4), P_HF the frame's height
  const int frame_row = row + static_cast<int>(p.v[P_ROW0]);
  const float u = A::mul(A::mul(A::sub(A::div(static_cast<float>(col), p.v[P_WF]), 0.5f), 2.0f),
                         p.v[P_ASPECT]);
  const float v = A::mul(A::sub(A::div(static_cast<float>(frame_row), p.v[P_HF]), 0.5f), -2.0f);
  const float uf = A::mul(u, p.v[P_FOVF]);
  const float vf = A::mul(v, p.v[P_FOVF]);
  Vec3 d;
  d.x = A::add(A::add(p.v[P_FWD], A::mul(p.v[P_RIGHT], uf)), A::mul(p.v[P_UP], vf));
  d.y = A::add(A::add(p.v[P_FWD + 1], A::mul(p.v[P_RIGHT + 1], uf)), A::mul(p.v[P_UP + 1], vf));
  d.z = A::add(A::add(p.v[P_FWD + 2], A::mul(p.v[P_RIGHT + 2], uf)), A::mul(p.v[P_UP + 2], vf));
  const float inv = A::rsqrt(dot<false>(d, d));
  d = Vec3{A::mul(d.x, inv), A::mul(d.y, inv), A::mul(d.z, inv)};

  // plane basis (neural_pallas.py:197-208)
  const float c = dot<false>(d, Vec3{fr.ux, fr.uy, fr.uz});
  const Vec3 w{A::sub(d.x, A::mul(c, fr.ux)), A::sub(d.y, A::mul(c, fr.uy)),
               A::sub(d.z, A::mul(c, fr.uz))};
  const float s_raw = A::sqrt(dot<false>(w, w));
  const float s_inv = A::div(1.0f, fmaxf(s_raw, 1e-12f));
  Geo g;
  g.c = c;
  g.whx = A::mul(w.x, s_inv);
  g.why = A::mul(w.y, s_inv);
  g.whz = A::mul(w.z, s_inv);
  const float s = fminf(fmaxf(s_raw, 0.0f), 1.0f);
  g.s = s;

  // features (neural_pallas.py:210-228; models/neural.ray_features)
  const float rs = fr.rs, r0 = fr.r0;
  const float r0s = A::mul(r0, s);
  const float t = A::sub(A::div(r0s, A::mul(kBcFactor, rs)), 1.0f);
  f[0] = A::div(rs, r0);
  f[1] = c;
  f[2] = s;
  f[3] = fminf(fmaxf(A::div(A::mul(kBcFactor, rs), A::add(r0s, 1e-6f)), 0.0f), 4.0f);
  f[4] = A::mul(0.25f, rs);
  f[5] = A::mul(0.25f, logf(r0));
  f[6] = A::mul(0.2f, logf(A::add(fabsf(t), 1e-3f)));
  f[7] = tanhf(A::mul(8.0f, t));
  float sk = s, ck = c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // double-angle octaves
    const float s2 = A::mul(A::mul(2.0f, sk), ck);
    const float c2 = A::sub(A::mul(ck, ck), A::mul(sk, sk));
    f[8 + 2 * i] = s2;
    f[9 + 2 * i] = c2;
    sk = s2;
    ck = c2;
  }
  g.t_env = t;
  g.nyp = 0.0f;
  if constexpr (KERR) {
    // spin block (neural_pallas.py:229-264; models/neural_kerr.py)
    const float spin = fr.spin;
    const float nyp = A::sub(A::mul(fr.uz, g.whx), A::mul(fr.ux, g.whz));
    const float xi = A::mul(spin, nyp);
    const float pp = -xi;
    float h = kBcPoly[6];  // c0 + p (c1 + p (c2 + ... + p c6)), innermost first
#pragma unroll
    for (int i = 5; i >= 0; --i) h = A::add(kBcPoly[i], A::mul(pp, h));
    const float bck = A::mul(A::add(2.0f, A::mul(A::sqrt(fmaxf(A::add(1.0f, xi), 0.0f)), h)), 0.5f);
    const float red = A::sqrt(fmaxf(A::sub(1.0f, A::div(rs, r0)), 0.04f));
    const float tk = A::sub(A::div(r0s, A::mul(A::mul(bck, rs), red)), 1.0f);
    f[16] = spin;
    f[17] = xi;
    f[18] = A::mul(spin, fr.uy);
    f[19] = A::mul(spin, g.why);
    f[20] = A::mul(0.2f, logf(A::add(fabsf(tk), 1e-3f)));
    f[21] = tanhf(A::mul(8.0f, tk));
    g.t_env = tk;
    g.nyp = nyp;
  }
  return g;
}

// D += A B for one m16n8k16 tile: bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each, the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes from device memory into shared memory without a register round
// trip (cp.async); completion is awaited with cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` (0 or 1) committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

// mbarriers in shared memory and bulk copies that complete on them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// One arrival that also expects `bytes` more of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from device memory into shared memory by the
// copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The default tier's chunk: out[:, n0 : n0 + n_chunk] =
// bf16(tanh(in @ W^T[n0 : n0 + n_chunk]^T + b)), with the chunk's W^T rows
// (n_chunk x k_in) in `wsm` and activations pixel-major (pix x ld). Warps
// take items of 16 pixels x 64 channels; fragments come by ldmatrix: A
// rows g and g + 8, columns 2t, 2t + 1 (+ 8); B column g, rows 2t, 2t + 1
// (+ 8); C rows g and g + 8, columns 2t, 2t + 1, for lane (g, t) =
// (lane / 4, lane % 4).
__device__ __forceinline__ void hidden_chunk_mma(const __nv_bfloat16* __restrict__ in,
                                                 const __nv_bfloat16* __restrict__ wsm,
                                                 __nv_bfloat16* __restrict__ out,
                                                 const float* __restrict__ bias, int ld, int k_in,
                                                 int n0, int n_chunk, int pix) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_sub = n_chunk / 64;
  const int items = (pix / 16) * n_sub;
  // this lane's ldmatrix rows: A matrices (rows +0/+8) x (k +0/+8), B
  // matrices (k +0/+8) x (channels +0/+8)
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
  for (int item = warp; item < items; item += kThreads / 32) {
    const int m0 = (item / n_sub) * 16;
    const int nn = (item % n_sub) * 64;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const __nv_bfloat16* a_base = in + (m0 + a_row) * ld + a_col;
    const __nv_bfloat16* b_base = wsm + (nn + b_row) * ld + b_col;
    // the fragments of k-step k0; b[jj] holds n-tiles 2 jj and 2 jj + 1
    auto load = [&](int k0, uint32_t(&a)[4], uint32_t(&b)[4][4]) {
      ldmatrix_x4(a, a_base + k0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ldmatrix_x4(b[jj], b_base + 16 * jj * ld + k0);
    };
    auto mmas = [&](const uint32_t(&a)[4], const uint32_t(&b)[4][4]) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mma_bf16(acc[2 * jj], a, b[jj][0], b[jj][1]);
        mma_bf16(acc[2 * jj + 1], a, b[jj][2], b[jj][3]);
      }
    };
    // two register stages: the next k-step's fragments load while this
    // one's products run
    uint32_t a0[4], b0[4][4], a1[4], b1[4][4];
    load(0, a0, b0);
    int k0 = 0;
    for (; k0 + 32 <= k_in; k0 += 32) {
      load(k0 + 16, a1, b1);
      mmas(a0, b0);
      if (k0 + 32 < k_in) load(k0 + 32, a0, b0);
      mmas(a1, b1);
    }
    if (k0 < k_in) mmas(a0, b0);  // an odd count of k-steps: the last is in stage 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + nn + 8 * j + 2 * t;
      const float b0 = bias[n], b1 = bias[n + 1];
      *reinterpret_cast<__nv_bfloat162*>(out + (m0 + g) * ld + n) =
          __floats2bfloat162_rn(tanhf(acc[j][0] + b0), tanhf(acc[j][1] + b1));
      *reinterpret_cast<__nv_bfloat162*>(out + (m0 + g + 8) * ld + n) =
          __floats2bfloat162_rn(tanhf(acc[j][2] + b0), tanhf(acc[j][3] + b1));
    }
  }
}

// Start copying `rows` rows of k_in bf16 (a multiple of 8), contiguous at
// `src`, into `dst` at row stride ld, spread over `threads` threads; the
// caller commits the group.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* __restrict__ dst, int ld,
                                           const __nv_bfloat16* __restrict__ src, int rows,
                                           int k_in, int threads) {
  constexpr int kVec = 8;  // bf16 a 16-byte copy moves
  const int vecs = k_in / kVec;
  for (int i = threadIdx.x; i < rows * vecs; i += threads) {
    const int r = i / vecs, v = i % vecs;
    cp_async16(dst + r * ld + v * kVec, src + static_cast<int64_t>(r) * k_in + v * kVec);
  }
}

// Start the copy of the default tier's weight chunk, output channels
// [n0, n0 + n_chunk) of layer l: n_chunk rows of W^T (k_in each, row stride
// ld) into `wsm`.
__device__ __forceinline__ void stage_chunk(const MlpDesc& m, int l, int n0,
                                            __nv_bfloat16* __restrict__ wsm, int ld) {
  const auto* w = static_cast<const __nv_bfloat16*>(m.w[l]);
  stage_rows(wsm, ld, w + static_cast<int64_t>(n0) * m.dims[l], m.n_chunk, m.dims[l], kThreads);
  cp_async_commit();
}

// The hidden layers' weight chunks in order: step s -> (layer, first channel).
__device__ __forceinline__ void chunk_of(const MlpDesc& m, int s, int& l, int& n0) {
  l = 0;
  while (s >= m.dims[l + 1] / m.n_chunk) {
    s -= m.dims[l + 1] / m.n_chunk;
    ++l;
  }
  n0 = s * m.n_chunk;
}

// ---- the fp32 tier --------------------------------------------------------

constexpr int kTileP = 8, kTileC = 16;     // a thread's pixels and channels
constexpr int kWarpP = 32, kWarpC = 128;   // a warp's
constexpr int kMaxOutputs = kThreads * kTileP * kTileC;  // a layer's, per block

// This thread's part of a layer of n_out outputs: warp w takes warp tile
// (w % (pix / 32), w / (pix / 32)) if there is one; lane (lp, lc) =
// (lane % 4, lane / 4) of it holds pixels p0 + 16 (i / 4) + i % 4 (i < 8)
// and channels c0 + 32 (j / 4) + j % 4 (j < 16), so that a k-step's loads
// are 4 consecutive float4 of pixels and 8 of channels across the warp.
struct TileFp32 {
  bool active;
  int p0, c0;
};

__device__ __forceinline__ TileFp32 tile_fp32(int pix, int n_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_p = pix / kWarpP;
  const int wp = warp % tiles_p, wc = warp / tiles_p;
  return TileFp32{warp < tiles_p * (n_out / kWarpC), kWarpP * wp + 4 * (lane % 4),
                  kWarpC * wc + 4 * (lane / 4)};
}

__device__ __forceinline__ int tile_channel(const TileFp32& t, int j) {
  return t.c0 + 32 * (j / 4) + j % 4;
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// W rows a slab of layer l: n_chunk, or the whole (16- or 32-wide) input.
__device__ __forceinline__ int slab_rows(const MlpDesc& m, int l) {
  return min(m.n_chunk, m.dims[l]);
}

// Start the copy of the slab of layer l's W (in, out) from row k0 into
// `wsm`: slab_rows x n_out floats, contiguous in device memory.
__device__ __forceinline__ void stage_slab(const MlpDesc& m, int l, int k0,
                                           float* __restrict__ wsm) {
  const int n_out = m.dims[l + 1];
  const float* w = static_cast<const float*>(m.w[l]) + static_cast<int64_t>(k0) * n_out;
  const int vecs = slab_rows(m, l) * n_out / 4;
  for (int i = threadIdx.x; i < vecs; i += kThreads) cp_async16(wsm + 4 * i, w + 4 * i);
  cp_async_commit();
}

// acc += act[k0 : k0 + rows, the tile's pixels]^T x slab[:, the tile's
// channels], one fmaf a product in order of k.
__device__ __forceinline__ void slab_fp32(const float* __restrict__ act, int ld,
                                          const float* __restrict__ ws, int n_out, int k0,
                                          int rows, const TileFp32& t,
                                          float (&acc)[kTileP][kTileC]) {
  const float* a = act + k0 * ld + t.p0;
  const float* w = ws + t.c0;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    float av[kTileP], wv[kTileC];
    load4(av, a + r * ld);
    load4(av + 4, a + r * ld + 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(wv + 4 * q, w + r * n_out + 32 * q);
#pragma unroll
    for (int i = 0; i < kTileP; ++i) {
#pragma unroll
      for (int j = 0; j < kTileC; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTileP][kTileC]) {
#pragma unroll
  for (int i = 0; i < kTileP; ++i) {
#pragma unroll
    for (int j = 0; j < kTileC; ++j) acc[i][j] = 0.0f;
  }
}

// A layer's end: tanh(acc + b) over the tile's place in the activations.
__device__ __forceinline__ void store_tanh(float* __restrict__ act, int ld,
                                           const float* __restrict__ bias, const TileFp32& t,
                                           const float (&acc)[kTileP][kTileC]) {
#pragma unroll
  for (int j = 0; j < kTileC; ++j) {
    const int c = tile_channel(t, j);
    const float b = bias[c];
    float v[kTileP];
#pragma unroll
    for (int i = 0; i < kTileP; ++i) v[i] = tanhf(acc[i][j] + b);
    store4(act + c * ld + t.p0, v);
    store4(act + c * ld + t.p0 + 16, v + 4);
  }
}

// The fp32 tier's hidden layers over the features in `act` (ld floats a
// row), with the first slab already staged into slab buffer 0; leaves the
// last hidden layer's outputs in `act`, visible to every thread.
__device__ __forceinline__ void mlp_fp32(const MlpDesc& m, float* __restrict__ act, int ld,
                                         float* __restrict__ slabs, int slab_elems) {
  const int last = m.n_layers - 2;  // the last hidden layer
  float acc[kTileP][kTileC];
  zero(acc);
  TileFp32 t = tile_fp32(m.pix, m.dims[1]);
  int l = 0, k0 = 0;
  for (int s = 0;; ++s) {
    const int rows = slab_rows(m, l);
    int l1 = l, k1 = k0 + rows;  // the next slab
    if (k1 == m.dims[l]) {
      ++l1;
      k1 = 0;
    }
    const bool more = l1 <= last, layer_end = l1 != l;
    cp_async_wait(0);
    __syncthreads();  // this slab is in place, and every thread is done with the last one
    if (m.nbuf == 2 && more) stage_slab(m, l1, k1, slabs + ((s + 1) % 2) * slab_elems);
    if (t.active) {
      slab_fp32(act, ld, slabs + (s % m.nbuf) * slab_elems, m.dims[l + 1], k0, rows, t, acc);
    }
    if (layer_end || m.nbuf == 1) __syncthreads();  // done with the activations / the slab
    if (m.nbuf == 1 && more) stage_slab(m, l1, k1, slabs);
    if (layer_end) {
      if (t.active) store_tanh(act, ld, m.b[l], t, acc);
      if (l == last) break;
      zero(acc);
      t = tile_fp32(m.pix, m.dims[l1 + 1]);
    }
    l = l1;
    k0 = k1;
  }
  __syncthreads();
}

// The head over the last hidden layer's outputs in `act`: one fmaf chain
// over k in order for each pixel and output, the order of the hidden
// layers' sums (and of cuBLAS's), spread over every thread -- chain
// c = o * pix + p for output o of pixel p, so that a warp reads 32
// consecutive pixels and one weight -- then the bias, into out[c].
template <int kOut>
__device__ __forceinline__ void head_fp32(const MlpDesc& m, const float* __restrict__ act, int ld,
                                          float* __restrict__ out) {
  const int lh = m.n_layers - 1, k_head = m.dims[lh];
  const float* wh = static_cast<const float*>(m.w[lh]);
  for (int c = threadIdx.x; c < kOut * m.pix; c += kThreads) {
    const int o = c / m.pix, px = c % m.pix;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < k_head; ++k) acc = fmaf(act[k * ld + px], wh[k * kOut + o], acc);
    out[c] = acc + m.b[lh][o];
  }
  __syncthreads();
}

// One pixel's end, from its head outputs: the envelope, the rotation, and
// the packed word of the star field (N1, N2) or the direction and the
// capture status (N3).
template <bool KERR>
__device__ __forceinline__ void shade_geo(const Params& p, const Frame& fr, int64_t id,
                                          const Geo& g, const float* head, uint32_t seed_term,
                                          uint32_t* __restrict__ frame, float* __restrict__ vel,
                                          int32_t* __restrict__ status) {
  constexpr int kOut = KERR ? 3 : 2;
  const float c = g.c, s = g.s;
  // envelope (neural_pallas.py:306-311): (rs/r0) s (1/4 + log1p(1 / (|t| + 0.02)) sigmoid(-8c))
  const float sig = A::div(1.0f, A::add(1.0f, expf(-A::mul(-8.0f, c))));
  const float spike = A::mul(log1pf(A::div(1.0f, A::add(fabsf(g.t_env), 2e-2f))), sig);
  const float e_d = A::mul(A::mul(A::div(fr.rs, fr.r0), s), A::add(0.25f, spike));
  const float delta = A::mul(head[0], e_d);
  const float cd = cosf(delta), sd = sinf(delta);
  const float cos_phi = A::sub(A::mul(c, cd), A::mul(s, sd));
  const float sin_phi = A::add(A::mul(s, cd), A::mul(c, sd));
  Vec3 v;
  if constexpr (KERR) {
    // the frame-dragging tilt out of the plane (neural_pallas.py:318-330)
    const float chi = A::mul(head[1], A::mul(e_d, A::add(fabsf(fr.spin), 1e-3f)));
    const float cc = cosf(chi), sc = sinf(chi);
    const float nxp = A::sub(A::mul(fr.uy, g.whz), A::mul(fr.uz, g.why));
    const float nzp = A::sub(A::mul(fr.ux, g.why), A::mul(fr.uy, g.whx));
    const float a = A::mul(cc, cos_phi), b = A::mul(cc, sin_phi);
    v.x = A::add(A::add(A::mul(a, fr.ux), A::mul(b, g.whx)), A::mul(sc, nxp));
    v.y = A::add(A::add(A::mul(a, fr.uy), A::mul(b, g.why)), A::mul(sc, g.nyp));
    v.z = A::add(A::add(A::mul(a, fr.uz), A::mul(b, g.whz)), A::mul(sc, nzp));
  } else {
    v.x = A::add(A::mul(cos_phi, fr.ux), A::mul(sin_phi, g.whx));
    v.y = A::add(A::mul(cos_phi, fr.uy), A::mul(sin_phi, g.why));
    v.z = A::add(A::mul(cos_phi, fr.uz), A::mul(sin_phi, g.whz));
  }
  const float vinv = A::rsqrt(dot<false>(v, v));
  v = Vec3{A::mul(v.x, vinv), A::mul(v.y, vinv), A::mul(v.z, vinv)};
  if (vel != nullptr) {  // N3: the direction and the capture status, unshaded
    vel[3 * id + 0] = v.x;
    vel[3 * id + 1] = v.y;
    vel[3 * id + 2] = v.z;
    status[id] = head[kOut - 1] > 0.0f ? kStatusCaptured : kStatusEscaped;
    return;
  }
  float r, gg, b;
  procedural_background<false>(v, seed_term, r, gg, b);
  const float live = head[kOut - 1] <= 0.0f ? 1.0f : 0.0f;  // logit > 0: captured, black
  frame[id] = quantize_half_up_rn(r, live) | (quantize_half_up_rn(gg, live) << 8) |
              (quantize_half_up_rn(b, live) << 16) | 0xFF000000u;
}

// shade_geo with the pixel's geometry computed again from its index.
template <bool KERR>
__device__ __forceinline__ void shade_pixel(const Params& p, const Frame& fr, int64_t id,
                                            int width, const float* head, uint32_t seed_term,
                                            uint32_t* __restrict__ frame, float* __restrict__ vel,
                                            int32_t* __restrict__ status) {
  float f[KERR ? 22 : 16];
  const Geo g =
      pixel_geometry<KERR>(p, fr, static_cast<int>(id / width), static_cast<int>(id % width), f);
  shade_geo<KERR>(p, fr, id, g, head, seed_term, frame, vel, status);
}

template <bool KERR, bool HI>
__global__ void __launch_bounds__(kThreads)
    neural_render_kernel(const Params p, const uint32_t seed_term, const int height,
                         const int width, const MlpDesc mlp, uint32_t* __restrict__ frame,
                         float* __restrict__ vel, int32_t* __restrict__ status) {
  using E = Elem<HI>;
  using T = typename E::T;
  constexpr int kFeats = KERR ? 22 : 16;
  constexpr int kOut = KERR ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pix = mlp.pix;
  // activations: two pixel-major buffers (pix x ld) in the default tier,
  // one channel-major (hmax x ld) in the fp32 one; weight chunks after them
  const int hmax = widest(mlp);
  const int ld = act_stride<HI>(hmax, pix);
  const int act_elems = act_rows<HI>(hmax, pix) * ld;
  const int chunk_elems = mlp.n_chunk * chunk_stride<HI>(hmax);
  T* act = reinterpret_cast<T*>(smem);
  T* wbuf = act + (HI ? 1 : 2) * act_elems;
  const int64_t n_pixels = static_cast<int64_t>(height) * width;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * pix;
  const Frame fr = frame_constants(p);

  // the first weight chunk streams in while the features are computed
  if constexpr (HI) {
    stage_slab(mlp, 0, 0, wbuf);
  } else {
    stage_chunk(mlp, 0, 0, wbuf, ld);
  }

  // 1. features, rounded to the tier's operand type; padding and pixels
  // past the frame's end are zeros
  for (int i = threadIdx.x; i < pix; i += kThreads) {
    const int64_t id = first + i;
    float f[kFeats];
    if (id < n_pixels) {
      pixel_geometry<KERR>(p, fr, static_cast<int>(id / width), static_cast<int>(id % width), f);
    } else {
#pragma unroll
      for (int k = 0; k < kFeats; ++k) f[k] = 0.0f;
    }
    const int step = HI ? ld : 1;
    T* x = HI ? act + i : act + i * ld;
#pragma unroll
    for (int k = 0; k < kFeats; ++k) x[k * step] = E::from(f[k]);
    for (int k = kFeats; k < mlp.dims[0]; ++k) x[k * step] = E::from(0.0f);
  }

  if constexpr (HI) {
    // 2. the hidden layers; 3. the head, its outputs over the first slab
    // buffer, which no copy needs any more
    mlp_fp32(mlp, act, ld, wbuf, chunk_elems);
    head_fp32<kOut>(mlp, act, ld, wbuf);
    // 4. the pixel's end
    for (int i = threadIdx.x; i < pix; i += kThreads) {
      const int64_t id = first + i;
      if (id >= n_pixels) continue;
      float head[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) head[o] = wbuf[o * pix + i];
      shade_pixel<KERR>(p, fr, id, width, head, seed_term, frame, vel, status);
    }
  } else {
    // 2. the hidden layers, weights streamed n_chunk output channels at a
    // time; with two chunk buffers the next chunk's copy overlaps this one's
    // products
    T* act2 = act + act_elems;
    const int lh = mlp.n_layers - 1;
    int steps = 0;
    for (int l = 0; l < lh; ++l) steps += mlp.dims[l + 1] / mlp.n_chunk;
    for (int s = 0; s < steps; ++s) {
      int l, n0;
      chunk_of(mlp, s, l, n0);
      T* wsm = wbuf + (mlp.nbuf == 2 ? (s % 2) * chunk_elems : 0);
      if (mlp.nbuf == 2 && s + 1 < steps) {
        int l1, n1;
        chunk_of(mlp, s + 1, l1, n1);
        stage_chunk(mlp, l1, n1, wbuf + ((s + 1) % 2) * chunk_elems, ld);
        cp_async_wait(1);
      } else {
        cp_async_wait(0);
      }
      __syncthreads();  // this chunk, and the layer's input, are in place
      hidden_chunk_mma(act, wsm, act2, mlp.b[l], ld, mlp.dims[l], n0, mlp.n_chunk, pix);
      __syncthreads();  // every warp is done with this chunk and this input
      if (n0 + mlp.n_chunk == mlp.dims[l + 1]) {
        T* tmp = act;
        act = act2;
        act2 = tmp;
      }
      if (mlp.nbuf == 1 && s + 1 < steps) {
        int l1, n1;
        chunk_of(mlp, s + 1, l1, n1);
        stage_chunk(mlp, l1, n1, wbuf, ld);
      }
    }

    // 3. the head (W^T (n_out, K)), a per-pixel fmaf loop, then the pixel's end
    const int k_head = mlp.dims[lh];
    const T* wh = static_cast<const T*>(mlp.w[lh]);
    for (int i = threadIdx.x; i < pix; i += kThreads) {
      const int64_t id = first + i;
      if (id >= n_pixels) continue;
      const T* h = act + i * ld;
      float head[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const T* w = wh + o * k_head;
        float acc = 0.0f;
        for (int k = 0; k < k_head; ++k) acc = fmaf(E::to(h[k]), E::to(w[k]), acc);
        head[o] = acc + mlp.b[lh][o];
      }
      shade_pixel<KERR>(p, fr, id, width, head, seed_term, frame, vel, status);
    }
  }
}

// ---- the default tier, held ---------------------------------------------
//
// A warp owns 32 pixels (two m16 tiles) from the features to the store. A
// layer's input stays in registers as mma A fragments (16 bytes a lane a
// k-step and tile); its outputs, 16 channels at a time, go through the
// bias, tanhf and the bf16 rounding into the warp's own staging rows in
// shared memory, which the next layer reads back as fragments by ldmatrix:
// no block barrier between layers. The weights (W^T, the mma's B) are read
// from shared memory by ldmatrix, once for both tiles. KMAX is the widest
// layer's register width, 128 (12 warps a block, 64 registers of A; the
// 256 the template also takes is instantiated by no launch); the inputs are
// 16 or 32 wide, the hidden layers 128 (shapes_ok).

// Warps a block of the fused layout at register width 128 or 256: as many
// as their registers and staging rows leave room for, one block an SM.
__host__ __device__ constexpr int fused_warps(int regs) { return regs == 128 ? 12 : 8; }

template <int KMAX>
struct Fused {
  static constexpr int kWarps = fused_warps(KMAX);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPix = kThreads;  // pixels a round: 32 a warp
  static constexpr int kLd = KMAX + 8;   // staging row: bf16, 16 bytes of padding
  static constexpr int kKs = KMAX / 16;  // k-steps of the widest layer
  static constexpr int kGeo = 8;         // floats of a pixel's geometry (7 used)
};

// The streamed ring's two "full" mbarriers and two counters of the warps
// done with a buffer, after the geometry (none when the weights are held).
constexpr int kRingBytes = 32;

// bf16 elements of the hidden layers' W^T held whole, row stride in + 8.
__host__ __device__ __forceinline__ int64_t held_weight_elems(const MlpDesc& m) {
  int64_t n = 0;
  for (int l = 0; l + 1 < m.n_layers; ++l) {
    n += static_cast<int64_t>(m.dims[l + 1]) * (m.dims[l] + 8);
  }
  return n;
}

// Shared memory of the fused block: each warp's staging rows, the weights
// (held whole when nbuf == 0, else nbuf chunks of n_chunk rows at the
// staging's stride), the head's weights in fp32 and each pixel's geometry.
__host__ __device__ __forceinline__ int64_t fused_smem_bytes(const MlpDesc& m, int k_out) {
  const int warps = fused_warps(m.regs), ld = m.regs + 8;
  const int64_t w = m.nbuf == 0 ? held_weight_elems(m)
                                : static_cast<int64_t>(m.nbuf) * m.n_chunk * ld;
  return (static_cast<int64_t>(warps) * 32 * ld + w) * 2 +
         (static_cast<int64_t>(k_out) * m.dims[m.n_layers - 1] + warps * 32 * 8) * 4 +
         (m.nbuf == 0 ? 0 : kRingBytes);
}

// This warp's A fragments of a layer of k_in inputs from its staging rows:
// tile m holds rows 16 m .. 16 m + 15, k-step ks columns 16 ks .. + 15.
template <int KMAX>
__device__ __forceinline__ void load_a(uint32_t (&a)[2][KMAX / 16][4],
                                       const __nv_bfloat16* __restrict__ stg, int k_in) {
  const int lane = threadIdx.x % 32;
  const int a_row = lane % 8 + ((lane / 8) % 2) * 8, a_col = (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < KMAX / 16; ++ks) {
    if (16 * ks >= k_in) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      ldmatrix_x4(a[m][ks], stg + (16 * m + a_row) * Fused<KMAX>::kLd + 16 * ks + a_col);
    }
  }
}

// 16 output channels of both tiles over KS k-steps: acc[m][j] = A W^T
// for n-tiles j = 0, 1, W^T's 16 rows at `w` (row stride ldw), summed in
// k-steps from 0 into one accumulator per tile, as the chunked layout sums
// them.
template <int KMAX, int KS>
__device__ __forceinline__ void products16(float (&acc)[2][2][4],
                                           const uint32_t (&a)[2][KMAX / 16][4],
                                           const __nv_bfloat16* __restrict__ w, int ldw) {
  const int lane = threadIdx.x % 32;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
  const __nv_bfloat16* b_base = w + b_row * ldw + b_col;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[4];  // n-tile 0: b[0], b[1]; n-tile 1: b[2], b[3]
    ldmatrix_x4(b, b_base + 16 * ks);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_bf16(acc[m][0], a[m][ks], b[0], b[1]);
      mma_bf16(acc[m][1], a[m][ks], b[2], b[3]);
    }
  }
}

// Pair p (0 .. 7) of this lane's 16 outputs of a 16-channel step:
// out[row, n : n + 2] = bf16(tanh(acc + b)), tile m = p / 2 % 2, n-tile
// j = p / 4, rows g (p even) or g + 8 (C fragments: rows g and g + 8 of
// each tile, columns 2t and 2t + 1).
template <int KMAX>
__device__ __forceinline__ void epilogue_pair(int p, const float (&acc)[2][2][4],
                                              const float* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m = (p / 2) % 2, j = p / 4, h = p % 2;
  const int n = 8 * j + 2 * t;
  const float b0 = bias[n], b1 = bias[n + 1];
  *reinterpret_cast<__nv_bfloat162*>(out + (16 * m + g + 8 * h) * Fused<KMAX>::kLd + n) =
      __floats2bfloat162_rn(tanhf(acc[m][j][2 * h] + b0), tanhf(acc[m][j][2 * h + 1] + b1));
}

template <int KMAX>
__device__ __forceinline__ void epilogue16(const float (&acc)[2][2][4],
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ out) {
#pragma unroll
  for (int p = 0; p < 8; ++p) epilogue_pair<KMAX>(p, acc, bias, out);
}

// products16 into `nxt` with the epilogue of `cur` woven in, its 8 pairs
// of outputs spread over the k-steps' products, so that a warp's instruction
// stream alternates tensor and ALU / SFU work (ptxas keeps a burst of
// products together otherwise).
template <int KMAX, int KS>
__device__ __forceinline__ void step16(float (&nxt)[2][2][4], const uint32_t (&a)[2][KMAX / 16][4],
                                       const __nv_bfloat16* __restrict__ w, int ldw,
                                       const float (&cur)[2][2][4],
                                       const float* __restrict__ bias,
                                       __nv_bfloat16* __restrict__ out) {
  // pair p follows k-step p * KS / 8: spread evenly over the k-steps
  const int lane = threadIdx.x % 32;
  const int b_row = lane % 8 + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 8;
  const __nv_bfloat16* b_base = w + b_row * ldw + b_col;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < 2; ++j) nxt[m][j][0] = nxt[m][j][1] = nxt[m][j][2] = nxt[m][j][3] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, b_base + 16 * ks);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_bf16(nxt[m][0], a[m][ks], b[0], b[1]);
      mma_bf16(nxt[m][1], a[m][ks], b[2], b[3]);
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      if (p * KS / 8 == ks) epilogue_pair<KMAX>(p, cur, bias, out);
    }
  }
}

// One layer of n_out outputs over KS k-steps of inputs, 16 channels at a
// time, software-pipelined: the products of channels n0 .. n0 + 15 are
// woven with the epilogue of the 16 before them (step16); the two sets of
// accumulators trade roles each step. `rows(n0, ldw)` gives W^T's row n0
// (a streamed layer waits there at a chunk's first row).
template <int KMAX, int KS, class Rows>
__device__ __forceinline__ void layer_pass(const uint32_t (&a)[2][KMAX / 16][4], Rows&& rows,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ stg, int n_out) {
  float acc0[2][2][4], acc1[2][2][4];
  int ldw;
  const __nv_bfloat16* w = rows(0, ldw);
  products16<KMAX, KS>(acc0, a, w, ldw);
  int n0 = 16;
  for (; n0 + 16 < n_out; n0 += 32) {
    w = rows(n0, ldw);
    step16<KMAX, KS>(acc1, a, w, ldw, acc0, bias + n0 - 16, stg + n0 - 16);
    w = rows(n0 + 16, ldw);
    step16<KMAX, KS>(acc0, a, w, ldw, acc1, bias + n0, stg + n0);
  }
  if (n0 < n_out) {
    w = rows(n0, ldw);
    step16<KMAX, KS>(acc1, a, w, ldw, acc0, bias + n0 - 16, stg + n0 - 16);
    epilogue16<KMAX>(acc1, bias + n0, stg + n0);
  } else {
    epilogue16<KMAX>(acc0, bias + n0 - 16, stg + n0 - 16);
  }
}

// The head of one pixel from its staging row h (k_head bf16): for each
// output an fmaf chain over k in order from 0 -- the chunked layout's -- on
// the head's weights in fp32 (hw, output-major), then the bias.
template <int kOut>
__device__ __forceinline__ void fused_head(const __nv_bfloat16* __restrict__ h,
                                           const float* __restrict__ hw, int k_head,
                                           const float* __restrict__ bias, float (&head)[kOut]) {
  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;
  for (int k = 0; k < k_head; k += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(h + k);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
    float x[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // bf16 pairs, the first in the low half
      x[2 * q] = __uint_as_float(u[q] << 16);
      x[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const float4 w0 = *reinterpret_cast<const float4*>(hw + o * k_head + k);
      const float4 w1 = *reinterpret_cast<const float4*>(hw + o * k_head + k + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[o] = fmaf(x[i], wv[i], acc[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) head[o] = acc[o] + bias[o];
}

template <bool KERR, int KMAX>
__global__ void __launch_bounds__(Fused<KMAX>::kThreads, 1)
    neural_fused_kernel(const Params p, const uint32_t seed_term, const int height,
                        const int width, const MlpDesc mlp, uint32_t* __restrict__ frame,
                        float* __restrict__ vel, int32_t* __restrict__ status) {
  using F = Fused<KMAX>;
  constexpr int kFeats = KERR ? 22 : 16;
  constexpr int kOut = KERR ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lh = mlp.n_layers - 1, k_head = mlp.dims[lh];
  const bool held = mlp.nbuf == 0;
  auto* stg_all = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stg = stg_all + warp * 32 * F::kLd;
  __nv_bfloat16* wsm = stg_all + F::kWarps * 32 * F::kLd;
  const int chunk_elems = mlp.n_chunk * F::kLd;
  float* hw = reinterpret_cast<float*>(
      wsm + (held ? held_weight_elems(mlp) : static_cast<int64_t>(mlp.nbuf) * chunk_elems));
  float* geo_all = hw + kOut * k_head;
  float* geo = geo_all + (warp * 32 + lane) * F::kGeo;
  auto* full = reinterpret_cast<uint64_t*>(geo_all + F::kThreads * F::kGeo);  // chunk landed
  auto* done = reinterpret_cast<int*>(full + 2);  // warps done with the buffer
  const Frame fr = frame_constants(p);
  const int64_t n_pixels = static_cast<int64_t>(height) * width;
  const int64_t rounds = (n_pixels + F::kPix - 1) / F::kPix;
  int steps = 0;  // weight chunks a round (streamed)
  for (int l = 0; l < lh && !held; ++l) steps += mlp.dims[l + 1] / mlp.n_chunk;
  // this block's chunks: `steps` in each of its rounds
  const int64_t chunks = held ? 0 : (rounds - blockIdx.x + gridDim.x - 1) / gridDim.x * steps;

  // Streamed: chunk c (weights in the order chunk_of gives, round after
  // round) goes into buffer c % 2 by bulk copies, one a row, completing on
  // full[c % 2]; the last warp done with chunk c copies chunk c + 2 into
  // its buffer. A warp waits only for its next chunk to land: no block
  // barrier, so warps drift apart by up to a chunk.
  auto issue = [&](int64_t c) {  // by one thread: one bulk copy of the chunk's rows
    const int b = static_cast<int>(c % 2);
    int l, n0;
    chunk_of(mlp, static_cast<int>(c % steps), l, n0);
    const int ld = mlp.dims[l] + 8;
    const unsigned bytes = 2u * ld * mlp.n_chunk;
    mbar_expect_tx(full + b, bytes);
    bulk_copy(wsm + b * chunk_elems,
              static_cast<const __nv_bfloat16*>(mlp.w[l]) + static_cast<int64_t>(n0) * ld, bytes,
              full + b);
  };
  auto release = [&](int64_t c) {  // this warp is done reading chunk c
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(done + c % 2, 1) == F::kWarps - 1;
      if (last) {
        done[c % 2] = 0;
        __threadfence_block();
      }
    }
    if (last && c + 2 < chunks) {  // lane 0 of the last warp
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(c + 2);
    }
  };

  // the weights: held, all of them once by cp.async; streamed, the first two
  // chunks (their copies overlap the first features)
  if (held) {  // rows of in + 8 in device memory too: one contiguous copy a layer
    int64_t off = 0;
    for (int l = 0; l < lh; ++l) {
      const int ld = mlp.dims[l] + 8;
      stage_rows(wsm + off, ld, static_cast<const __nv_bfloat16*>(mlp.w[l]), mlp.dims[l + 1], ld,
                 F::kThreads);
      off += static_cast<int64_t>(mlp.dims[l + 1]) * ld;
    }
    cp_async_commit();
  } else if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    done[0] = done[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const auto* wh = static_cast<const __nv_bfloat16*>(mlp.w[lh]);  // rows of k_head + 8
  for (int i = threadIdx.x; i < kOut * k_head; i += F::kThreads) {
    hw[i] = __bfloat162float(wh[i / k_head * (k_head + 8) + i % k_head]);
  }
  if (held) cp_async_wait(0);
  __syncthreads();
  if (!held && threadIdx.x == 0) {
    for (int64_t c = 0; c < 2 && c < chunks; ++c) issue(c);
  }
  int64_t s = 0;            // chunks waited for so far; chunk s - 1 is in buffer (s - 1) % 2
  int64_t to_release = -1;  // the chunk this warp read last and has not released

  for (int64_t rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x) {
    const int64_t id = rnd * F::kPix + warp * 32 + lane;
    const bool live = id < n_pixels;
    // 1. this lane's pixel: its features into its staging row, rounded to
    // bf16 and padded with zeros to dims[0]; its geometry kept for the end
    {
      float f[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) f[k] = 0.0f;
      Geo g{};
      if (live) {
        g = pixel_geometry<KERR>(p, fr, static_cast<int>(id / width),
                                 static_cast<int>(id % width), f);
      }
      uint4* row = reinterpret_cast<uint4*>(stg + lane * F::kLd);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (8 * q >= mlp.dims[0]) break;
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[8 * q + 2 * i], f[8 * q + 2 * i + 1]);
          u[i] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        row[q] = make_uint4(u[0], u[1], u[2], u[3]);
      }
      reinterpret_cast<float4*>(geo)[0] = make_float4(g.c, g.s, g.whx, g.why);
      reinterpret_cast<float4*>(geo)[1] = make_float4(g.whz, g.nyp, g.t_env, 0.0f);
    }
    __syncwarp();
    // 2. the hidden layers
    uint32_t a[2][F::kKs][4];
    load_a<KMAX>(a, stg, mlp.dims[0]);
    int64_t off = 0;  // layer l's W^T among the held weights
    for (int l = 0; l < lh; ++l) {
      __syncwarp();  // every lane has its fragments before the staging is written
      const int k_in = mlp.dims[l], n_out = mlp.dims[l + 1];
      auto rows = [&](int n0, int& ldw) -> const __nv_bfloat16* {
        ldw = k_in + 8;
        if (held) return wsm + off + static_cast<int64_t>(n0) * ldw;
        if (n0 % 64 == 0) {  // a chunk's first row: release the last one, wait for this one
          if (to_release >= 0) release(to_release);
          mbar_wait(full + s % 2, static_cast<unsigned>(s / 2) & 1u);
          to_release = s++;
        }
        return wsm + ((s - 1) % 2) * chunk_elems + (n0 % 64) * ldw;
      };
      const float* bias = mlp.b[l];
      if (k_in == 16) {
        layer_pass<KMAX, 1>(a, rows, bias, stg, n_out);
      } else if (k_in == 32) {
        layer_pass<KMAX, 2>(a, rows, bias, stg, n_out);
      } else if (KMAX == 128 || k_in == 128) {
        layer_pass<KMAX, 8>(a, rows, bias, stg, n_out);
      } else {
        layer_pass<KMAX, KMAX / 16>(a, rows, bias, stg, n_out);
      }
      off += static_cast<int64_t>(n_out) * (k_in + 8);
      __syncwarp();  // the layer's outputs are in the staging
      if (l + 1 < lh) load_a<KMAX>(a, stg, n_out);
    }
    if (to_release >= 0) {  // the round's last chunk, before the pixel's end
      release(to_release);
      to_release = -1;
    }
    // 3. the head, then the pixel's end
    if (live) {
      float head[kOut];
      fused_head<kOut>(stg + lane * F::kLd, hw, k_head, mlp.b[lh], head);
      const float4 g0 = reinterpret_cast<const float4*>(geo)[0];
      const float4 g1 = reinterpret_cast<const float4*>(geo)[1];
      const Geo g{g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z};
      shade_geo<KERR>(p, fr, id, g, head, seed_term, frame, vel, status);
    }
    __syncwarp();  // the staging is read before the next round's features
  }
}

template <bool KERR, int KMAX>
int launch_fused(const Params& p, uint32_t seed_term, int height, int width, const MlpDesc& mlp,
                 uint32_t* frame, float* vel, int32_t* status, cudaStream_t s) {
  const int64_t smem = fused_smem_bytes(mlp, KERR ? 3 : 2);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = neural_fused_kernel<KERR, KMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Fused<KMAX>::kThreads,
                                                           static_cast<size_t>(smem))) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent blocks: as many as are resident, each taking rounds in turn
  const int64_t rounds = (static_cast<int64_t>(height) * width + Fused<KMAX>::kPix - 1) /
                         Fused<KMAX>::kPix;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(rounds < resident ? rounds : resident);
  kernel<<<blocks, Fused<KMAX>::kThreads, static_cast<size_t>(smem), s>>>(
      p, seed_term, height, width, mlp, frame, vel, status);
  return static_cast<int>(cudaGetLastError());
}

// ---- the default tier, streamed: warpgroups on wgmma ----------------------
//
// neural_fused_kernel_ws<KERR> (the source header's note says why it is so):
// a block is two consumer warpgroups (the hidden layers on wgmma, 64
// pixels each), the producer's warpgroup (one warp keeps the weight ring
// full; three idle) and the pixel warpgroup (features, head and the pixel's
// end, one pixel a thread); two blocks a cluster, sharing each copy.

constexpr int kWsConsumers = 2;                       // consumer warpgroups a block
constexpr int kWsThreads = 128 * (kWsConsumers + 2);  // and the producer's and the pixels'
constexpr int kWsCluster = 2;                         // blocks a cluster
constexpr int kWsM = 64;                              // pixels a consumer warpgroup
constexpr int kWsPix = kWsM * kWsConsumers;           // pixels a block's round
constexpr int kWsRound = kWsPix * kWsCluster;         // pixels a cluster's round
constexpr int kWsN = 64;                              // output channels a chunk
constexpr int kWsStages = 4;                          // slots of the ring
constexpr int kWsKmax = 256;                          // the widest layer input
constexpr int kWsLd = kWsKmax + 8;                    // staging row: bf16, 16 bytes of padding
constexpr int kWsFeatLd = 32 + 8;                     // feature row: bf16, 16 bytes of padding
constexpr int kWsSlot = kWsN * kWsKmax * 2;           // bytes of a ring slot
// setmaxnreg: 128 x (24 + 104 + 2 x 192) = 65,536, the block's registers
constexpr int kWsProducerRegs = 24, kWsPixelRegs = 104, kWsConsumerRegs = 192;

// Shared memory of the streamed block: the ring, each consumer warpgroup's
// staging rows, two rounds of features, the head's weights in fp32, and the
// mbarriers: the ring's full and empty, a full and an empty of each round
// buffer of features, and of each warpgroup's staging rows.
__host__ __device__ __forceinline__ int64_t ws_smem_bytes(const MlpDesc& m, int k_out) {
  return static_cast<int64_t>(kWsStages) * kWsSlot +
         static_cast<int64_t>(kWsConsumers) * kWsM * kWsLd * 2 + 2 * kWsPix * kWsFeatLd * 2 +
         static_cast<int64_t>(k_out) * m.dims[m.n_layers - 1] * 4 +
         (2 * kWsStages + 4 + 2 * kWsConsumers) * 8;
}

// Chunks of a layer of k_in inputs that one slot of the ring holds: its
// unit, the layer's chunks in order as one copy.
__host__ __device__ constexpr int ws_unit_chunks(int k_in) { return kWsKmax / k_in; }

// A chunk in shared memory (and in device memory, prep_weights' layout):
// 64 rows of W^T (output channels) by k_in, as wgmma's K-major B without
// swizzle -- core matrices of 8 rows x 8 k (128 contiguous bytes), the 8
// of a group of 8 k at 128 bytes from each other, groups of 8 k at 1024.
// The descriptor of the k-step at byte address `saddr`: LBO (the next 8 k)
// 1024 bytes, SBO (the next 8 rows) 128; a k-step is 2048 bytes further.
__device__ __forceinline__ uint64_t ws_desc(unsigned saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// D (+)= A B for the warpgroup's 64 rows and 64 channels, one k-step: A
// from registers, B by descriptor; the sum starts from D where ACC, from 0
// otherwise (D then only written). Asynchronous: D and A stay untouched
// until a wgmma_wait covers it.
template <bool ACC>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
#define BHR_WGMMA_N64(D)                                                                    \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "              \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                          \
      : D(d[0]), D(d[1]), D(d[2]), D(d[3]), D(d[4]), D(d[5]), D(d[6]), D(d[7]), D(d[8]),      \
        D(d[9]), D(d[10]), D(d[11]), D(d[12]), D(d[13]), D(d[14]), D(d[15]), D(d[16]),        \
        D(d[17]), D(d[18]), D(d[19]), D(d[20]), D(d[21]), D(d[22]), D(d[23]), D(d[24]),       \
        D(d[25]), D(d[26]), D(d[27]), D(d[28]), D(d[29]), D(d[30]), D(d[31])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(ACC ? 1 : 0))
#define BHR_ACC(x) "+f"(x)
#define BHR_SET(x) "=f"(x)
  if constexpr (ACC) {
    BHR_WGMMA_N64(BHR_ACC);
  } else {
    BHR_WGMMA_N64(BHR_SET);
  }
#undef BHR_SET
#undef BHR_ACC
#undef BHR_WGMMA_N64
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of registers across a wgmma wait
// (an empty asm that reads and writes them).
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int KS>
__device__ __forceinline__ void reg_fence_a(uint32_t (&a)[kWsKmax / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
  }
}

// Every thread of the cluster: arrive (release), then wait (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival on the mbarrier at `bar`'s offset in block `rank` of the
// cluster. Its default release is the block's: what it orders is the
// arriving warp's wgmma reads, which the wgmma wait has completed (a
// release at cluster scope fences every earlier access of the thread and
// cost ~1 ms a 1080p frame).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// `bytes` from device memory to shared address `dst` of every block of the
// cluster, each completing on the mbarrier at `bar`'s offset in its block.
__device__ __forceinline__ void bulk_copy_multicast(unsigned dst, const void* src, unsigned bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(static_cast<uint16_t>((1u << kWsCluster) - 1))
      : "memory");
}

// Unit c of the ring (its consumers count every unit they read): wait for
// it to land, and its slot's descriptor.
__device__ __forceinline__ uint64_t ws_unit(unsigned ring, uint64_t* full, uint32_t c) {
  mbar_wait(full + c % kWsStages, (c / kWsStages) & 1u);
  return ws_desc(ring + (c % kWsStages) * kWsSlot);
}

// This warp's products of unit c have completed: one arrival on the unit's
// empty mbarrier in every block of the cluster, whose producers both copy
// into this block's slot.
__device__ __forceinline__ void ws_release(uint64_t* empty, uint32_t c) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int r = 0; r < kWsCluster; ++r) mbar_arrive_cluster(empty + c % kWsStages, r);
  }
}

// This warp's 16 rows of a layer's input as A fragments, k-step ks of the
// k_in inputs in a[ks], from rows of `ld` bf16 (`rows`: its first).
__device__ __forceinline__ void ws_load_a(uint32_t (&a)[kWsKmax / 16][4],
                                          const __nv_bfloat16* __restrict__ rows, int ld,
                                          int k_in) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* r = rows + (lane % 8 + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < kWsKmax / 16; ++ks) {
    if (16 * ks >= k_in) break;
    ldmatrix_x4(a[ks], r + 16 * ks);
  }
}

// Issue a chunk's products (`desc`: its descriptor): KS k-steps in order
// from 0 into d, one group.
template <int KS>
__device__ __forceinline__ void ws_products(float (&d)[32], const uint32_t (&a)[kWsKmax / 16][4],
                                            uint64_t desc) {
  wgmma_fence();
  wgmma_n64<false>(d, a[0], desc);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) wgmma_n64<true>(d, a[ks], desc + 128 * ks);
  wgmma_commit();
}

// A chunk's epilogue, this lane's 32 outputs: bf16(tanh(d + b)), columns
// 8 j + 2 t and + 1 of rows g and g + 8 (wgmma's D fragments: mma.sync's C
// a warp), into the warp's staging rows (`rows`: row g at the chunk's first
// channel).
__device__ __forceinline__ void ws_epilogue(const float (&d)[32], const float* __restrict__ bias,
                                            __nv_bfloat16* __restrict__ rows) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kWsN / 8; ++j) {
    const int n = 8 * j + 2 * t;
    const float b0 = bias[n], b1 = bias[n + 1];
    *reinterpret_cast<__nv_bfloat162*>(rows + n) =
        __floats2bfloat162_rn(tanhf(d[4 * j] + b0), tanhf(d[4 * j + 1] + b1));
    *reinterpret_cast<__nv_bfloat162*>(rows + 8 * kWsLd + n) =
        __floats2bfloat162_rn(tanhf(d[4 * j + 2] + b0), tanhf(d[4 * j + 3] + b1));
  }
}

// The same outputs into A fragments of the next layer (FlashAttention-3's
// P.V layout): 8-column block c8 + j is k-step (c8 + j) / 2's registers 0
// and 1 (an even block) or 2 and 3 (an odd one), c8 the chunk's first. c8
// is a constant once the caller is unrolled, so `out` stays in registers.
__device__ __forceinline__ void ws_epilogue_a(const float (&d)[32], const float* __restrict__ bias,
                                              uint32_t (&out)[kWsKmax / 16][4], int c8) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kWsN / 8; ++j) {
    const int n = 8 * j + 2 * t;
    const float b0 = bias[n], b1 = bias[n + 1];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(tanhf(d[4 * j] + b0), tanhf(d[4 * j + 1] + b1));
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(tanhf(d[4 * j + 2] + b0), tanhf(d[4 * j + 3] + b1));
    out[(c8 + j) / 2][2 * ((c8 + j) % 2)] = *reinterpret_cast<const uint32_t*>(&lo);
    out[(c8 + j) / 2][2 * ((c8 + j) % 2) + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

// One layer of NC chunks (n_out = 64 NC outputs) over KS k-steps, from
// ring units c ..: once a chunk's products are done, its unit is released
// if it was the unit's last chunk, the next chunk's products are issued,
// and the done chunk's epilogue runs beside them -- into the warp's staging
// rows, or (TO_A) into `out` as the next layer's A fragments. Unrolled, so
// that no accumulator is in flight across a branch or a loop's back edge.
template <int KS, int NC, bool TO_A>
__device__ __forceinline__ void ws_layer(uint32_t (&a)[kWsKmax / 16][4], unsigned ring,
                                         uint64_t* full, uint64_t* empty, uint32_t c,
                                         const float* __restrict__ bias,
                                         __nv_bfloat16* __restrict__ rows,
                                         uint32_t (&out)[kWsKmax / 16][4]) {
  constexpr int kUnit = ws_unit_chunks(16 * KS) < NC ? ws_unit_chunks(16 * KS) : NC;
  constexpr uint64_t kChunkDesc = kWsN * 16 * KS * 2 >> 4;  // a chunk's bytes, in 16
  float d[2][32];
  uint64_t desc = ws_unit(ring, full, c);
  ws_products<KS>(d[0], a, desc);
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    wgmma_wait_all();
    reg_fence(d[n % 2]);
    if (n % kUnit == kUnit - 1 || n == NC - 1) ws_release(empty, c + n / kUnit);
    if (n + 1 < NC) {
      if ((n + 1) % kUnit == 0) desc = ws_unit(ring, full, c + (n + 1) / kUnit);
      ws_products<KS>(d[(n + 1) % 2], a, desc + (n + 1) % kUnit * kChunkDesc);
    }
    if constexpr (TO_A) {
      ws_epilogue_a(d[n % 2], bias + n * kWsN, out, n * kWsN / 8);
    } else {
      ws_epilogue(d[n % 2], bias + n * kWsN, rows + n * kWsN);
    }
  }
  reg_fence_a<KS>(a);  // the last products read a until the last wait
}

// ws_layer for n_out of 128 or 256; c counts on past the layer's units.
template <int KS, bool TO_A>
__device__ __forceinline__ void ws_layer_any(uint32_t (&a)[kWsKmax / 16][4], unsigned ring,
                                             uint64_t* full, uint64_t* empty, uint32_t& c,
                                             const float* __restrict__ bias,
                                             __nv_bfloat16* __restrict__ rows, int n_out,
                                             uint32_t (&out)[kWsKmax / 16][4]) {
  constexpr int kUnit = ws_unit_chunks(16 * KS);
  if (n_out == 2 * kWsN) {
    ws_layer<KS, 2, TO_A>(a, ring, full, empty, c, bias, rows, out);
    c += (2 + kUnit - 1) / kUnit;
  } else {
    ws_layer<KS, 4, TO_A>(a, ring, full, empty, c, bias, rows, out);
    c += (4 + kUnit - 1) / kUnit;
  }
}

template <bool KERR>
__global__ void __launch_bounds__(kWsThreads, 1)
    neural_fused_kernel_ws(const Params p, const uint32_t seed_term, const int height,
                           const int width, const MlpDesc mlp, uint32_t* __restrict__ frame,
                           float* __restrict__ vel, int32_t* __restrict__ status) {
  constexpr int kOut = KERR ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // consumers 0 .. kWsConsumers - 1, the producer, the pixels
  const int lh = mlp.n_layers - 1, k_head = mlp.dims[lh];
  auto* stg_all = reinterpret_cast<__nv_bfloat16*>(smem + kWsStages * kWsSlot);
  __nv_bfloat16* feats = stg_all + kWsConsumers * kWsM * kWsLd;  // [2][kWsPix][kWsFeatLd]
  float* hw = reinterpret_cast<float*>(feats + 2 * kWsPix * kWsFeatLd);
  auto* full = reinterpret_cast<uint64_t*>(hw + kOut * k_head);  // a unit landed
  uint64_t* empty = full + kWsStages;      // a unit read by every consumer warp of the cluster
  uint64_t* feat_full = empty + kWsStages;  // a round's features written
  uint64_t* feat_empty = feat_full + 2;     // ... read by every consumer warp
  uint64_t* stg_full = feat_empty + 2;      // a warpgroup's last layer in its staging rows
  uint64_t* stg_free = stg_full + kWsConsumers;  // ... read by the pixel warps
  const unsigned ring = smem_addr(smem);
  unsigned rank, cluster, clusters;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(cluster));
  asm("mov.u32 %0, %%nclusterid.x;\n" : "=r"(clusters));
  const int64_t n_pixels = static_cast<int64_t>(height) * width;
  const int64_t rounds = (n_pixels + kWsRound - 1) / kWsRound;  // the same in both blocks

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWsConsumers * 4 * kWsCluster);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(feat_full + b, 4);
      mbar_init(feat_empty + b, kWsConsumers * 4);
    }
    for (int w = 0; w < kWsConsumers; ++w) {
      mbar_init(stg_full + w, 4);
      mbar_init(stg_free + w, kWsM / 32);  // the pixel warps of the warpgroup's rows
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const auto* wh = static_cast<const __nv_bfloat16*>(mlp.w[lh]);  // W^T (kOut, k_head)
  for (int i = threadIdx.x; i < kOut * k_head; i += kWsThreads) hw[i] = __bfloat162float(wh[i]);
  cluster_sync();  // every block's barriers initialised, the head's weights in place

  if (wg == kWsConsumers) {
    // the producer: unit c (each hidden layer's chunks in order, as many a
    // unit as a slot holds, round after round) into slot c % kWsStages once
    // every consumer warp of the cluster has released the unit before it
    // there; this block copies part `rank` of it into both blocks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWsProducerRegs));
    if (warp == 4 * kWsConsumers) {  // one warp, so that its lanes never wait apart
      uint32_t c = 0;  // units issued
      for (int64_t rnd = cluster; rnd < rounds; rnd += clusters) {
        for (int l = 0; l < lh; ++l) {
          const int k = mlp.dims[l], nc = mlp.dims[l + 1] / kWsN;
          const int per = nc < ws_unit_chunks(k) ? nc : ws_unit_chunks(k);
          for (int n0 = 0; n0 < nc; n0 += per, ++c) {
            const unsigned part = 2u * kWsN * k * per / kWsCluster;  // this block's bytes
            const unsigned slot = c % kWsStages;
            mbar_wait(empty + slot, ((c / kWsStages) & 1u) ^ 1u);
            if (lane == 0) {
              mbar_expect_tx(full + slot, part * kWsCluster);
              bulk_copy_multicast(ring + slot * kWsSlot + rank * part,
                                  static_cast<const char*>(mlp.w[l]) +
                                      2 * static_cast<int64_t>(n0) * kWsN * k + rank * part,
                                  part, full + slot);
            }
            __syncwarp();
          }
        }
      }
    }
    cluster_sync();  // no block leaves while a copy or an arrival may reach it
  } else if (wg == kWsConsumers + 1) {
    // the pixels: one a thread, pixel i of the block's round for row i % 64
    // of consumer warpgroup i / 64. Round j's features into buffer j % 2,
    // then the head of round j - 1 from the warpgroup's staging rows, which
    // are then free, and the pixel's end; the geometry kept in registers
    // from one round to the next
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWsPixelRegs));
    const int i = threadIdx.x % 128, wc = i / kWsM;
    const Frame fr = frame_constants(p);
    Geo prev{};
    int64_t prev_id = -1;  // the pixel of the round before, -1 where none or past the frame
    uint32_t j = 0;
    auto finish = [&](uint32_t jr) {  // the end of round jr
      float head[kOut];
      mbar_wait(stg_full + wc, jr & 1u);
      fused_head<kOut>(stg_all + (wc * kWsM + i % kWsM) * kWsLd, hw, k_head, mlp.b[lh], head);
      __syncwarp();
      if (lane == 0) mbar_arrive(stg_free + wc);
      if (prev_id >= 0) shade_geo<KERR>(p, fr, prev_id, prev, head, seed_term, frame, vel, status);
    };
    for (int64_t rnd = cluster; rnd < rounds; rnd += clusters, ++j) {
      const int64_t id = rnd * kWsRound + rank * kWsPix + i;
      float f[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) f[k] = 0.0f;
      Geo g{};
      if (id < n_pixels) {
        g = pixel_geometry<KERR>(p, fr, static_cast<int>(id / width),
                                 static_cast<int>(id % width), f);
      }
      mbar_wait(feat_empty + j % 2, ((j / 2) & 1u) ^ 1u);
      uint4* row = reinterpret_cast<uint4*>(feats + ((j % 2) * kWsPix + i) * kWsFeatLd);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (8 * q >= mlp.dims[0]) break;
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[8 * q + 2 * e], f[8 * q + 2 * e + 1]);
          u[e] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        row[q] = make_uint4(u[0], u[1], u[2], u[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(feat_full + j % 2);
      if (j > 0) finish(j - 1);
      prev = g;
      prev_id = id < n_pixels ? id : -1;
    }
    if (j > 0) finish(j - 1);
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWsConsumerRegs));
    const int tw = threadIdx.x % 128, wq = tw / 32;
    __nv_bfloat16* stg = stg_all + wg * kWsM * kWsLd;
    const __nv_bfloat16* warp_rows = stg + 16 * wq * kWsLd;
    __nv_bfloat16* rows = stg + (16 * wq + lane / 4) * kWsLd;
    uint32_t c = 0;  // units read
    uint32_t j = 0;  // rounds
    for (int64_t rnd = cluster; rnd < rounds; rnd += clusters, ++j) {
      // 1. the round's features from the pixel warps, as this warp's A
      // fragments of the first layer
      uint32_t a0[kWsKmax / 16][4], a[kWsKmax / 16][4];
      mbar_wait(feat_full + j % 2, (j / 2) & 1u);
      ws_load_a(a0, feats + ((j % 2) * kWsPix + wg * kWsM + 16 * wq) * kWsFeatLd, kWsFeatLd,
                mlp.dims[0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(feat_empty + j % 2);
      // 2. the first layer, its outputs as the second's A fragments where it
      // is not the last; the staging rows stay the pixel warps' meanwhile
      const int n0 = mlp.dims[1];
      const bool last0 = lh == 1;
      if (last0) mbar_wait(stg_free + wg, (j & 1u) ^ 1u);
      if (mlp.dims[0] == 16) {
        if (last0) {
          ws_layer_any<1, false>(a0, ring, full, empty, c, mlp.b[0], rows, n0, a);
        } else {
          ws_layer_any<1, true>(a0, ring, full, empty, c, mlp.b[0], rows, n0, a);
        }
      } else if (last0) {
        ws_layer_any<2, false>(a0, ring, full, empty, c, mlp.b[0], rows, n0, a);
      } else {
        ws_layer_any<2, true>(a0, ring, full, empty, c, mlp.b[0], rows, n0, a);
      }
      // 3. the other hidden layers: each warp's 16 rows in and out of its
      // own staging rows, so no barrier between layers
      if (!last0) mbar_wait(stg_free + wg, (j & 1u) ^ 1u);
      for (int l = 1; l < lh; ++l) {
        const int k_in = mlp.dims[l], n_out = mlp.dims[l + 1];
        if (k_in == 128) {
          ws_layer_any<8, false>(a, ring, full, empty, c, mlp.b[l], rows, n_out, a);
        } else {
          ws_layer_any<16, false>(a, ring, full, empty, c, mlp.b[l], rows, n_out, a);
        }
        __syncwarp();  // the layer's outputs are in the warp's staging rows
        if (l + 1 < lh) ws_load_a(a, warp_rows, kWsLd, n_out);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(stg_full + wg);  // the last layer's rows, for the head
    }
    cluster_sync();
  }
}

template <bool KERR>
int launch_ws(const Params& p, uint32_t seed_term, int height, int width, const MlpDesc& mlp,
              uint32_t* frame, float* vel, int32_t* status, cudaStream_t s) {
  const int64_t smem = ws_smem_bytes(mlp, KERR ? 3 : 2);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = neural_fused_kernel_ws<KERR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kWsCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kWsCluster);
  cfg.blockDim = dim3(kWsThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // persistent clusters: as many as are resident, each taking rounds in
  // turn; a device's count is found at its first launch (every net of the
  // layout takes one block an SM)
  static int resident[64] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] < 1 &&
      (err = cudaOccupancyMaxActiveClusters(&resident[device], kernel, &cfg)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int clusters = resident[device];
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t rounds = (static_cast<int64_t>(height) * width + kWsRound - 1) / kWsRound;
  cfg.gridDim = dim3(kWsCluster * static_cast<unsigned>(rounds < clusters ? rounds : clusters));
  if ((err = cudaLaunchKernelEx(&cfg, kernel, p, seed_term, height, width, mlp, frame, vel,
                                status)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool KERR, bool HI>
int launch(const Params& p, uint32_t seed_term, int height, int width, const MlpDesc& mlp,
           uint32_t* frame, float* vel, int32_t* status, cudaStream_t s) {
  const int64_t smem = smem_bytes<HI>(mlp);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = neural_render_kernel<KERR, HI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_pixels = static_cast<int64_t>(height) * width;
  const unsigned blocks = static_cast<unsigned>((n_pixels + mlp.pix - 1) / mlp.pix);
  kernel<<<blocks, kThreads, static_cast<size_t>(smem), s>>>(p, seed_term, height, width, mlp,
                                                              frame, vel, status);
  return static_cast<int>(cudaGetLastError());
}

// The shapes the kernel takes: 2..kMaxLayers layers; inputs padded to a
// multiple of 16 that holds the model's features; the model's head. The
// streamed layout: its one plan, inputs of 16 or 32, hidden widths of 128
// or 256. The held layout: its plan, every weight held (so its kernel's
// streamed branch is never launched), hidden widths up to 128. Otherwise one
// or two weight-chunk buffers. Default tier: hidden widths that n_chunk (a
// multiple of 64) divides, and pix a multiple of 16. fp32 tier: hidden
// widths that are multiples of the warp tile's 128 channels, pix a multiple
// of its 32 pixels, at most kMaxOutputs of a layer's outputs a block, and
// slabs of a multiple of 8 rows that divide every layer's input.
bool shapes_ok(const MlpDesc& m, bool kerr, bool hi) {
  if (m.n_layers < 2 || m.n_layers > kMaxLayers) return false;
  if (m.dims[0] % 16 != 0 || m.dims[0] < (kerr ? 22 : 16)) return false;
  if (m.dims[m.n_layers] != (kerr ? 3 : 2)) return false;
  if (m.regs == 256) {  // the streamed default tier: widths of 128 or 256, inputs up to 32
    if (hi || m.pix != kWsRound || m.n_chunk != kWsN || m.nbuf != kWsStages) return false;
    if (m.dims[0] > 32) return false;
    for (int l = 1; l < m.n_layers; ++l) {
      if (m.dims[l] != 128 && m.dims[l] != 256) return false;
    }
  } else if (m.regs != 0) {  // the held default tier: every width held in KMAX registers
    if (hi || m.regs != 128 || m.pix != 32 * fused_warps(m.regs) || m.nbuf != 0) return false;
    if (m.dims[0] > 32) return false;  // one or two k-steps of inputs
    for (int l = 1; l < m.n_layers; ++l) {
      if (m.dims[l] > m.regs || m.dims[l] % 128 != 0) return false;
    }
  } else if ((m.nbuf != 1 && m.nbuf != 2) || m.pix <= 0 || m.n_chunk <= 0) {
    return false;
  } else if (hi) {
    if (m.pix % kWarpP != 0 || m.n_chunk % 8 != 0) return false;
    for (int l = 0; l + 1 < m.n_layers; ++l) {
      const int rows = m.n_chunk < m.dims[l] ? m.n_chunk : m.dims[l];
      if (m.dims[l] % rows != 0 || m.dims[l + 1] % kWarpC != 0 ||
          static_cast<int64_t>(m.pix) * m.dims[l + 1] > kMaxOutputs) {
        return false;
      }
    }
  } else {
    if (m.pix % 16 != 0 || m.n_chunk % 64 != 0) return false;
    for (int l = 1; l < m.n_layers; ++l) {
      if (m.dims[l] % m.n_chunk != 0 || m.dims[l] % 16 != 0) return false;
    }
  }
  for (int l = 0; l < m.n_layers; ++l) {
    if (m.w[l] == nullptr || m.b[l] == nullptr) return false;
  }
  return true;
}

}  // namespace
}  // namespace bhr

// C entry point, bound with ctypes by bhr_tpu_torch/utils/build.py.
// Renders one neural frame on `stream` and returns cudaGetLastError() after
// the launch (0 on success; cudaErrorInvalidValue for shapes the kernel
// does not take). (height, width) is the frame, or a band whose first row
// is params.v[P_ROW0]. Exactly one output is given: `out`, a contiguous (height,
// width) array of 32-bit words on `device` that receives the packed frame
// (N1, N2), or `vel` and `status`, contiguous fp32 (height, width, 3) and
// int32 (height, width), that receive the unit directions and the capture
// status unshaded (N3; `seed_term` is then unused). Does not synchronise.
// `kerr` selects the Kerr net (22 features, 3 heads), `highest` the fp32
// tier over the bf16 one; the bf16 tier takes the fused layout where
// mlp.regs is 128 or 256 (its weights' rows then padded by 8 zeros), the
// chunked one where it is 0.
extern "C" int bhr_neural_render(bhr::Params params, uint32_t seed_term, int kerr, int highest,
                                 int height, int width, bhr::MlpDesc mlp, int device, void* out,
                                 void* vel, void* status, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!bhr::shapes_ok(mlp, kerr != 0, highest != 0) ||
      (out != nullptr) == (vel != nullptr) || (vel != nullptr) != (status != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (height <= 0 || width <= 0) return 0;
  auto* frame = static_cast<uint32_t*>(out);
  auto* v = static_cast<float*>(vel);
  auto* st = static_cast<int32_t*>(status);
  auto s = static_cast<cudaStream_t>(stream);
  if (mlp.regs == 128 && kerr) {
    return bhr::launch_fused<true, 128>(params, seed_term, height, width, mlp, frame, v, st, s);
  }
  if (mlp.regs == 128) {
    return bhr::launch_fused<false, 128>(params, seed_term, height, width, mlp, frame, v, st, s);
  }
  if (mlp.regs == 256 && kerr) {
    return bhr::launch_ws<true>(params, seed_term, height, width, mlp, frame, v, st, s);
  }
  if (mlp.regs == 256) {
    return bhr::launch_ws<false>(params, seed_term, height, width, mlp, frame, v, st, s);
  }
  if (kerr && highest) {
    return bhr::launch<true, true>(params, seed_term, height, width, mlp, frame, v, st, s);
  }
  if (kerr) return bhr::launch<true, false>(params, seed_term, height, width, mlp, frame, v, st, s);
  if (highest) {
    return bhr::launch<false, true>(params, seed_term, height, width, mlp, frame, v, st, s);
  }
  return bhr::launch<false, false>(params, seed_term, height, width, mlp, frame, v, st, s);
}

extern "C" const char* bhr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
