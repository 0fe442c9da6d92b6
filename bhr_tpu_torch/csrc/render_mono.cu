// Monolithic trace + shade kernel for Hopper (sm_90a).
//
// Replaces bhr_tpu/ops/pallas_trace.py:kernel_monolithic (with its
// _stateless_trace loop) for semi-implicit Euler on the Schwarzschild
// metric, in both math tiers. One thread renders one pixel: ray-gen from
// the 32-float parameter struct, the geodesic loop, the analytic star field
// (bhr_tpu/ops/starfield.py:procedural_background), and the quantized,
// packed RGBA word -- the only memory the kernel touches is that one 4-byte
// store per pixel.
//
// What bounds it: instruction issue. A fast-tier ray-step compiles to 49
// SASS instructions, 3 of them SFU operations (2 rsqrt, 1 rcp); the exact
// tier's common path is 158, 10 of them SFU, because each correctly rounded
// divide and sqrt is a short Newton sequence. Nothing is read from memory;
// the one 4-byte store per pixel is all the traffic. Measured on an NVIDIA
// H100 80GB HBM3 (700 W power limit, SM clock 1980 MHz under load) at
// 1920x1080x500 from the default camera: 9.6e8 ray-steps in 1.59 ms
// (fast) and 5.69 ms (exact), about 89% and 80% of the card's issue rate
// of one warp instruction per scheduler per clock. Warp divergence costs
// little there: neighbouring pixels leave the loop after different step
// counts (a ray into the shadow stops after about 137 steps, most run all
// 500), and a warp runs as long as its slowest ray, but 99.7% of the
// lane-steps of the 16x16 blocks (warps of 2 rows x 16 pixels) do work.
// The design keeps the ray's 6 floats in registers (no spills, full
// occupancy on the fast tier) and the parameters in kernel arguments
// (constant bank, no loads). Cutting instructions per step, and tuning
// occupancy, block shape and ray order for views with more divergence,
// is later work.
//
// The TPU kernel's Mosaic workarounds are gone: a per-thread `break`
// replaces the dt-freeze termination, the per-tile any(live) check and
// the loop knobs (their results are the same for every setting), and the
// grid has no padding.
//
// Tiers (template parameter FAST):
//  * exact: correctly rounded fp32 in the oracle's operation order
//    (bhr_tpu/ops/trace.py:trace_rays, models/schwarzschild.py:acceleration,
//    ops/geodesic.py:euler_step), termination on the sqrt'd radius, and
//    round-half-to-even quantization;
//  * fast: the folded two-coefficient Euler update with rsqrt and an
//    approximate reciprocal (pallas_trace.py:physics_substep), termination
//    in r^2 space, and round-half-up quantization.
// Both tiers count a ray as captured when its final r^2 < capture^2.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace bhr {
namespace {

// Python-float constants of the star field, rounded to fp32 as JAX and
// PyTorch round a Python float.
constexpr float kHalfGrid = 48.0f;  // 0.5 * 96 cells per face edge
constexpr int kGrid = 96;
constexpr float kBrightFloor = static_cast<float>(0.04);
constexpr float kGreenBase = static_cast<float>(0.80);
constexpr float kGreenTint = static_cast<float>(0.15);
constexpr float kBlueTint = static_cast<float>(0.45);
constexpr float kWobble = static_cast<float>(0.12);
constexpr float kInvBandWidth = static_cast<float>(1.0 / 0.11);
constexpr float kBandR = static_cast<float>(0.035);
constexpr float kBandG = static_cast<float>(0.033);
constexpr float kBandB = static_cast<float>(0.045);
constexpr float kMinH2 = static_cast<float>(1e-6);
constexpr float kOneMFloor = static_cast<float>(0.02);
constexpr float kInv2Pow24 = 1.0f / 16777216.0f;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// uint32 -> [0, 1) through the top 24 bits, as int32 (exact in fp32).
__device__ __forceinline__ float unit24(uint32_t h) {
  return static_cast<float>(static_cast<int32_t>(h >> 8)) * kInv2Pow24;
}

template <bool FAST>
__device__ __forceinline__ Vec3 vnorm(Vec3 v) {
  using A = Arith<FAST>;
  if constexpr (FAST) {
    const float s = rsqrtf(dot<true>(v, v));
    return {v.x * s, v.y * s, v.z * s};
  } else {
    const float s = A::sqrt(dot<false>(v, v));
    return {A::div(v.x, s), A::div(v.y, s), A::div(v.z, s)};
  }
}

// starfield.py:57-138, operation for operation.
template <bool FAST>
__device__ __forceinline__ void procedural_background(Vec3 d, uint32_t seed_term,
                                                      float& out_r, float& out_g,
                                                      float& out_b) {
  using A = Arith<FAST>;
  const float n_inv = A::rsqrt(dot<FAST>(d, d));
  const float nx = A::mul(d.x, n_inv);
  const float ny = A::mul(d.y, n_inv);
  const float nz = A::mul(d.z, n_inv);
  const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);

  // dominant-axis cube projection: face id in 0..5, in-face coords s, t
  const bool x_major = (ax >= ay) && (ax >= az);
  const bool y_major = !x_major && (ay >= az);
  const float maj = x_major ? ax : (y_major ? ay : az);
  const float inv_maj = A::div(1.0f, maj);
  const float s = A::mul(x_major ? ny : (y_major ? nz : nx), inv_maj);
  const float t = A::mul(x_major ? nz : (y_major ? nx : ny), inv_maj);
  const int axis = x_major ? 0 : (y_major ? 1 : 2);
  const int sign_bit = ((x_major ? nx : (y_major ? ny : nz)) < 0.0f) ? 1 : 0;
  const int face = axis * 2 + sign_bit;

  const float fs = A::mul(A::add(s, 1.0f), kHalfGrid);
  const float ft = A::mul(A::add(t, 1.0f), kHalfGrid);
  const int cs0 = static_cast<int>(floorf(fs));
  const int ct0 = static_cast<int>(floorf(ft));

  float r = 0.0f, g = 0.0f, b = 0.0f;
#pragma unroll
  for (int dds = -1; dds <= 1; ++dds) {
#pragma unroll
    for (int ddt = -1; ddt <= 1; ++ddt) {
      const int cs = min(max(cs0 + dds, 0), kGrid - 1);
      const int ct = min(max(ct0 + ddt, 0), kGrid - 1);
      const uint32_t h =
          lowbias32(static_cast<uint32_t>(face * kGrid * kGrid + cs * kGrid + ct) + seed_term);
      const uint32_t h2 = lowbias32(h);
      const uint32_t h3 = lowbias32(h2);
      const uint32_t h4 = lowbias32(h3);
      const float su = A::add(static_cast<float>(cs0 + dds), unit24(h));
      const float sv = A::add(static_cast<float>(ct0 + ddt), unit24(h2));
      const float du = A::sub(fs, su);
      const float dv = A::sub(ft, sv);
      const float d2 = A::add(A::mul(du, du), A::mul(dv, dv));
      const float tt = unit24(h3);
      const float t2 = A::mul(tt, tt);
      const float t4 = A::mul(t2, t2);
      const float bright = A::add(A::mul(A::mul(t4, t4), 2.5f), kBrightFloor);
      const float fall = fmaxf(0.0f, A::sub(1.0f, A::mul(d2, 18.0f)));
      const float glow = A::mul(fall, fall);
      const float amp = A::mul(A::mul(bright, glow), glow);
      const float temp = unit24(h4);
      r = A::add(r, A::mul(amp, A::add(0.75f, A::mul(0.25f, temp))));
      // parabola 4t(1-t) stands in for sin(pi t)
      g = A::add(g, A::mul(amp, A::add(kGreenBase,
                                        A::mul(kGreenTint, A::mul(A::mul(4.0f, temp),
                                                                  A::sub(1.0f, temp))))));
      b = A::add(b, A::mul(amp, A::sub(1.0f, A::mul(kBlueTint, temp))));
    }
  }

  // galactic band; azimuthal wobble sin(2 az) = 2 nx nz / (nx^2 + nz^2)
  const float h2d = A::add(A::mul(nx, nx), A::mul(nz, nz));
  const float wobble = A::mul(A::mul(A::mul(2.0f, nx), nz), A::div(1.0f, fmaxf(h2d, kMinH2)));
  const float tband = A::mul(A::sub(ny, A::mul(kWobble, wobble)), kInvBandWidth);
  float band = A::div(1.0f, A::add(1.0f, A::mul(tband, tband)));
  band = A::mul(band, band);
  r = A::add(r, A::mul(band, kBandR));
  g = A::add(g, A::mul(band, kBandG));
  b = A::add(b, A::mul(band, kBandB));

  // Reinhard x / (1 + x)
  out_r = A::div(r, A::add(1.0f, r));
  out_g = A::div(g, A::add(1.0f, g));
  out_b = A::div(b, A::add(1.0f, b));
}

// Fast tier quantizer: floor(clip(c * live, 0, 1) * 255 + 0.5).
__device__ __forceinline__ uint32_t quantize_half_up(float c, float live) {
  const float x = fminf(fmaxf(c * live, 0.0f), 1.0f);
  return static_cast<uint32_t>(static_cast<int>(floorf(x * 255.0f + 0.5f)));
}

// Exact tier quantizer: round-half-to-even of clip(where(captured, 0, c)) * 255.
__device__ __forceinline__ uint32_t quantize_half_even(float c, bool captured) {
  const float x = __fmul_rn(fminf(fmaxf(captured ? 0.0f : c, 0.0f), 1.0f), 255.0f);
  return static_cast<uint32_t>(__float2int_rn(x));
}

template <bool FAST>
__global__ void __launch_bounds__(256)
    render_mono_kernel(const Params p, const uint32_t seed_term, const int height,
                       const int width, const int max_steps, uint32_t* __restrict__ out) {
  using A = Arith<FAST>;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;

  // ---- ray-gen (pallas_trace.py:742-765; core/camera.py:generate_rays)
  const float rows_f = static_cast<float>(row + static_cast<int>(p.v[P_ROW0]));
  const float cols_f = static_cast<float>(col + static_cast<int>(p.v[P_COL0]));
  const float u = A::mul(A::mul(A::sub(A::div(cols_f, p.v[P_WF]), 0.5f), 2.0f), p.v[P_ASPECT]);
  const float v = A::mul(A::sub(A::div(rows_f, p.v[P_HF]), 0.5f), -2.0f);
  const float uf = A::mul(u, p.v[P_FOVF]);
  const float vf = A::mul(v, p.v[P_FOVF]);
  const Vec3 d = {
      A::add(A::add(p.v[P_FWD + 0], A::mul(p.v[P_RIGHT + 0], uf)), A::mul(p.v[P_UP + 0], vf)),
      A::add(A::add(p.v[P_FWD + 1], A::mul(p.v[P_RIGHT + 1], uf)), A::mul(p.v[P_UP + 1], vf)),
      A::add(A::add(p.v[P_FWD + 2], A::mul(p.v[P_RIGHT + 2], uf)), A::mul(p.v[P_UP + 2], vf)),
  };
  // normalised twice: generate_rays normalises, and trace_rays again
  Vec3 vel = vnorm<FAST>(vnorm<FAST>(d));
  Vec3 rel = {A::sub(p.v[P_CAM + 0], p.v[P_BH + 0]), A::sub(p.v[P_CAM + 1], p.v[P_BH + 1]),
              A::sub(p.v[P_CAM + 2], p.v[P_BH + 2])};

  const float rs = p.v[P_RS];
  const float dt = p.v[P_DT];
  const float esc = p.v[P_ESC];
  const float cap = p.v[P_CAP];
  const float esc2 = A::mul(esc, esc);
  const float cap2 = A::mul(cap, cap);

  // ---- geodesic loop: test, then step, until the ray leaves [cap, esc]
  for (int i = 0; i < max_steps; ++i) {
    if constexpr (FAST) {
      // pallas_trace.py:1018-1023 and physics_substep (:793-834)
      const float r2 = dot<true>(rel, rel);
      if (!(r2 <= esc2 && r2 >= cap2)) break;
      const float inv_r = rsqrtf(r2);
      const float c = dot<true>(vel, rel);
      const float rs_inv_r = rs * inv_r;
      const float one_m = fmaxf(1.0f - rs_inv_r, kOneMFloor);
      const float factor_dt = (rs * rcp_approx(2.0f * r2 * one_m)) * dt;
      const float b1 = 1.0f - factor_dt * one_m;
      const float b2 = factor_dt * (1.0f + rs_inv_r) * c * (inv_r * inv_r);
      const Vec3 nv = {vel.x * b1 + rel.x * b2, vel.y * b1 + rel.y * b2,
                       vel.z * b1 + rel.z * b2};
      rel = {rel.x + nv.x * dt, rel.y + nv.y * dt, rel.z + nv.z * dt};
      const float s = rsqrtf(dot<true>(nv, nv));
      vel = {nv.x * s, nv.y * s, nv.z * s};
    } else {
      // trace.py:172-188 with schwarzschild.acceleration and euler_step,
      // in their literal order (pallas_trace.py:1024-1031, :849-887)
      const float r = A::sqrt(dot<false>(rel, rel));
      if (!(r <= esc && r >= cap)) break;
      const Vec3 r_vec = {A::div(rel.x, r), A::div(rel.y, r), A::div(rel.z, r)};
      const float rs_over_r = A::div(rs, r);
      const float one_m = A::sub(1.0f, rs_over_r);
      const float factor = A::div(rs, A::mul(A::mul(A::mul(2.0f, r), r), one_m));
      const float v_rad = dot<false>(vel, r_vec);
      const float one_p = A::add(1.0f, rs_over_r);
      const float nf = -factor;
      const Vec3 a = {
          A::mul(nf, A::sub(A::mul(vel.x, one_m), A::mul(A::mul(r_vec.x, v_rad), one_p))),
          A::mul(nf, A::sub(A::mul(vel.y, one_m), A::mul(A::mul(r_vec.y, v_rad), one_p))),
          A::mul(nf, A::sub(A::mul(vel.z, one_m), A::mul(A::mul(r_vec.z, v_rad), one_p))),
      };
      const Vec3 nv = {A::add(vel.x, A::mul(a.x, dt)), A::add(vel.y, A::mul(a.y, dt)),
                       A::add(vel.z, A::mul(a.z, dt))};
      rel = {A::add(rel.x, A::mul(nv.x, dt)), A::add(rel.y, A::mul(nv.y, dt)),
             A::add(rel.z, A::mul(nv.z, dt))};
      const float s = A::sqrt(dot<false>(nv, nv));
      vel = {A::div(nv.x, s), A::div(nv.y, s), A::div(nv.z, s)};
    }
  }

  // ---- shade, quantize, pack (pallas_trace.py:1294-1333)
  const bool captured = dot<FAST>(rel, rel) < cap2;
  float r, g, b;
  procedural_background<FAST>(vel, seed_term, r, g, b);
  uint32_t qr, qg, qb;
  if constexpr (FAST) {
    const float live = captured ? 0.0f : 1.0f;
    qr = quantize_half_up(r, live);
    qg = quantize_half_up(g, live);
    qb = quantize_half_up(b, live);
  } else {
    qr = quantize_half_even(r, captured);
    qg = quantize_half_even(g, captured);
    qb = quantize_half_even(b, captured);
  }
  out[static_cast<int64_t>(row) * width + col] = qr | (qg << 8) | (qb << 16) | 0xFF000000u;
}

}  // namespace
}  // namespace bhr

// C entry point, bound with ctypes by bhr_tpu_torch/utils/build.py.
// Launches one frame on `stream` into `out`, a contiguous (height, width)
// array of 32-bit words on `device`, and returns cudaGetLastError() after
// the launch (0 on success). Does not synchronise.
extern "C" int bhr_render_mono(bhr::Params params, uint32_t seed_term, int fast, int height,
                               int width, int max_steps, int device, void* out,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (height <= 0 || width <= 0) return 0;
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  auto* frame = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (fast) {
    bhr::render_mono_kernel<true><<<grid, block, 0, s>>>(params, seed_term, height, width,
                                                         max_steps, frame);
  } else {
    bhr::render_mono_kernel<false><<<grid, block, 0, s>>>(params, seed_term, height, width,
                                                          max_steps, frame);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bhr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
