// The analytic star field and the frame quantizers, shared by the kernels
// that shade a final ray direction (render_mono.cu, neural_mlp.cu): the
// device form of bhr_tpu/ops/starfield.py:procedural_background (plain
// version bhr_tpu_torch/ops/starfield.py), operation for operation in the
// exact tier (FAST = false), and the packed word's per-channel rounding.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace bhr {

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

// Round-half-up as the plain version computes it, floor(clip(c * live) *
// 255 + 0.5) with each operation rounded on its own (never one FMA), so
// a kernel that uses it quantizes bit-equal to sampling.pack_rgba8_planes
// (half_up=True).
__device__ __forceinline__ uint32_t quantize_half_up_rn(float c, float live) {
  const float x = fminf(fmaxf(__fmul_rn(c, live), 0.0f), 1.0f);
  return static_cast<uint32_t>(static_cast<int>(floorf(__fadd_rn(__fmul_rn(x, 255.0f), 0.5f))));
}

}  // namespace bhr
