// Monolithic trace + shade kernel for Hopper (sm_90a).
//
// Replaces bhr_tpu/ops/pallas_trace.py:kernel_monolithic (with its
// _stateless_trace loop, and _shade_disk for the accretion disk) for the
// euler, rk4 and leapfrog integrators, fixed or adaptive dt, on the
// Schwarzschild, exact Kerr (Kerr-Schild, K6), Lense-Thirring Kerr (K7) or
// flat metric, in both math tiers. One thread renders
// one pixel: ray-gen from the 32-float parameter struct, the geodesic loop
// (trace_ray.cuh), then the analytic star field
// (bhr_tpu/ops/starfield.py:procedural_background) or, in the fast tier,
// the disk's emission, and the quantized, packed RGBA word -- the only
// memory the kernel writes is that one 4-byte store per pixel.
//
// What bounds it: instruction issue. The loop a launch really runs
// (bhr_tpu_torch/tools/sass_walk.py walk_step: cuobjdump -sass of the
// kernel as built, walked from its entry along the launch's flags) issued
// 68 SASS instructions a step on the main path (Euler, no flags) in the
// fast tier, 3 of them SFU operations (2 rsqrt, 1 rcp), and 157 in the
// exact tier, 5 of them SFU: besides the step's arithmetic, a step reloaded
// the runtime flags, tested flat, kerr_lt and the disk, and moved values
// between the registers of the branches (nvcc unswitched the loop on
// adaptive dt alone). So the main path's frame has an instantiation of its
// own with the flags fixed at 0 (FLAGS; `launch` takes it for an Euler
// launch with no flag set): the tests fold away and the step is the
// arithmetic, the termination test, the counter and the back edge. The fast tier's rsqrt is the SFU's without rsqrtf's subnormal
// fix-up (trace_ray.cuh), and both termination tests share one branch.
// The fast step is now 42 SASS / 3 MUFU, the exact one 135 / 5, with every
// output bit-equal to before. Measured on an NVIDIA H100 80GB HBM3
// (700.00 W power limit, SM clock 1980 MHz under load) at 1920x1080x500
// from the default camera: 9.6e8 ray-steps, 3.01e7 warp-steps, in 1.45-1.56
// ms (fast; 2.29-2.37 before, in the same calls) and 4.60-4.67 ms (exact;
// 5.26-5.39), 78-84% and 83-84% of the card's issue rate of one warp
// instruction per scheduler per clock (issue floors 1.209 and 3.887 ms).
// Warp divergence costs little: 99.7% of the lane-steps of the 16x16
// blocks do work. More resident warps do not help: with the dynamic shared
// memory a launch asks for cut to 1 .. 8 blocks an SM, the frame takes 2.6,
// 1.7, 1.5 ms and then stays flat within 3% from 4 blocks on; the last
// partial wave costs nothing measurable. The design keeps the ray's state
// in registers and the parameters in kernel arguments (constant bank, no
// loads).
//
// The TPU kernel's Mosaic workarounds are gone: a per-thread `break`
// replaces the dt-freeze termination, the disk's y-sentinel teleport, the
// per-tile any(live) check and the loop knobs, and the blackbody LUT is
// read by an indexed lerp (the same value as _lut_scalar_lerp's masked sum
// over all 128 entries).
//
// Tiers (template parameter FAST), as trace_ray.cuh describes them; the
// exact tier quantizes round-half-to-even, the fast tier round-half-up.
// The disk is shaded in the fast tier only: an exact-tier disk frame goes
// through trace_planes.cu and the plain PyTorch epilogue, as in bhr_tpu.
// The Kerr-Schild loop is a template parameter (KS), so there are 2 tiers
// x 3 integrators x 2 loops = 12 instantiations, the 2 tiers' Euler
// instantiations with the flags fixed at 0, and the fast Euler Kerr-Schild
// one with the flags fixed at kFlagKS | kFlagDisk (BASELINE config 5's
// frame; `launch` takes it for exactly those flags): 15. A Kerr-Schild disk
// ray is shaded with the direction evaluated at its hit point, y = 0.
//
// Kerr-Schild costs more a step: in the exact tier derivs (trace_ray.cuh
// ks_radii, ks_geom, ks_terms) is ~150 fp32 operations against ~35 for the
// Schwarzschild acceleration, with 3 reciprocals and 2 square roots a
// point; rk4 takes 4 points a step, leapfrog 3 (for its 5 calls), euler 1.
// The fast tier takes dp through r, with no Jacobian of l, and its roots
// from the SFU's rsqrt: 2 rsqrt and 2 rcp a point. Config 5's fast step as
// built went 167 SASS / 6 MUFU (flags read at run time) -> 159 (the flags
// fixed) -> 136 (dp through r) -> 119 / 5 (the SFU's roots), and its frame
// 15.62-15.74 -> 11.16 ms on an NVIDIA H100 80GB HBM3 (700.00 W, SM clock
// 1980 MHz under load), 95.6% of its issue floor (10.676 ms), every other
// instantiation's SASS unchanged; with the flags read at run time the same
// step is 126 SASS and 11.56 ms.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "starfield.cuh"
#include "trace_ray.cuh"

namespace bhr {
namespace {

// The fast kernel's blackbody table (models/disk.py:kernel_lut_np):
// channel-major, kLutSteps entries per channel over 1000 K .. 30000 K.
constexpr int kLutSteps = 128;
constexpr float kLutTMin = 1000.0f;
constexpr float kLutScale = static_cast<float>((kLutSteps - 1) / (30000.0 - 1000.0));
constexpr float kInvTIsco = static_cast<float>(1.0 / 10000.0);
__constant__ float kDiskLut[3 * kLutSteps];

// The fast kernel's disk emission (pallas_trace.py:_shade_disk, :1216-1278;
// plain version models/disk.py:shade_disk_planes): Keplerian beta, Doppler x
// gravitational g against the observer's redshift, T ~ r^-3/4 as
// rsqrt(x) * rsqrt(sqrt(x)), the blackbody LUT by an indexed lerp, and
// 1/g^3 beaming. `rel` is the hit point relative to the black hole.
__device__ __forceinline__ void shade_disk(const Params& p, Vec3 rel, Vec3 vel, float& out_r,
                                           float& out_g, float& out_b) {
  const float rs = p.v[P_RS];
  const float r_isco = p.v[P_RISCO];
  const float r_outer = p.v[P_ROUTER];
  const float hx = rel.x, hz = rel.z;
  const float dr2 = hx * hx + hz * hz;
  const float inv_dr = rsqrtf(fmaxf(dr2, static_cast<float>(1e-12)));
  const float dr = dr2 * inv_dr;
  const float beta2 = fminf(fmaxf((rs * 0.5f) * inv_dr, 0.0f), static_cast<float>(0.81));
  const float beta = sqrtf(beta2);
  // unit tangent (z, 0, -x) / dr dotted with the unit ray direction
  const float cos_t = (hz * vel.x - hx * vel.z) * inv_dr;
  const float doppler = (1.0f - beta * cos_t) * rsqrtf(1.0f - beta2);
  const float rs_guard = static_cast<float>(1.001) * rs;
  const float grav_emit = sqrtf(fminf(
      fmaxf(1.0f - rs * rcp_approx(fmaxf(dr, rs_guard)), static_cast<float>(1e-4)), 1.0f));
  const float ox = p.v[P_CAM + 0] - p.v[P_BH + 0];
  const float oy = p.v[P_CAM + 1] - p.v[P_BH + 1];
  const float oz = p.v[P_CAM + 2] - p.v[P_BH + 2];
  const float obs_r = sqrtf(ox * ox + oy * oy + oz * oz);
  const float grav_obs = sqrtf(
      fminf(fmaxf(1.0f - rs / fmaxf(obs_r, rs_guard), static_cast<float>(1e-4)), 1.0f));
  const float gfac = fmaxf(doppler * (grav_emit / grav_obs), static_cast<float>(1e-3));
  const float inv_g = rcp_approx(gfac);
  const float x = fmaxf(dr * (1.0f / r_isco), static_cast<float>(1e-6));
  const float t_emit = p.v[P_TISCO] * (rsqrtf(x) * rsqrtf(sqrtf(x)));
  const float t_obs = t_emit * inv_g;
  const float beaming = inv_g * inv_g * inv_g;
  const float rel_t = t_obs * kInvTIsco;
  const float edge = fminf(fmaxf((r_outer - dr) * (1.0f / (r_outer - r_isco)), 0.0f), 1.0f);
  const float intensity = fminf(fmaxf(beaming * rel_t * rel_t * edge, 0.0f), 4.0f);
  const float t_cl =
      fminf(fmaxf((t_obs - kLutTMin) * kLutScale, 0.0f), static_cast<float>(kLutSteps - 1));
  const float i0f = floorf(t_cl);
  const float frac = t_cl - i0f;
  const int i0 = static_cast<int>(i0f);
  const int i1 = min(i0 + 1, kLutSteps - 1);
  auto lerp = [&](int c) {
    const float c0 = kDiskLut[c * kLutSteps + i0];
    const float c1 = kDiskLut[c * kLutSteps + i1];
    return (c0 + frac * (c1 - c0)) * intensity;
  };
  out_r = lerp(0);
  out_g = lerp(1);
  out_b = lerp(2);
}

template <bool FAST, int INTEG, bool KS, int FLAGS = kFlagsAtLaunch>
__global__ void __launch_bounds__(256)
    render_mono_kernel(const Params p, const uint32_t seed_term, const int flags,
                       const int height, const int width, const int max_steps,
                       uint32_t* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;

  const Ray ray = trace_ray<FAST, INTEG, KS, FLAGS>(p, flags, row, col, max_steps);

  // ---- shade, quantize, pack (pallas_trace.py:1294-1333)
  const bool captured = ray.status == kCaptured;
  float r, g, b;
  if (FAST && ray.status == kOnDisk) {
    shade_disk(p, ray.rel, ray.vel, r, g, b);
  } else {
    procedural_background<FAST>(ray.vel, seed_term, r, g, b);
  }
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

// The flags of the Kerr-Schild disk frame, whose fast Euler launch has an
// instantiation of its own.
constexpr int kFastKsDisk = kFlagKS | kFlagDisk;

template <bool FAST, bool KS>
void launch(int integrator, dim3 grid, dim3 block, cudaStream_t s, const Params& params,
            uint32_t seed_term, int flags, int height, int width, int max_steps,
            uint32_t* frame) {
  switch (integrator) {
    case kEuler:
      if (flags == 0) {  // the main path: its own instantiation, no flag tested a step
        render_mono_kernel<FAST, kEuler, false, 0><<<grid, block, 0, s>>>(
            params, seed_term, flags, height, width, max_steps, frame);
      } else if (FAST && KS && flags == kFastKsDisk) {  // BASELINE config 5's fast frame
        render_mono_kernel<true, kEuler, true, kFastKsDisk><<<grid, block, 0, s>>>(
            params, seed_term, flags, height, width, max_steps, frame);
      } else {
        render_mono_kernel<FAST, kEuler, KS><<<grid, block, 0, s>>>(params, seed_term, flags,
                                                                     height, width, max_steps,
                                                                     frame);
      }
      break;
    case kRk4:
      render_mono_kernel<FAST, kRk4, KS><<<grid, block, 0, s>>>(params, seed_term, flags, height,
                                                                 width, max_steps, frame);
      break;
    default:
      render_mono_kernel<FAST, kLeapfrog, KS><<<grid, block, 0, s>>>(params, seed_term, flags,
                                                                      height, width, max_steps,
                                                                      frame);
  }
}

}  // namespace
}  // namespace bhr

// C entry point, bound with ctypes by bhr_tpu_torch/utils/build.py.
// Launches one frame on `stream` into `out`, a contiguous (height, width)
// array of 32-bit words on `device`, and returns cudaGetLastError() after
// the launch (0 on success). Does not synchronise. `integrator` is an
// Integrator and `flags` a TraceFlags mask of trace_ray.cuh (at most one
// of flat, kerr_lt and Kerr-Schild); the disk flag needs `fast` and a
// table set by bhr_set_disk_lut. An Euler launch with no flag set runs
// the instantiation whose flags are fixed at 0 at compile time, and a fast
// Euler launch with exactly kFlagKS | kFlagDisk the one fixed at those.
extern "C" int bhr_render_mono(bhr::Params params, uint32_t seed_term, int fast, int integrator,
                               int flags, int height, int width, int max_steps, int device,
                               void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int models = flags & (bhr::kFlagFlat | bhr::kFlagLT | bhr::kFlagKS);
  if (integrator < bhr::kEuler || integrator > bhr::kLeapfrog ||
      ((flags & bhr::kFlagDisk) && !fast) || (models & (models - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (height <= 0 || width <= 0) return 0;
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  auto* frame = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool ks = flags & bhr::kFlagKS;
  if (fast && ks) {
    bhr::launch<true, true>(integrator, grid, block, s, params, seed_term, flags, height, width,
                            max_steps, frame);
  } else if (fast) {
    bhr::launch<true, false>(integrator, grid, block, s, params, seed_term, flags, height, width,
                             max_steps, frame);
  } else if (ks) {
    bhr::launch<false, true>(integrator, grid, block, s, params, seed_term, flags, height, width,
                             max_steps, frame);
  } else {
    bhr::launch<false, false>(integrator, grid, block, s, params, seed_term, flags, height,
                              width, max_steps, frame);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copies the fast kernel's blackbody table (3 * 128 floats, channel-major,
// on the host) into `device`'s constant memory. Synchronous; called once
// per device before the first disk frame.
extern "C" int bhr_set_disk_lut(int device, const float* lut, int n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n != 3 * bhr::kLutSteps) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyToSymbol(bhr::kDiskLut, lut, n * sizeof(float)));
}

extern "C" const char* bhr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
