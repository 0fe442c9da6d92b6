// Staged shading kernel for Hopper (sm_90a): the epilogue of a staged frame
// shaded by the analytic star field, in one launch.
//
// Reads the planes a trace wrote (trace_planes.cu, the neural staged route):
// final position and direction fp32 (n, 3), status int32 (n); the step
// count is not read. Writes the packed RGBA word of each pixel. Pixel by
// pixel, in the order of the plain epilogue (bhr_tpu_torch/renderer.py
// shade_image_reference -> ops/shading.py:shade_planes_packed):
//   1. the star field of the final direction, starfield.cuh's
//      procedural_background<false> (plain version ops/starfield.py);
//   2. captured rays black;
//   3. with the disk, a disk ray's emission, `disk_emission` below (plain
//      version models/disk.py:disk_emission with the (512, 3) table);
//   4. round half to even and pack (starfield.cuh quantize_half_even).
// Every operation is correctly rounded and never contracted (Arith<false>)
// and is the one PyTorch's CUDA kernel computes for the plain version's op,
// so the words are bit-equal to the plain epilogue's. Both math tiers shade
// a staged frame with the same exact operations and the same quantizer, so
// the kernel has no tier. bhr_tpu has no Pallas kernel here: it leaves this
// epilogue (bhr_tpu/renderer.py:316-395) to XLA's fusion, and the port ran
// it as about a thousand PyTorch launches a frame, most of them the star
// field's int64 hashing.
//
// What bounds it: instruction issue. A pixel reads 16 bytes (28 on the
// disk) and writes 4, about 41-66 MB at 1920x1080, 0.01-0.02 ms of the
// card's 3.35 TB/s; it issues roughly 800 instructions (9 star cells of 4
// lowbias32 hashes and ~45 fp32 operations, the band, the tone map, the
// quantizer), about 5e7 warp instructions a 1920x1080 frame, ~0.05 ms at
// one warp instruction a scheduler a clock. One thread a pixel in blocks of
// 256; the three floats of a direction are read by one thread, so a warp's
// loads cover 384 contiguous bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "starfield.cuh"
#include "trace_ray.cuh"

namespace bhr {
namespace {

// Python-float constants of models/disk.py, rounded to fp32 as PyTorch
// rounds a Python scalar for an fp32 tensor.
constexpr int kLutSteps = 512;  // LUT_STEPS: the staged epilogue's table
constexpr float kLutTMin = 1000.0f;
constexpr float kLutTSpan = 29000.0f;  // LUT_T_MAX - LUT_T_MIN
constexpr float kTIsco = 10000.0f;     // T_ISCO
constexpr float kMaxBeta2 = static_cast<float>(0.81);
constexpr float kTinyNorm = static_cast<float>(1e-20);
constexpr float kRsGuard = static_cast<float>(1.001);
constexpr float kMinGrav = static_cast<float>(1e-4);
constexpr float kMinG = static_cast<float>(1e-3);
constexpr float kMinRatio = static_cast<float>(1e-6);

// torch.clamp, clamp_min and maximum on CUDA: a NaN operand passes through.
__device__ __forceinline__ float clamp_t(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_t(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float maximum_t(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ Vec3 scale_div(Vec3 v, float s) {
  using A = Arith<false>;
  return {A::div(v.x, s), A::div(v.y, s), A::div(v.z, s)};
}

struct Disk {
  float rs, r_isco, r_outer, t_isco, observer_r;
};

// The staged epilogue's disk emission at hit point `hit` (relative to the
// black hole) along final direction `dir`: models/disk.py:disk_emission
// with redshift_factor, keplerian_velocity, disk_temperature and
// temperature_to_color on the (512, 3) `lut`, operation for operation.
// Each true division is a division (the plain version divides by tensors
// on the device, never by a host scalar's reciprocal); `1.0 / x` is
// PyTorch's reciprocal, the same correctly rounded quotient; the power is
// common.cuh disk_temperature_power, powf as torch.pow of a tensor by -0.75
// computes it.
__device__ __forceinline__ void disk_emission(Vec3 hit, Vec3 dir, const Disk& k,
                                              const float* __restrict__ lut, float& out_r,
                                              float& out_g, float& out_b) {
  using A = Arith<false>;
  const float r = A::sqrt(dot<false>(hit, hit));
  // keplerian_velocity: beta = sqrt(clip(M / r, 0, 0.81)) along the unit
  // tangent (z, 0, -x)
  const float beta_k = A::sqrt(clamp_t(A::div(A::mul(k.rs, 0.5f), r), 0.0f, kMaxBeta2));
  const Vec3 tangent = {hit.z, 0.0f, -hit.x};
  const Vec3 t_hat = scale_div(tangent, clamp_min_t(A::sqrt(dot<false>(tangent, tangent)),
                                                     kTinyNorm));
  const Vec3 v = {A::mul(beta_k, t_hat.x), A::mul(beta_k, t_hat.y), A::mul(beta_k, t_hat.z)};
  // redshift_factor: Doppler x gravitational, the emitter against the observer
  const float beta = A::sqrt(dot<false>(v, v));
  const Vec3 v_hat = scale_div(v, clamp_min_t(beta, kTinyNorm));
  const Vec3 d = scale_div(dir, A::sqrt(dot<false>(dir, dir)));
  const float cos_theta = dot<false>(v_hat, d);
  const float doppler = A::div(A::sub(1.0f, A::mul(beta, cos_theta)),
                               A::sqrt(A::sub(1.0f, A::mul(beta, beta))));
  const float rs_guard = A::mul(kRsGuard, k.rs);
  const float grav_emit =
      A::sqrt(clamp_t(A::sub(1.0f, A::div(k.rs, maximum_t(r, rs_guard))), kMinGrav, 1.0f));
  const float grav_obs = A::sqrt(
      clamp_t(A::sub(1.0f, A::div(k.rs, maximum_t(k.observer_r, rs_guard))), kMinGrav, 1.0f));
  const float g = clamp_min_t(A::mul(doppler, A::div(grav_emit, grav_obs)), kMinG);
  // T_obs = T_isco (r / r_isco)^-3/4 / g
  const float t_emit =
      A::mul(k.t_isco, disk_temperature_power(clamp_min_t(A::div(r, k.r_isco), kMinRatio)));
  const float t_obs = A::div(t_emit, g);
  // temperature_to_color: the indexed lerp on the table, clamped to it (the
  // index clamp changes nothing but a NaN's)
  const float x = clamp_t(
      A::mul(A::div(A::sub(t_obs, kLutTMin), kLutTSpan), static_cast<float>(kLutSteps - 1)),
      0.0f, static_cast<float>(kLutSteps - 1));
  const int i0 = min(max(static_cast<int>(floorf(x)), 0), kLutSteps - 1);
  const int i1 = min(i0 + 1, kLutSteps - 1);
  const float f = A::sub(x, static_cast<float>(i0));
  const float w0 = A::sub(1.0f, f);
  // beaming 1 / g^3, the outer edge's fade, the clipped intensity
  const float beaming = A::div(1.0f, A::mul(A::mul(g, g), g));
  const float edge =
      clamp_t(A::div(A::sub(k.r_outer, r), A::sub(k.r_outer, k.r_isco)), 0.0f, 1.0f);
  const float rel_t = A::div(t_obs, kTIsco);
  const float intensity =
      clamp_t(A::mul(A::mul(beaming, A::mul(rel_t, rel_t)), edge), 0.0f, 4.0f);
  const float* c0 = lut + 3 * i0;
  const float* c1 = lut + 3 * i1;
  out_r = A::mul(A::add(A::mul(__ldg(c0 + 0), w0), A::mul(__ldg(c1 + 0), f)), intensity);
  out_g = A::mul(A::add(A::mul(__ldg(c0 + 1), w0), A::mul(__ldg(c1 + 1), f)), intensity);
  out_b = A::mul(A::add(A::mul(__ldg(c0 + 2), w0), A::mul(__ldg(c1 + 2), f)), intensity);
}

struct ShadeArgs {
  Vec3 bh, cam;
  float rs;
  uint32_t seed_term;
  int disk;
  const float* r_isco;  // DiskParams' 0-d tensors, on the device
  const float* r_outer;
  const float* t_isco;
  const float* lut;  // (512, 3) fp32
};

__global__ void __launch_bounds__(256)
    shade_planes_kernel(const ShadeArgs a, const int64_t n, const float* __restrict__ pos,
                        const float* __restrict__ vel, const int32_t* __restrict__ status,
                        uint32_t* __restrict__ out) {
  using A = Arith<false>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int st = status[i];
  const Vec3 dir = {vel[3 * i + 0], vel[3 * i + 1], vel[3 * i + 2]};
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (a.disk && st == kOnDisk) {
    const Vec3 hit = {A::sub(pos[3 * i + 0], a.bh.x), A::sub(pos[3 * i + 1], a.bh.y),
                      A::sub(pos[3 * i + 2], a.bh.z)};
    const Vec3 to_cam = {A::sub(a.cam.x, a.bh.x), A::sub(a.cam.y, a.bh.y),
                         A::sub(a.cam.z, a.bh.z)};
    const Disk k = {a.rs, *a.r_isco, *a.r_outer, *a.t_isco, A::sqrt(dot<false>(to_cam, to_cam))};
    disk_emission(hit, dir, k, a.lut, r, g, b);
  } else if (st != kCaptured) {
    procedural_background<false>(dir, a.seed_term, r, g, b);
  }
  out[i] = quantize_half_even(r, false) | (quantize_half_even(g, false) << 8) |
           (quantize_half_even(b, false) << 16) | 0xFF000000u;
}

}  // namespace
}  // namespace bhr

// C entry point, bound with ctypes by bhr_tpu_torch/utils/build.py.
// Shades `n` pixels on `stream` into `out`, n 32-bit words on `device`:
// `vel` fp32 (n, 3) and `status` int32 (n) always, `pos` fp32 (n, 3) only
// with `disk` (may be null without). `rs`, the black hole's and the
// camera's positions are the scene's fp32 values; with `disk`, `r_isco`,
// `r_outer` and `t_isco` point at one fp32 each and `lut` at the (512, 3)
// fp32 table, all on `device`. Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise.
extern "C" int bhr_shade_planes(int64_t n, uint32_t seed_term, int disk, float rs, float bh_x,
                                float bh_y, float bh_z, float cam_x, float cam_y, float cam_z,
                                const void* r_isco, const void* r_outer, const void* t_isco,
                                const void* lut, const void* pos, const void* vel,
                                const void* status, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || !vel || !status || !out ||
      (disk && (!pos || !r_isco || !r_outer || !t_isco || !lut))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const bhr::ShadeArgs args = {{bh_x, bh_y, bh_z},
                               {cam_x, cam_y, cam_z},
                               rs,
                               seed_term,
                               disk,
                               static_cast<const float*>(r_isco),
                               static_cast<const float*>(r_outer),
                               static_cast<const float*>(t_isco),
                               static_cast<const float*>(lut)};
  const int block = 256;
  const int64_t grid = (n + block - 1) / block;
  bhr::shade_planes_kernel<<<static_cast<unsigned>(grid), block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      args, n, static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const int32_t*>(status), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bhr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
