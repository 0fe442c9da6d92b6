// Staged trace kernel for Hopper (sm_90a): the trace alone, written out as
// per-pixel planes for the shading epilogue.
//
// Replaces bhr_tpu/ops/pallas_trace.py:kernel_stateless (K4, via
// _pallas_trace and pallas_trace_image) and its step-counting flavour
// `kernel` (K5, track_steps=True, body_fast) for the euler, rk4 and leapfrog
// integrators, fixed or adaptive dt, the Schwarzschild, exact Kerr
// (Kerr-Schild, K6), Lense-Thirring Kerr (K7) or flat metric, with or without
// the accretion disk, in both math tiers (the Kerr-Schild loop a template
// parameter: 12 instantiations, 2 more of Euler with the flags fixed at 0,
// which a frame with no flag set launches, as render_mono.cu describes, 1 of
// the exact tier's rk4 with the flags fixed at adaptive | disk, which
// BASELINE config 4's exact frame launches, and 1 of the exact tier's
// Kerr-Schild Euler with the flags fixed at Kerr-Schild | disk, which
// BASELINE config 5's exact frame launches, its step testing only whether the
// segment crosses the disk's plane (trace_ray.cuh DISK_APART): 16). One
// thread traces one pixel (trace_ray.cuh) and writes its TraceResult: final
// position and unit direction as fp32 (H, W, 3), status and step count as
// int32 (H, W). On a TPU tile the step count cost a scratch plane and its own
// kernel flavour; here status and steps are one register each, so K4 and K5
// are this one kernel, which always writes `steps` with the oracle's meaning
// (i + 1 at termination). Status uses the oracle's codes, STATUS_DISK
// included; a disk ray's position is its hit point, with the black hole's y.
// For Kerr-Schild rays `vel` is the unit coordinate direction dq/dl, not the
// momentum the loop carries.
//
// Two ray-gen options of K4 that only multires reaches (bhr_tpu/ops/
// multires.py), both runtime arguments of the one kernel, so that every
// instantiation has them:
//  * strided (pallas_trace.py:745-755): the grid covers a local (height,
//    width) and thread (row, col) traces full-image pixel (row * stride +
//    row0, col * stride + col0) -- stride, row0 and col0 come from the
//    parameter struct (trace_ray.cuh:generate_ray), the outputs are indexed
//    locally;
//  * masked (pallas_trace.py:769-783): `mask` is fp32 (height, width) or
//    null; a thread whose mask is not > 0 integrates nothing and writes
//    defined values -- the camera position, its initial unit direction,
//    kEscaped, 0 steps -- that the caller's merge discards. The TPU kernel
//    got the same saving by starting such rays outside the escape sphere,
//    because a tile, not a pixel, was its unit of control flow; here the
//    thread returns, and a warp that is wholly masked off retires at once.
// bhr_tpu's `linear` ray-gen is a TPU tiling knob with identical results.
//
// What bounds it: instruction issue in the geodesic loop, as for
// render_mono.cu; the 32 bytes written per pixel are ~66 MB a 1920x1080
// frame, a few tens of microseconds of the card's bandwidth against
// milliseconds of loop. A masked launch reads 4 more bytes a pixel and
// integrates only the rays its mask keeps: an edge mask is a thin ring, so
// the few warps on it run the full loop while the others are gone.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "trace_ray.cuh"

namespace bhr {
namespace {

template <bool FAST, int INTEG, bool KS, int FLAGS = kFlagsAtLaunch>
__global__ void __launch_bounds__(256)
    trace_planes_kernel(const Params p, const int flags, const int height, const int width,
                        const int max_steps, const float* __restrict__ mask,
                        float* __restrict__ pos, float* __restrict__ vel,
                        int32_t* __restrict__ status, int32_t* __restrict__ steps) {
  using A = Arith<FAST>;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;
  const int64_t i = static_cast<int64_t>(row) * width + col;

  if (mask != nullptr && !(mask[i] > 0.0f)) {
    Vec3 rel, dir;
    generate_ray<FAST>(p, row, col, rel, dir);
    pos[3 * i + 0] = p.v[P_CAM + 0];
    pos[3 * i + 1] = p.v[P_CAM + 1];
    pos[3 * i + 2] = p.v[P_CAM + 2];
    vel[3 * i + 0] = dir.x;
    vel[3 * i + 1] = dir.y;
    vel[3 * i + 2] = dir.z;
    status[i] = kEscaped;
    steps[i] = 0;
    return;
  }

  const Ray ray = trace_ray<FAST, INTEG, KS, FLAGS>(p, flags, row, col, max_steps);

  pos[3 * i + 0] = A::add(ray.rel.x, p.v[P_BH + 0]);
  pos[3 * i + 1] = A::add(ray.rel.y, p.v[P_BH + 1]);
  pos[3 * i + 2] = A::add(ray.rel.z, p.v[P_BH + 2]);
  vel[3 * i + 0] = ray.vel.x;
  vel[3 * i + 1] = ray.vel.y;
  vel[3 * i + 2] = ray.vel.z;
  status[i] = ray.status;
  steps[i] = ray.steps;
}

// The flags of BASELINE config 4's exact frame (rk4, adaptive dt, the
// disk) and of config 5's (Euler, the Kerr-Schild loop, the disk), whose
// exact launches have instantiations of their own.
constexpr int kExactRk4Disk = kFlagAdaptive | kFlagDisk;
constexpr int kExactKsDisk = kFlagKS | kFlagDisk;

template <bool FAST, bool KS>
void launch(int integrator, dim3 grid, dim3 block, cudaStream_t s, const Params& params,
            int flags, int height, int width, int max_steps, const float* mask, float* pos,
            float* vel, int32_t* status, int32_t* steps) {
  switch (integrator) {
    case kEuler:
      if (flags == 0) {  // the main path: its own instantiation, no flag tested a step
        trace_planes_kernel<FAST, kEuler, false, 0><<<grid, block, 0, s>>>(
            params, flags, height, width, max_steps, mask, pos, vel, status, steps);
      } else if (!FAST && KS && flags == kExactKsDisk) {  // config 5's exact frame
        trace_planes_kernel<false, kEuler, true, kExactKsDisk><<<grid, block, 0, s>>>(
            params, flags, height, width, max_steps, mask, pos, vel, status, steps);
      } else {
        trace_planes_kernel<FAST, kEuler, KS><<<grid, block, 0, s>>>(
            params, flags, height, width, max_steps, mask, pos, vel, status, steps);
      }
      break;
    case kRk4:
      if (!FAST && !KS && flags == kExactRk4Disk) {  // config 4's exact frame
        trace_planes_kernel<false, kRk4, false, kExactRk4Disk><<<grid, block, 0, s>>>(
            params, flags, height, width, max_steps, mask, pos, vel, status, steps);
      } else {
        trace_planes_kernel<FAST, kRk4, KS><<<grid, block, 0, s>>>(
            params, flags, height, width, max_steps, mask, pos, vel, status, steps);
      }
      break;
    default:
      trace_planes_kernel<FAST, kLeapfrog, KS><<<grid, block, 0, s>>>(
          params, flags, height, width, max_steps, mask, pos, vel, status, steps);
  }
}

}  // namespace
}  // namespace bhr

// C entry point, bound with ctypes by bhr_tpu_torch/utils/build.py.
// Traces (height, width) rays on `stream` into contiguous arrays on
// `device`: pos and vel fp32 (height, width, 3), status and steps int32
// (height, width). (height, width) is the frame, or the local shape of a
// strided or banded launch whose stride and origin are in `params`. `mask`
// is null, or fp32 (height, width) on `device`: rays whose mask is not > 0
// are not integrated. Returns cudaGetLastError() after the launch (0 on
// success); does not synchronise. `integrator` is an Integrator and `flags`
// a TraceFlags mask of trace_ray.cuh (at most one of flat, kerr_lt and
// Kerr-Schild). An Euler launch with no flag set runs the instantiation
// whose flags are fixed at 0 at compile time, an exact rk4 launch with
// exactly kFlagAdaptive | kFlagDisk the one fixed at those, and an exact
// Euler launch with exactly kFlagKS | kFlagDisk the one fixed at those
// (strided and masked launches alike).
extern "C" int bhr_trace_planes(bhr::Params params, int fast, int integrator, int flags,
                                int height, int width, int max_steps, int device,
                                const void* mask, void* pos, void* vel, void* status,
                                void* steps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int models = flags & (bhr::kFlagFlat | bhr::kFlagLT | bhr::kFlagKS);
  if (integrator < bhr::kEuler || integrator > bhr::kLeapfrog || (models & (models - 1)) ||
      !(params.v[bhr::P_STRIDE] >= 1.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (height <= 0 || width <= 0) return 0;
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<const float*>(mask);
  auto* p = static_cast<float*>(pos);
  auto* v = static_cast<float*>(vel);
  auto* st = static_cast<int32_t*>(status);
  auto* n = static_cast<int32_t*>(steps);
  const bool ks = flags & bhr::kFlagKS;
  if (fast && ks) {
    bhr::launch<true, true>(integrator, grid, block, s, params, flags, height, width, max_steps,
                            m, p, v, st, n);
  } else if (fast) {
    bhr::launch<true, false>(integrator, grid, block, s, params, flags, height, width,
                             max_steps, m, p, v, st, n);
  } else if (ks) {
    bhr::launch<false, true>(integrator, grid, block, s, params, flags, height, width,
                             max_steps, m, p, v, st, n);
  } else {
    bhr::launch<false, false>(integrator, grid, block, s, params, flags, height, width,
                              max_steps, m, p, v, st, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bhr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
