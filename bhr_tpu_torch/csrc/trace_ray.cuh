// One ray's trace, shared by the monolithic kernel (render_mono.cu) and the
// planes kernel (trace_planes.cu): ray-gen from the 32-float parameter
// struct, the geodesic loop with a per-thread `break`, and the ray's
// status and step count, each held in one register.
//
// Replaces bhr_tpu/ops/pallas_trace.py:_stateless_trace (:702-1149) and the
// loop of `kernel` (:1335-1650). The TPU kernels' dt-freeze termination, the
// disk's y-sentinel teleport and the status scratch exist only because a
// TPU tile has no per-lane control flow; here a ray leaves the loop when it
// terminates, and the loop writes what the oracle's loop would.
//
// Each integrator is written once per tier:
//  * exact (FAST = false): correctly rounded, uncontracted fp32 in the
//    oracle's operation order (bhr_tpu/ops/geodesic.py euler_step, rk4_step,
//    leapfrog_step, adaptive_dt; models/schwarzschild.py:acceleration;
//    models/disk.py:intersect_equatorial), termination on the sqrt'd radius;
//  * fast (FAST = true): the folded forms of pallas_trace.py
//    (physics_substep :793-834, sl_deriv :469-497, sl_rk4 :499-530,
//    sl_leapfrog :532-546) with rsqrt and an approximate reciprocal,
//    termination and the disk annulus in r^2 space.
// The integrator is a template parameter; the flat model, adaptive dt and
// the disk are uniform runtime flags.

#pragma once

#include "common.cuh"

namespace bhr {

enum Integrator : int { kEuler = 0, kRk4 = 1, kLeapfrog = 2 };

// Runtime switches of a launch (TraceFlags in ops/trace_kernel.py).
enum TraceFlags : int { kFlagFlat = 1, kFlagAdaptive = 2, kFlagDisk = 4 };

// ops/trace.py STATUS_*.
enum RayStatus : int { kRunning = 0, kEscaped = 1, kCaptured = 2, kOnDisk = 3 };

struct Ray {
  Vec3 rel;    // position relative to the black hole at termination
  Vec3 vel;    // unit direction at termination
  int status;  // RayStatus
  int steps;   // loop iterations entered (the oracle's i + 1 at termination)
};

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

// a + b * s (the oracle's `rel + 0.5 * dt * k` rounds the same)
template <bool FAST>
__device__ __forceinline__ Vec3 axpy(Vec3 a, Vec3 b, float s) {
  using A = Arith<FAST>;
  return {A::add(a.x, A::mul(b.x, s)), A::add(a.y, A::mul(b.y, s)),
          A::add(a.z, A::mul(b.z, s))};
}

// ---- exact tier -------------------------------------------------------------

// models/schwarzschild.py:acceleration in its literal order; zero for flat.
__device__ __forceinline__ Vec3 accel_exact(Vec3 rel, Vec3 vel, float r, float rs,
                                            bool flat) {
  using A = Arith<false>;
  if (flat) return {0.0f, 0.0f, 0.0f};
  const Vec3 r_vec = {A::div(rel.x, r), A::div(rel.y, r), A::div(rel.z, r)};
  const float v_rad = dot<false>(vel, r_vec);
  const float rs_over_r = A::div(rs, r);
  const float one_m = A::sub(1.0f, rs_over_r);
  const float factor = A::div(rs, A::mul(A::mul(A::mul(2.0f, r), r), one_m));
  const float one_p = A::add(1.0f, rs_over_r);
  const float nf = -factor;
  return {
      A::mul(nf, A::sub(A::mul(vel.x, one_m), A::mul(A::mul(r_vec.x, v_rad), one_p))),
      A::mul(nf, A::sub(A::mul(vel.y, one_m), A::mul(A::mul(r_vec.y, v_rad), one_p))),
      A::mul(nf, A::sub(A::mul(vel.z, one_m), A::mul(A::mul(r_vec.z, v_rad), one_p))),
  };
}

// geodesic.py _radius_guard: 1.0001 * max(rs, 1e-6)
__device__ __forceinline__ float radius_guard(float rs) {
  return __fmul_rn(static_cast<float>(1.0001), fmaxf(rs, static_cast<float>(1e-6)));
}

__device__ __forceinline__ float guarded_radius(Vec3 p, float guard) {
  return fmaxf(__fsqrt_rn(dot<false>(p, p)), guard);
}

// k1 + 2 k2 + 2 k3 + k4, summed left to right as the oracle writes it
__device__ __forceinline__ Vec3 rk4_sum(Vec3 k1, Vec3 k2, Vec3 k3, Vec3 k4) {
  using A = Arith<false>;
  return {
      A::add(A::add(A::add(k1.x, A::mul(2.0f, k2.x)), A::mul(2.0f, k3.x)), k4.x),
      A::add(A::add(A::add(k1.y, A::mul(2.0f, k2.y)), A::mul(2.0f, k3.y)), k4.y),
      A::add(A::add(A::add(k1.z, A::mul(2.0f, k2.z)), A::mul(2.0f, k3.z)), k4.z),
  };
}

// One step of the oracle: new position and (not yet unit) velocity.
template <int INTEG>
__device__ __forceinline__ void step_exact(Vec3 rel, Vec3 vel, float r, float rs, float dt,
                                           bool flat, Vec3& new_rel, Vec3& new_vel) {
  using A = Arith<false>;
  if constexpr (INTEG == kEuler) {
    const Vec3 a = accel_exact(rel, vel, r, rs, flat);
    new_vel = axpy<false>(vel, a, dt);
    new_rel = axpy<false>(rel, new_vel, dt);
  } else if constexpr (INTEG == kRk4) {
    const float guard = radius_guard(rs);
    const float half = A::mul(0.5f, dt);
    const Vec3 k1p = vel;
    const Vec3 k1v = accel_exact(rel, vel, guarded_radius(rel, guard), rs, flat);
    const Vec3 p2 = axpy<false>(rel, k1p, half);
    const Vec3 k2p = axpy<false>(vel, k1v, half);
    const Vec3 k2v = accel_exact(p2, k2p, guarded_radius(p2, guard), rs, flat);
    const Vec3 p3 = axpy<false>(rel, k2p, half);
    const Vec3 k3p = axpy<false>(vel, k2v, half);
    const Vec3 k3v = accel_exact(p3, k3p, guarded_radius(p3, guard), rs, flat);
    const Vec3 p4 = axpy<false>(rel, k3p, dt);
    const Vec3 k4p = axpy<false>(vel, k3v, dt);
    const Vec3 k4v = accel_exact(p4, k4p, guarded_radius(p4, guard), rs, flat);
    const float sixth = A::mul(dt, static_cast<float>(1.0 / 6.0));
    new_rel = axpy<false>(rel, rk4_sum(k1p, k2p, k3p, k4p), sixth);
    new_vel = axpy<false>(vel, rk4_sum(k1v, k2v, k3v, k4v), sixth);
  } else {
    const float half = A::mul(0.5f, dt);
    const Vec3 a1 = accel_exact(rel, vel, r, rs, flat);
    const Vec3 v_half = axpy<false>(vel, a1, half);
    new_rel = axpy<false>(rel, v_half, dt);
    const float rr = guarded_radius(new_rel, radius_guard(rs));
    const Vec3 a2a = accel_exact(new_rel, v_half, rr, rs, flat);
    const Vec3 v_pred = axpy<false>(v_half, a2a, half);
    const Vec3 a2 = accel_exact(new_rel, v_pred, rr, rs, flat);
    new_vel = axpy<false>(v_half, a2, half);
  }
}

// ---- fast tier --------------------------------------------------------------

// pallas_trace.py sl_deriv: a = p * a2 - v * a1, one_m clamped at 0.02
__device__ __forceinline__ Vec3 sl_deriv(Vec3 p, Vec3 v, float rs) {
  const float rr2 = dot<true>(p, p);
  const float inv_rr = rsqrtf(rr2);
  const float rs_inv = rs * inv_rr;
  const float one_m = fmaxf(1.0f - rs_inv, static_cast<float>(0.02));
  const float factor = rs * rcp_approx(2.0f * rr2 * one_m);
  const float c = dot<true>(v, p);
  const float a1 = factor * one_m;
  const float a2 = factor * (1.0f + rs_inv) * c * (inv_rr * inv_rr);
  return {p.x * a2 - v.x * a1, p.y * a2 - v.y * a1, p.z * a2 - v.z * a1};
}

// One step of the fast tier: new position and unit velocity.
template <int INTEG>
__device__ __forceinline__ void step_fast(Vec3 rel, Vec3 vel, float r2, float rs, float dt,
                                          bool flat, Vec3& new_rel, Vec3& new_vel) {
  if constexpr (INTEG == kEuler) {
    // physics_substep: v' = v b1 + rel b2 (v' = v in flat spacetime)
    Vec3 nv = vel;
    if (!flat) {
      const float inv_r = rsqrtf(r2);
      const float c = dot<true>(vel, rel);
      const float rs_inv_r = rs * inv_r;
      const float one_m = fmaxf(1.0f - rs_inv_r, static_cast<float>(0.02));
      const float factor_dt = (rs * rcp_approx(2.0f * r2 * one_m)) * dt;
      const float b1 = 1.0f - factor_dt * one_m;
      const float b2 = factor_dt * (1.0f + rs_inv_r) * c * (inv_r * inv_r);
      nv = {vel.x * b1 + rel.x * b2, vel.y * b1 + rel.y * b2, vel.z * b1 + rel.z * b2};
    }
    new_rel = axpy<true>(rel, nv, dt);
    new_vel = vnorm<true>(nv);
  } else if (flat) {
    // sl_rk4 / sl_leapfrog: a straight line, velocity untouched
    new_rel = axpy<true>(rel, vel, dt);
    new_vel = vel;
  } else if constexpr (INTEG == kRk4) {
    const float half = 0.5f * dt;
    const Vec3 k1v = sl_deriv(rel, vel, rs);
    const Vec3 p2 = axpy<true>(rel, vel, half);
    const Vec3 v2 = axpy<true>(vel, k1v, half);
    const Vec3 k2v = sl_deriv(p2, v2, rs);
    const Vec3 p3 = axpy<true>(rel, v2, half);
    const Vec3 v3 = axpy<true>(vel, k2v, half);
    const Vec3 k3v = sl_deriv(p3, v3, rs);
    const Vec3 p4 = axpy<true>(rel, v3, dt);
    const Vec3 v4 = axpy<true>(vel, k3v, dt);
    const Vec3 k4v = sl_deriv(p4, v4, rs);
    const float sixth = dt * static_cast<float>(1.0 / 6.0);
    const Vec3 kp = {vel.x + 2.0f * (v2.x + v3.x) + v4.x, vel.y + 2.0f * (v2.y + v3.y) + v4.y,
                     vel.z + 2.0f * (v2.z + v3.z) + v4.z};
    const Vec3 kv = {k1v.x + 2.0f * (k2v.x + k3v.x) + k4v.x,
                     k1v.y + 2.0f * (k2v.y + k3v.y) + k4v.y,
                     k1v.z + 2.0f * (k2v.z + k3v.z) + k4v.z};
    new_rel = axpy<true>(rel, kp, sixth);
    new_vel = vnorm<true>(axpy<true>(vel, kv, sixth));
  } else {
    const float half = 0.5f * dt;
    const Vec3 a1 = sl_deriv(rel, vel, rs);
    const Vec3 vh = axpy<true>(vel, a1, half);
    new_rel = axpy<true>(rel, vh, dt);
    const Vec3 a2a = sl_deriv(new_rel, vh, rs);
    const Vec3 vp = axpy<true>(vh, a2a, half);
    const Vec3 a2 = sl_deriv(new_rel, vp, rs);
    new_vel = vnorm<true>(axpy<true>(vh, a2, half));
  }
}

// ---- the accretion disk's crossing test ---------------------------------------

// Did the segment old -> nw cross y = 0 inside the annulus? On a hit, `hit`
// is the crossing point with y = 0. Exact: models/disk.py
// intersect_equatorial (t = -oy / (ny - oy), the annulus on the sqrt'd
// radius of the interpolated point). Fast: pallas_trace.py:1068-1075
// (t by an approximate reciprocal, the annulus in r^2 of x and z).
template <bool FAST>
__device__ __forceinline__ bool disk_crossing(Vec3 old, Vec3 nw, float r_isco, float r_outer,
                                              Vec3& hit) {
  using A = Arith<FAST>;
  const float oy = old.y, ny = nw.y;
  const bool crosses = A::mul(oy, ny) < 0.0f;
  if (!crosses) return false;
  const float den = A::sub(ny, oy);
  if constexpr (FAST) {
    const float tt = -oy * rcp_approx(den);
    const float hx = old.x + tt * (nw.x - old.x);
    const float hz = old.z + tt * (nw.z - old.z);
    const float hr2 = hx * hx + hz * hz;
    hit = {hx, 0.0f, hz};
    return hr2 >= r_isco * r_isco && hr2 <= r_outer * r_outer;
  } else {
    const float t = A::div(-oy, den);
    const Vec3 h = {A::add(old.x, A::mul(t, A::sub(nw.x, old.x))),
                    A::add(old.y, A::mul(t, A::sub(nw.y, old.y))),
                    A::add(old.z, A::mul(t, A::sub(nw.z, old.z)))};
    const float hr = A::sqrt(dot<false>(h, h));
    hit = {h.x, 0.0f, h.z};
    return hr >= r_isco && hr <= r_outer;
  }
}

// ---- the ray ------------------------------------------------------------------

// Primary ray of pixel (row, col) of the band at (P_ROW0, P_COL0)
// (pallas_trace.py:742-765; core/camera.py:generate_rays), normalised
// twice as generate_rays and trace_rays each normalise.
template <bool FAST>
__device__ __forceinline__ void generate_ray(const Params& p, int row, int col, Vec3& rel,
                                             Vec3& vel) {
  using A = Arith<FAST>;
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
  vel = vnorm<FAST>(vnorm<FAST>(d));
  rel = {A::sub(p.v[P_CAM + 0], p.v[P_BH + 0]), A::sub(p.v[P_CAM + 1], p.v[P_BH + 1]),
         A::sub(p.v[P_CAM + 2], p.v[P_BH + 2])};
}

// The oracle's loop (ops/trace.py:trace_rays) for one ray: test, then
// step, until the ray escapes, is captured, hits the disk or runs out of
// steps. `flags` is a TraceFlags mask.
template <bool FAST, int INTEG>
__device__ __forceinline__ Ray trace_ray(const Params& p, int flags, int row, int col,
                                         int max_steps) {
  using A = Arith<FAST>;
  Ray ray;
  generate_ray<FAST>(p, row, col, ray.rel, ray.vel);
  ray.status = kRunning;
  ray.steps = 0;
  const bool flat = flags & kFlagFlat;
  const bool adaptive = flags & kFlagAdaptive;
  const bool disk = flags & kFlagDisk;
  const float rs = p.v[P_RS];
  const float base_dt = p.v[P_DT];
  const float esc = p.v[P_ESC];
  const float cap = p.v[P_CAP];
  const float esc2 = A::mul(esc, esc);
  const float cap2 = A::mul(cap, cap);
  const float r_isco = p.v[P_RISCO];
  const float r_outer = p.v[P_ROUTER];
  for (int i = 0; i < max_steps; ++i) {
    ray.steps = i + 1;
    const float r2 = dot<FAST>(ray.rel, ray.rel);
    float r = 0.0f;  // the exact tier's sqrt'd radius
    if constexpr (FAST) {
      if (r2 > esc2) { ray.status = kEscaped; break; }
      if (r2 < cap2) { ray.status = kCaptured; break; }
    } else {
      r = A::sqrt(r2);
      if (r > esc) { ray.status = kEscaped; break; }
      if (r < cap) { ray.status = kCaptured; break; }
    }
    float dt = base_dt;
    if (adaptive) {
      // geodesic.py:adaptive_dt; the fast tier's radius is r2 * rsqrt(r2)
      const float rc = FAST ? r2 * rsqrtf(r2) : r;
      dt = A::mul(base_dt, fminf(fmaxf(A::mul(A::sub(rc, rs), static_cast<float>(0.1)),
                                       static_cast<float>(0.01)), 1.0f));
    }
    Vec3 new_rel, new_vel;
    if constexpr (FAST) {
      step_fast<INTEG>(ray.rel, ray.vel, r2, rs, dt, flat, new_rel, new_vel);
    } else {
      step_exact<INTEG>(ray.rel, ray.vel, r, rs, dt, flat, new_rel, new_vel);
      new_vel = vnorm<false>(new_vel);
    }
    Vec3 hit;
    if (disk && disk_crossing<FAST>(ray.rel, new_rel, r_isco, r_outer, hit)) {
      ray.rel = hit;
      ray.vel = new_vel;
      ray.status = kOnDisk;
      break;
    }
    ray.rel = new_rel;
    ray.vel = new_vel;
  }
  return ray;
}

}  // namespace bhr
