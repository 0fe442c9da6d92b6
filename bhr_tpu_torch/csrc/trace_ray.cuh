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
//    each acceleration's root and quotients (r, rel / r, rs / r, the
//    factor) and each renormalisation's (|v|, v / |v|) are one group: the
//    common paths of __fsqrt_rn and __fdiv_rn, a reciprocal a denominator,
//    and one guard a group that sends the rare group outside their window
//    to the intrinsics (common.cuh), so every value has their bits;
//  * fast (FAST = true): the folded forms of pallas_trace.py
//    (physics_substep :793-834, sl_deriv :469-497, sl_rk4 :499-530,
//    sl_leapfrog :532-546) with rsqrt and an approximate reciprocal,
//    termination and the disk annulus in r^2 space. Its rsqrt is the SFU's
//    (rsqrt_approx) without rsqrtf's subnormal handling: the two differ only
//    on a subnormal operand, and every operand here is a squared radius past
//    the capture test or a squared direction near 1.
// The integrator is a template parameter; the flat model, adaptive dt and
// the disk are uniform runtime flags, which a kernel may fix at compile
// time (its FLAGS template argument; the main path's Euler frame runs with
// none set, BASELINE config 4's exact frame with adaptive dt and the disk,
// config 5's fast and exact frames with the Kerr-Schild loop and the
// disk): the flag tests then fold away, and the loop a step runs is the
// same code with fewer instructions.
//
// Two Kerr models (ROADMAP item 9; replacing the K6 and K7 parts of the TPU
// kernels):
//  * kerr_lt (runtime flag kFlagLT): the Schwarzschild acceleration plus
//    the Lense-Thirring drag v x B_g (models/kerr.py:acceleration; fast:
//    pallas_trace.py physics_substep :821-831 and sl_deriv :486-496), on
//    the same (position, velocity) loop;
//  * kerr (template parameter KS): Hamiltonian null geodesics on (q, p) in
//    Cartesian Kerr-Schild form (pallas_trace.py:548-700, loop :1005-1047,
//    direction :1134-1146; oracle models/kerr_schild.py and
//    ops/trace.py:_trace_rays_kerr_schild), with its own state, step and
//    after-loop direction, so it is a loop of its own: trace_ray_ks. Its
//    exact tier keeps the oracle's expression trees; its fast tier takes
//    dp through the Kerr-Schild r (see that section).
//
// Plugin physics (model "custom"; K5's generic body, pallas_trace.py
// :1521-1585 with `accel` :351-361 returning the user's acceleration): a
// build of trace_planes.cu with BHR_CUSTOM_ACCEL defined, by a header that
// utils/plugin.py records from the plugin's Python and includes first,
// whose plugin_acceleration(rel, vel, r, r2, rs, spin) takes the place of
// accel_exact. The model has no folded form, so both tiers run the exact
// tier's loop -- termination and adaptive dt on the sqrt'd radius, the
// oracle's integrators, the exact disk crossing -- and the fast tier
// differs, as bhr_tpu's generic body does, by its rsqrt renormalisation
// (and its ray-gen's). Capture is at P_CAP = custom_capture_factor * rs.

#pragma once

#include "common.cuh"

namespace bhr {

enum Integrator : int { kEuler = 0, kRk4 = 1, kLeapfrog = 2 };

// Runtime switches of a launch (TraceFlags in ops/trace_kernel.py).
// kFlagKS selects the Kerr-Schild instantiation at launch.
enum TraceFlags : int {
  kFlagFlat = 1,
  kFlagAdaptive = 2,
  kFlagDisk = 4,
  kFlagLT = 8,
  kFlagKS = 16,
};

// A kernel's FLAGS template argument when the launch's `flags` decide.
constexpr int kFlagsAtLaunch = -1;

// The flags a kernel instantiated with FLAGS traces with: FLAGS itself, a
// compile-time constant, unless it is kFlagsAtLaunch.
template <int FLAGS>
__device__ __forceinline__ int trace_flags(int flags) {
  return FLAGS == kFlagsAtLaunch ? flags : FLAGS;
}

// The acceleration models' constants of a launch.
struct Phys {
  float rs;
  float spin;
  bool flat;  // zero acceleration
  bool lt;    // kerr_lt: add the Lense-Thirring drag
};

// jnp.maximum / torch.clamp_min with a finite bound: NaN stays NaN
// (fmaxf would return the bound).
__device__ __forceinline__ float maximum(float x, float lo) { return x < lo ? lo : x; }

// a x b (core/math.py cross), in one tier's arithmetic.
template <bool FAST>
__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  using A = Arith<FAST>;
  return {A::sub(A::mul(a.y, b.z), A::mul(a.z, b.y)), A::sub(A::mul(a.z, b.x), A::mul(a.x, b.z)),
          A::sub(A::mul(a.x, b.y), A::mul(a.y, b.x))};
}

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
  if constexpr (FAST) {
    const float s = rsqrt_approx(dot<true>(v, v));
    return {v.x * s, v.y * s, v.z * s};
  } else {
    // |v| and three quotients by it as one group behind one guard
    // (common.cuh): the root's common path, one reciprocal of |v|; the rare
    // vector the guard turns away takes __fsqrt_rn and __fdiv_rn
    const float x = dot<false>(v, v);
    float s = sqrt_rn_seq(x);
    const float y = rcp_rn_shared(s);
    Vec3 q = {div_by_rcp(v.x, s, y), div_by_rcp(v.y, s, y), div_by_rcp(v.z, s, y)};
    if (quotient_group_outside(magnitude_window(x) | magnitude_window(s) |
                                   magnitude_window(v.x) | magnitude_window(v.y) |
                                   magnitude_window(v.z),
                               s)) {
      s = __fsqrt_rn(x);
      q = {__fdiv_rn(v.x, s), __fdiv_rn(v.y, s), __fdiv_rn(v.z, s)};
    }
    return q;
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

// geodesic.py _radius_guard: 1.0001 * max(rs, 1e-6)
__device__ __forceinline__ float radius_guard(float rs) {
  return __fmul_rn(static_cast<float>(1.0001), fmaxf(rs, static_cast<float>(1e-6)));
}

#ifdef BHR_CUSTOM_ACCEL
constexpr bool kCustomAccel = true;

// What the plugin's accelerations at one point share: the point and its
// radius r, given or (accel_point_at) the guarded max(|rel|, guard).
struct AccelPoint {
  Vec3 rel;
  float r;
};

__device__ __forceinline__ AccelPoint accel_point(Vec3 rel, float r, const Phys&) {
  return {rel, r};
}

__device__ __forceinline__ AccelPoint accel_point_at(Vec3 rel, float guard, const Phys&) {
  return {rel, fmaxf(__fsqrt_rn(dot<false>(rel, rel)), guard)};
}

// ops/trace.py:custom_accel_arrays: the plugin's acceleration at the point,
// with r2 = r * r
__device__ __forceinline__ Vec3 accel_exact(const AccelPoint& at, Vec3 vel, const Phys& ph) {
  return plugin_acceleration(at.rel, vel, at.r, __fmul_rn(at.r, at.r), ph.rs, ph.spin);
}
#else
constexpr bool kCustomAccel = false;

// What models/schwarzschild.py:acceleration takes at a point rel, whatever
// the velocity: r, rel / r, rs / r and factor = rs / (2 r r (1 - rs / r)).
// Accelerations at one point share them.
struct AccelPoint {
  float r;
  Vec3 r_vec;  // rel / r
  float rs_over_r, one_m;
  float den;     // 2 r r one_m
  float factor;  // rs / den
};

// The radius given (ROOT false: x is r) or taken from x = |rel|^2 (ROOT
// true: r = max(sqrt(x), guard), geodesic.py's guarded radius), then the
// quotients, as one group behind one guard (common.cuh): the root's common
// path, one reciprocal of r for rel / r and rs / r, one of the factor's
// denominator, each quotient from its reciprocal. The rare point the guard
// turns away (an operand outside the window, e.g. a zero component of rel
// on a coordinate plane, or a denominator's all-ones mantissa) takes the
// group again by __fsqrt_rn and __fdiv_rn, in the same order, so every
// value is the oracle's.
template <bool ROOT>
__device__ __forceinline__ AccelPoint accel_quotients(Vec3 rel, float x, float guard, float rs) {
  using A = Arith<false>;
  const auto group = [&](auto root, auto rcp, auto quot) {
    AccelPoint g;
    g.r = ROOT ? fmaxf(root(x), guard) : x;
    const float y = rcp(g.r);
    g.r_vec = {quot(rel.x, g.r, y), quot(rel.y, g.r, y), quot(rel.z, g.r, y)};
    g.rs_over_r = quot(rs, g.r, y);
    g.one_m = A::sub(1.0f, g.rs_over_r);
    g.den = A::mul(A::mul(A::mul(2.0f, g.r), g.r), g.one_m);
    g.factor = quot(rs, g.den, rcp(g.den));
    return g;
  };
  AccelPoint g = group([](float v) { return sqrt_rn_seq(v); },
                       [](float b) { return rcp_rn_shared(b); },
                       [](float a, float b, float y) { return div_by_rcp(a, b, y); });
  uint32_t window = magnitude_window(g.r) | magnitude_window(g.den) | magnitude_window(rel.x) |
                    magnitude_window(rel.y) | magnitude_window(rel.z) | magnitude_window(rs);
  if (ROOT) window |= magnitude_window(x);
  if (quotient_group_outside(window, g.r, g.den)) {
    g = group([](float v) { return __fsqrt_rn(v); }, [](float) { return 0.0f; },
              [](float a, float b, float) { return __fdiv_rn(a, b); });
  }
  return g;
}

// models/schwarzschild.py:acceleration in its literal order from its
// quotients. For kerr_lt, plus models/kerr.py's drag in its
// literal order: B_g = (j / (r r r)) (3 jdotr r_hat - J_hat), j = (a* M) M,
// jdotr = r_hat.y (the oracle's sum adds two zeros to it), a = a_schw + v x
// B_g.
__device__ __forceinline__ Vec3 accel_from(Vec3 vel, const AccelPoint& g, const Phys& ph) {
  using A = Arith<false>;
  const float rs = ph.rs;
  const float r = g.r;
  const Vec3 r_vec = g.r_vec;
  const float v_rad = dot<false>(vel, r_vec);
  const float one_m = g.one_m;
  const float factor = g.factor;
  const float one_p = A::add(1.0f, g.rs_over_r);
  const float nf = -factor;
  Vec3 acc = {
      A::mul(nf, A::sub(A::mul(vel.x, one_m), A::mul(A::mul(r_vec.x, v_rad), one_p))),
      A::mul(nf, A::sub(A::mul(vel.y, one_m), A::mul(A::mul(r_vec.y, v_rad), one_p))),
      A::mul(nf, A::sub(A::mul(vel.z, one_m), A::mul(A::mul(r_vec.z, v_rad), one_p))),
  };
  if (ph.lt) {
    const float m = A::mul(rs, 0.5f);
    const float j = A::mul(A::mul(ph.spin, m), m);
    const float c = A::div(j, A::mul(A::mul(r, r), r));
    const float t = A::mul(3.0f, r_vec.y);
    const Vec3 bg = {A::mul(c, A::mul(t, r_vec.x)), A::mul(c, A::sub(A::mul(t, r_vec.y), 1.0f)),
                     A::mul(c, A::mul(t, r_vec.z))};
    const Vec3 drag = cross<false>(vel, bg);
    acc = {A::add(acc.x, drag.x), A::add(acc.y, drag.y), A::add(acc.z, drag.z)};
  }
  return acc;
}

// The point rel, whose radius is r.
__device__ __forceinline__ AccelPoint accel_point(Vec3 rel, float r, const Phys& ph) {
  return accel_quotients<false>(rel, r, 0.0f, ph.rs);
}

// The point rel, whose radius max(|rel|, guard) its group takes.
__device__ __forceinline__ AccelPoint accel_point_at(Vec3 rel, float guard, const Phys& ph) {
  return accel_quotients<true>(rel, dot<false>(rel, rel), guard, ph.rs);
}

// The acceleration at a point with velocity vel.
__device__ __forceinline__ Vec3 accel_exact(const AccelPoint& at, Vec3 vel, const Phys& ph) {
  return accel_from(vel, at, ph);
}
#endif

// k1 + 2 k2 + 2 k3 + k4, summed left to right as the oracle writes it
__device__ __forceinline__ Vec3 rk4_sum(Vec3 k1, Vec3 k2, Vec3 k3, Vec3 k4) {
  using A = Arith<false>;
  return {
      A::add(A::add(A::add(k1.x, A::mul(2.0f, k2.x)), A::mul(2.0f, k3.x)), k4.x),
      A::add(A::add(A::add(k1.y, A::mul(2.0f, k2.y)), A::mul(2.0f, k3.y)), k4.y),
      A::add(A::add(A::add(k1.z, A::mul(2.0f, k2.z)), A::mul(2.0f, k3.z)), k4.z),
  };
}

// One step of the oracle: new position and (not yet unit) velocity; FLAT,
// flat spacetime's, every acceleration zero. r is |rel|, the loop head's
// root: rk4's k1 takes its guarded radius from it, each later point takes
// its own root in its group, and leapfrog's two accelerations at the new
// position share that point.
template <int INTEG, bool FLAT>
__device__ __forceinline__ void step_exact(Vec3 rel, Vec3 vel, float r, const Phys& ph, float dt,
                                           Vec3& new_rel, Vec3& new_vel) {
  using A = Arith<false>;
  const float rs = ph.rs;
  const auto point = [&](Vec3 p, float rp) {
    if constexpr (FLAT) return AccelPoint{};
    else return accel_point(p, rp, ph);
  };
  const auto point_at = [&](Vec3 p, float guard) {
    if constexpr (FLAT) return AccelPoint{};
    else return accel_point_at(p, guard, ph);
  };
  const auto accel = [&](const AccelPoint& at, Vec3 v) {
    if constexpr (FLAT) return Vec3{0.0f, 0.0f, 0.0f};
    else return accel_exact(at, v, ph);
  };
  if constexpr (INTEG == kEuler) {
    const Vec3 a = accel(point(rel, r), vel);
    new_vel = axpy<false>(vel, a, dt);
    new_rel = axpy<false>(rel, new_vel, dt);
  } else if constexpr (INTEG == kRk4) {
    const float guard = radius_guard(rs);
    const float half = A::mul(0.5f, dt);
    const Vec3 k1p = vel;
    const Vec3 k1v = accel(point(rel, fmaxf(r, guard)), vel);
    const Vec3 p2 = axpy<false>(rel, k1p, half);
    const Vec3 k2p = axpy<false>(vel, k1v, half);
    const Vec3 k2v = accel(point_at(p2, guard), k2p);
    const Vec3 p3 = axpy<false>(rel, k2p, half);
    const Vec3 k3p = axpy<false>(vel, k2v, half);
    const Vec3 k3v = accel(point_at(p3, guard), k3p);
    const Vec3 p4 = axpy<false>(rel, k3p, dt);
    const Vec3 k4p = axpy<false>(vel, k3v, dt);
    const Vec3 k4v = accel(point_at(p4, guard), k4p);
    const float sixth = A::mul(dt, static_cast<float>(1.0 / 6.0));
    new_rel = axpy<false>(rel, rk4_sum(k1p, k2p, k3p, k4p), sixth);
    new_vel = axpy<false>(vel, rk4_sum(k1v, k2v, k3v, k4v), sixth);
  } else {
    const float half = A::mul(0.5f, dt);
    const Vec3 a1 = accel(point(rel, r), vel);
    const Vec3 v_half = axpy<false>(vel, a1, half);
    new_rel = axpy<false>(rel, v_half, dt);
    const AccelPoint at_new = point_at(new_rel, radius_guard(rs));
    const Vec3 a2a = accel(at_new, v_half);
    const Vec3 v_pred = axpy<false>(v_half, a2a, half);
    const Vec3 a2 = accel(at_new, v_pred);
    new_vel = axpy<false>(v_half, a2, half);
  }
}

// ---- fast tier --------------------------------------------------------------

// The fast tier's Lense-Thirring field at p (pallas_trace.py:486-496,
// :821-831): j inv_r^3 (3 jr p_i inv_r - J_hat_i), jr = p.y inv_r.
__device__ __forceinline__ Vec3 lt_field(Vec3 p, float inv_r, const Phys& ph) {
  const float mm = ph.rs * 0.5f;
  const float j = ph.spin * mm * mm;
  const float c = j * (inv_r * inv_r * inv_r);
  const float jr = p.y * inv_r;
  return {c * (3.0f * jr * p.x * inv_r), c * (3.0f * jr * p.y * inv_r - 1.0f),
          c * (3.0f * jr * p.z * inv_r)};
}

// pallas_trace.py sl_deriv: a = p * a2 - v * a1, one_m clamped at 0.02 for
// every model; kerr_lt adds v x B_g.
__device__ __forceinline__ Vec3 sl_deriv(Vec3 p, Vec3 v, const Phys& ph) {
  const float rs = ph.rs;
  const float rr2 = dot<true>(p, p);
  const float inv_rr = rsqrt_approx(rr2);
  const float rs_inv = rs * inv_rr;
  const float one_m = fmaxf(1.0f - rs_inv, static_cast<float>(0.02));
  const float factor = rs * rcp_approx(2.0f * rr2 * one_m);
  const float c = dot<true>(v, p);
  const float a1 = factor * one_m;
  const float a2 = factor * (1.0f + rs_inv) * c * (inv_rr * inv_rr);
  Vec3 a = {p.x * a2 - v.x * a1, p.y * a2 - v.y * a1, p.z * a2 - v.z * a1};
  if (ph.lt) {
    const Vec3 drag = cross<true>(v, lt_field(p, inv_rr, ph));
    a = {a.x + drag.x, a.y + drag.y, a.z + drag.z};
  }
  return a;
}

// One step of the fast tier: new position and unit velocity.
template <int INTEG>
__device__ __forceinline__ void step_fast(Vec3 rel, Vec3 vel, float r2, const Phys& ph, float dt,
                                          Vec3& new_rel, Vec3& new_vel) {
  const float rs = ph.rs;
  if constexpr (INTEG == kEuler) {
    // physics_substep: v' = v b1 + rel b2 (v' = v in flat spacetime). one_m
    // is clamped at 0.02 except for kerr_lt, whose capture radius lies
    // inside r_s (live rays reach one_m < 0); kerr_lt then adds the drag
    // of the pre-step velocity, scaled by dt.
    Vec3 nv = vel;
    if (!ph.flat) {
      const float inv_r = rsqrt_approx(r2);
      const float c = dot<true>(vel, rel);
      const float rs_inv_r = rs * inv_r;
      float one_m = 1.0f - rs_inv_r;
      if (!ph.lt) one_m = fmaxf(one_m, static_cast<float>(0.02));
      const float factor_dt = (rs * rcp_approx(2.0f * r2 * one_m)) * dt;
      const float b1 = 1.0f - factor_dt * one_m;
      const float b2 = factor_dt * (1.0f + rs_inv_r) * c * (inv_r * inv_r);
      nv = {vel.x * b1 + rel.x * b2, vel.y * b1 + rel.y * b2, vel.z * b1 + rel.z * b2};
      if (ph.lt) nv = axpy<true>(nv, cross<true>(vel, lt_field(rel, inv_r, ph)), dt);
    }
    new_rel = axpy<true>(rel, nv, dt);
    new_vel = vnorm<true>(nv);
  } else if (ph.flat) {
    // sl_rk4 / sl_leapfrog: a straight line, velocity untouched
    new_rel = axpy<true>(rel, vel, dt);
    new_vel = vel;
  } else if constexpr (INTEG == kRk4) {
    const float half = 0.5f * dt;
    const Vec3 k1v = sl_deriv(rel, vel, ph);
    const Vec3 p2 = axpy<true>(rel, vel, half);
    const Vec3 v2 = axpy<true>(vel, k1v, half);
    const Vec3 k2v = sl_deriv(p2, v2, ph);
    const Vec3 p3 = axpy<true>(rel, v2, half);
    const Vec3 v3 = axpy<true>(vel, k2v, half);
    const Vec3 k3v = sl_deriv(p3, v3, ph);
    const Vec3 p4 = axpy<true>(rel, v3, dt);
    const Vec3 v4 = axpy<true>(vel, k3v, dt);
    const Vec3 k4v = sl_deriv(p4, v4, ph);
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
    const Vec3 a1 = sl_deriv(rel, vel, ph);
    const Vec3 vh = axpy<true>(vel, a1, half);
    new_rel = axpy<true>(rel, vh, dt);
    const Vec3 a2a = sl_deriv(new_rel, vh, ph);
    const Vec3 vp = axpy<true>(vh, a2a, half);
    const Vec3 a2 = sl_deriv(new_rel, vp, ph);
    new_vel = vnorm<true>(axpy<true>(vh, a2, half));
  }
}

// ---- the accretion disk's crossing test ---------------------------------------

// Did the segment old -> nw cross y = 0 inside the annulus? On a hit, `hit`
// is the crossing point. Exact: models/disk.py intersect_equatorial (t =
// -oy / (ny - oy), the annulus on the sqrt'd radius of the interpolated
// point, whose y -- within rounding of 0 -- is kept for the Kerr-Schild
// direction). Fast: pallas_trace.py:1068-1075 (t by an approximate
// reciprocal, the annulus in r^2 of x and z, y = 0).
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
    hit = h;
    return hr >= r_isco && hr <= r_outer;
  }
}

// The rest of disk_crossing<false> on a segment that crosses y = 0, with t's
// quotient and the hit's root as one group behind one guard (common.cuh):
// the common paths of __fdiv_rn and __fsqrt_rn, and the rare group the guard
// turns away by the intrinsics, so every value has their bits.
__device__ __forceinline__ bool disk_hit_exact(Vec3 old, Vec3 nw, float r_isco, float r_outer,
                                               Vec3& hit) {
  using A = Arith<false>;
  const float oy = old.y;
  const float den = A::sub(nw.y, oy);
  const auto at = [&](float t) -> Vec3 {
    return {A::add(old.x, A::mul(t, A::sub(nw.x, old.x))),
            A::add(old.y, A::mul(t, A::sub(nw.y, old.y))),
            A::add(old.z, A::mul(t, A::sub(nw.z, old.z)))};
  };
  Vec3 h = at(div_by_rcp(-oy, den, rcp_rn_shared(den)));
  const float x = dot<false>(h, h);
  float hr = sqrt_rn_seq(x);
  if (quotient_group_outside(magnitude_window(oy) | magnitude_window(den) | magnitude_window(x),
                             den)) {
    h = at(__fdiv_rn(-oy, den));
    hr = __fsqrt_rn(dot<false>(h, h));
  }
  hit = h;
  return hr >= r_isco && hr <= r_outer;
}

// ---- the ray ------------------------------------------------------------------

// Primary ray of local pixel (row, col): full-image pixel (row * P_STRIDE +
// P_ROW0, col * P_STRIDE + P_COL0), in integers and then converted, against
// the full image's P_WF and P_HF (pallas_trace.py:742-765, strided :745-755;
// core/camera.py:generate_rays), normalised twice as generate_rays and
// trace_rays each normalise. Stride 1 at the origin is a whole frame; a
// stride d is the multires low pass; row0 / col0 place a band.
template <bool FAST>
__device__ __forceinline__ void generate_ray(const Params& p, int row, int col, Vec3& rel,
                                             Vec3& vel) {
  using A = Arith<FAST>;
  const int stride = static_cast<int>(p.v[P_STRIDE]);
  const float rows_f = static_cast<float>(row * stride + static_cast<int>(p.v[P_ROW0]));
  const float cols_f = static_cast<float>(col * stride + static_cast<int>(p.v[P_COL0]));
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
// steps. `flags` is a TraceFlags mask. FOLDED is the fast tier's loop;
// plugin physics has none (see the top of this file). Both termination
// tests share one branch a step; which of the two ended the ray is decided
// once, on the way out (a NaN radius passes both, as in the oracle).
template <bool FAST, int INTEG>
__device__ __forceinline__ Ray trace_ray_accel(const Params& p, int flags, int row, int col,
                                               int max_steps) {
  constexpr bool FOLDED = FAST && !kCustomAccel;
  using A = Arith<FOLDED>;
  Ray ray;
  generate_ray<FAST>(p, row, col, ray.rel, ray.vel);
  ray.status = kRunning;
  ray.steps = 0;
  const Phys ph = {p.v[P_RS], p.v[P_SPIN], (flags & kFlagFlat) != 0, (flags & kFlagLT) != 0};
  const bool adaptive = flags & kFlagAdaptive;
  const bool disk = flags & kFlagDisk;
  const float rs = p.v[P_RS];
  const float base_dt = p.v[P_DT];
  const float esc = p.v[P_ESC];
  const float cap = p.v[P_CAP];
  // the bounds of the tested radius: r^2 (fast) or r (exact)
  const float esc_t = FOLDED ? A::mul(esc, esc) : esc;
  const float cap_t = FOLDED ? A::mul(cap, cap) : cap;
  const float r_isco = p.v[P_RISCO];
  const float r_outer = p.v[P_ROUTER];
  for (int i = 0; i < max_steps; ++i) {
    ray.steps = i + 1;
    const float r2 = dot<FOLDED>(ray.rel, ray.rel);
    const float r = FOLDED ? 0.0f : A::sqrt(r2);  // the exact tier's sqrt'd radius
    const float rt = FOLDED ? r2 : r;
    if ((rt > esc_t) | (rt < cap_t)) {
      ray.status = rt > esc_t ? kEscaped : kCaptured;
      break;
    }
    float dt = base_dt;
    if (adaptive) {
      // geodesic.py:adaptive_dt; the fast tier's radius is r2 * rsqrt(r2)
      const float rc = FOLDED ? r2 * rsqrt_approx(r2) : r;
      dt = A::mul(base_dt, fminf(fmaxf(A::mul(A::sub(rc, rs), static_cast<float>(0.1)),
                                       static_cast<float>(0.01)), 1.0f));
    }
    Vec3 new_rel, new_vel;
    if constexpr (FOLDED) {
      step_fast<INTEG>(ray.rel, ray.vel, r2, ph, dt, new_rel, new_vel);
    } else {
      if (ph.flat) {
        step_exact<INTEG, true>(ray.rel, ray.vel, r, ph, dt, new_rel, new_vel);
      } else {
        step_exact<INTEG, false>(ray.rel, ray.vel, r, ph, dt, new_rel, new_vel);
      }
      new_vel = vnorm<FAST>(new_vel);
    }
    Vec3 hit;
    if (disk && disk_crossing<FOLDED>(ray.rel, new_rel, r_isco, r_outer, hit)) {
      ray.rel = {hit.x, 0.0f, hit.z};
      ray.vel = new_vel;
      ray.status = kOnDisk;
      break;
    }
    ray.rel = new_rel;
    ray.vel = new_vel;
  }
  return ray;
}

// ---- exact Kerr: Hamiltonian geodesics in Kerr-Schild form ---------------------
//
// State: q, the position relative to the black hole, and p, the covariant
// momentum with p_t = -1 (E = 1). M = rs / 2, a = a* M.
//
// Exact tier: every expression tree is the oracle's (models/kerr_schild.py),
// operation for operation: the flow is chaotic near the shadow's edge, so
// even a regrouping that is algebraically equal shows as per-pixel noise.
// It rounds each operation correctly, uncontracted: its roots and the
// reciprocals 1/w, 1/bb and 1/r give __fsqrt_rn's and __fdiv_rn's bits by
// their common paths behind one guard a point (ks_radii), and its escape
// test compares |q|^2 with escape_threshold(esc) instead of |q| with esc
// (common.cuh).
//
// Fast tier: the same flow in fewer instructions, and no bit-equality bar.
// Its roots come from the SFU's rsqrt (1/r = rsqrt(r^2), r = r^2 rsqrt(r^2),
// the discriminant's root disc2 rsqrt(disc2)), 1/w, 1/bb and 1/E from the SFU's
// rcp, as JAX's `_recip` does, and nvcc contracts. Its dp = (s^2 / 2) grad f
// + f s grad(l.p) never forms l's 3x3 Jacobian: with u = l.p at fixed p,
// grad u = u_r grad r + e (u_r = du/dr and e the partials at fixed r), and
// grad f = g1 grad r - g2 y e_y, so with grad r = (r / w) (r^2 x, bb y, r^2 z)
//   dp = K (r^2 x, bb y, r^2 z) + f s e - (s^2 / 2) g2 y e_y,
//   K = ((s^2 / 2) g1 + f s u_r) r / w
// (tests/test_torch_ks_fast_gradient.py holds this form against
// models/kerr_schild.derivs in float64).

struct KsConst {
  float rs;   // 2M
  float m;    // M
  float a;    // a* M
  float a2;   // a^2
};

template <bool FAST>
__device__ __forceinline__ float recip(float x) {
  if constexpr (FAST) {
    return rcp_approx(x);
  } else {
    return __fdiv_rn(1.0f, x);
  }
}

// The Kerr-Schild radius at q and what the geometry there divides by.
struct KsRadii {
  float r2;                    // models/kerr_schild.py ks_radius, squared and clamped
  float r;                     // its root
  float w, bb;                 // w = r^4 + a^2 y^2, bb = r^2 + a^2
  float inv_w, inv_bb, inv_r;  // 1/w, 1/bb, 1/r
};

// pallas_trace.py ks_r2 (:556) and the head of ks_all (:563-574) at q,
// with rho2 = |q|^2: two roots and three reciprocals. The exact tier takes
// each by its common path alone and tests all five operands once, after
// them (common.cuh: root_guard, rcp_guard); the rare point whose operands
// leave the window takes the whole group again by the intrinsics, in the
// same order, so every value is __fsqrt_rn's and __fdiv_rn's. The fast
// tier takes two rsqrts and two rcps of the SFU; disc2 = 0 only on the ring
// (y = 0, |q| = a), where the clamp keeps 0 * inf out of the root.
template <bool FAST>
__device__ __forceinline__ KsRadii ks_radii(Vec3 q, float rho2, float a2) {
  using A = Arith<FAST>;
  const float b = A::sub(rho2, a2);
  const float y2 = A::mul(q.y, q.y);
  const float disc2 = A::add(A::mul(b, b), A::mul(A::mul(4.0f, a2), y2));
  if constexpr (FAST) {
    KsRadii g;
    const float disc = disc2 * rsqrt_approx(fmaxf(disc2, static_cast<float>(1e-30)));
    g.r2 = maximum(0.5f * (b + disc), static_cast<float>(1e-12));
    g.inv_r = rsqrt_approx(g.r2);
    g.r = g.r2 * g.inv_r;
    g.w = g.r2 * g.r2 + a2 * y2;
    g.bb = g.r2 + a2;
    g.inv_w = rcp_approx(g.w);
    g.inv_bb = rcp_approx(g.bb);
    return g;
  } else {
    const auto radii = [&](auto root, auto rcp) {
      KsRadii g;
      g.r2 = maximum(A::mul(0.5f, A::add(b, root(disc2))), static_cast<float>(1e-12));
      g.r = root(g.r2);
      g.w = A::add(A::mul(g.r2, g.r2), A::mul(a2, y2));
      g.bb = A::add(g.r2, a2);
      g.inv_w = rcp(g.w);
      g.inv_bb = rcp(g.bb);
      g.inv_r = rcp(g.r);
      return g;
    };
    KsRadii g = radii([](float x) { return sqrt_rn_seq(x); },
                      [](float x) { return rcp_rn_shared(x); });
    if (turned_away(root_guard(disc2) | root_guard(g.r2) | rcp_guard(g.w) | rcp_guard(g.bb) |
                    rcp_guard(g.r))) {
      g = radii([](float x) { return __fsqrt_rn(x); }, [](float x) { return __fdiv_rn(1.0f, x); });
    }
    return g;
  }
}

// What models/kerr_schild.py derivs (pallas_trace.py ks_all :563-614)
// computes at q alone, in each tier's form: f, l and what dp needs.
template <bool FAST>
struct KsGeom;

// The exact tier: f, l and their gradients, as the oracle forms them.
template <>
struct KsGeom<false> {
  float f;           // the metric function f
  Vec3 l;            // the null vector l
  Vec3 df;           // df/dq
  Vec3 dl_x, dl_y, dl_z;  // dl/dx, dl/dy, dl/dz
};

// The fast tier: f, l and the gradient through r.
template <>
struct KsGeom<true> {
  float f;          // the metric function f
  Vec3 l;           // the null vector l
  float x, z;       // the point's x and z
  float r, a;       // the Kerr-Schild r, and a
  float inv_r, inv_bb;
  float g1, g2y;    // grad f = g1 grad r - g2y e_y
  float r_w;        // r / w
  Vec3 dr;          // (r^2 x, bb y, r^2 z) = grad r / (r / w)
};

template <bool FAST>
__device__ __forceinline__ KsGeom<FAST> ks_geom(Vec3 q, const KsRadii& g, const KsConst& k);

template <>
__device__ __forceinline__ KsGeom<false> ks_geom<false>(Vec3 q, const KsRadii& g,
                                                        const KsConst& k) {
  using A = Arith<false>;
  const float x = q.x, y = q.y, z = q.z;
  const float a = k.a, a2 = k.a2;
  const float r2 = g.r2, r = g.r, w = g.w, bb = g.bb;
  const float inv_w = g.inv_w, inv_bb = g.inv_bb, inv_r = g.inv_r;
  const float r3 = A::mul(r2, r);
  const float two_m = A::mul(2.0f, k.m);
  KsGeom<false> t;
  t.f = A::mul(A::mul(two_m, r3), inv_w);
  const float lx = A::mul(A::add(A::mul(r, x), A::mul(a, z)), inv_bb);
  const float ly = A::mul(y, inv_r);
  const float lz = A::mul(A::sub(A::mul(r, z), A::mul(a, x)), inv_bb);
  t.l = {lx, ly, lz};
  // dr/dq_i = r (r^2 q_i + a^2 y d_iy) / W
  const float r_w = A::mul(r, inv_w);
  const float drx = A::mul(A::mul(r_w, r2), x);
  const float dry = A::mul(A::mul(r_w, bb), y);
  const float drz = A::mul(A::mul(r_w, r2), z);
  // df/dq_i = 2M [(3 r^2 W - 4 r^6) dr_i - 2 a^2 y r^3 d_iy] / W^2
  const float inv_w2 = A::mul(inv_w, inv_w);
  const float g1 = A::mul(
      A::mul(two_m, A::sub(A::mul(A::mul(3.0f, r2), w), A::mul(A::mul(4.0f, r3), r3))), inv_w2);
  const float g2 = A::mul(A::mul(A::mul(A::mul(4.0f, k.m), a2), r3), inv_w2);
  t.df = {A::mul(g1, drx), A::sub(A::mul(g1, dry), A::mul(g2, y)), A::mul(g1, drz)};
  // dl_j/dq_i
  const float two_r_invbb = A::mul(A::mul(2.0f, r), inv_bb);
  const float inv_r2 = A::mul(inv_r, inv_r);
  const float dlx_x = A::sub(A::mul(A::add(A::mul(x, drx), r), inv_bb),
                             A::mul(lx, A::mul(two_r_invbb, drx)));
  const float dlx_y = A::sub(A::mul(A::mul(x, dry), inv_bb), A::mul(lx, A::mul(two_r_invbb, dry)));
  const float dlx_z = A::sub(A::mul(A::add(A::mul(x, drz), a), inv_bb),
                             A::mul(lx, A::mul(two_r_invbb, drz)));
  const float ny_r2 = A::mul(-y, inv_r2);
  const float dly_x = A::mul(ny_r2, drx);
  const float dly_y = A::sub(inv_r, A::mul(A::mul(y, inv_r2), dry));
  const float dly_z = A::mul(ny_r2, drz);
  const float dlz_x = A::sub(A::mul(A::sub(A::mul(z, drx), a), inv_bb),
                             A::mul(lz, A::mul(two_r_invbb, drx)));
  const float dlz_y = A::sub(A::mul(A::mul(z, dry), inv_bb), A::mul(lz, A::mul(two_r_invbb, dry)));
  const float dlz_z = A::sub(A::mul(A::add(A::mul(z, drz), r), inv_bb),
                             A::mul(lz, A::mul(two_r_invbb, drz)));
  t.dl_x = {dlx_x, dly_x, dlz_x};
  t.dl_y = {dlx_y, dly_y, dlz_y};
  t.dl_z = {dlx_z, dly_z, dlz_z};
  return t;
}

// f = 2M r^3 / w, l, and with w = r^4 + a^2 y^2 the derivative
// g1 = df/dr = 2M r^2 (3 a^2 y^2 - r^4) / w^2 and g2 y = 4M a^2 r^3 y / w^2.
template <>
__device__ __forceinline__ KsGeom<true> ks_geom<true>(Vec3 q, const KsRadii& g,
                                                      const KsConst& k) {
  const float x = q.x, y = q.y, z = q.z;
  const float a = k.a, r2 = g.r2, r = g.r, inv_w = g.inv_w, inv_bb = g.inv_bb;
  const float r3 = r2 * r;
  const float inv_w2 = inv_w * inv_w;
  KsGeom<true> t;
  t.f = (2.0f * k.m) * r3 * inv_w;
  t.l = {(r * x + a * z) * inv_bb, y * g.inv_r, (r * z - a * x) * inv_bb};
  t.x = x;
  t.z = z;
  t.r = r;
  t.a = a;
  t.inv_r = g.inv_r;
  t.inv_bb = inv_bb;
  t.g1 = (2.0f * k.m) * r2 * (3.0f * (k.a2 * (y * y)) - r2 * r2) * inv_w2;
  t.g2y = ((4.0f * k.m) * k.a2) * r3 * inv_w2 * y;
  t.r_w = r * inv_w;
  t.dr = {r2 * x, g.bb * y, r2 * z};
  return t;
}

// The geometry at a point of its own: its radii, then f, l and gradients.
template <bool FAST>
__device__ __forceinline__ KsGeom<FAST> ks_geom_at(Vec3 q, const KsConst& k) {
  return ks_geom<FAST>(q, ks_radii<FAST>(q, dot<FAST>(q, q), k.a2), k);
}

struct KsTerms {
  Vec3 dq, dp;  // dq/dl, dp/dl
};

// The rest of pallas_trace.py ks_all, on p: s = 1 + l.p, dq = p - f s l,
// dp = (s^2 / 2) df + f s (dl . p).
__device__ __forceinline__ KsTerms ks_terms(const KsGeom<false>& g, Vec3 p) {
  using A = Arith<false>;
  const float s =
      A::add(A::add(A::add(1.0f, A::mul(g.l.x, p.x)), A::mul(g.l.y, p.y)), A::mul(g.l.z, p.z));
  const float fs = A::mul(g.f, s);
  const float hs2 = A::mul(A::mul(0.5f, s), s);
  KsTerms t;
  t.dq = {A::sub(p.x, A::mul(fs, g.l.x)), A::sub(p.y, A::mul(fs, g.l.y)),
          A::sub(p.z, A::mul(fs, g.l.z))};
  t.dp = {A::add(A::mul(hs2, g.df.x), A::mul(fs, dot<false>(g.dl_x, p))),
          A::add(A::mul(hs2, g.df.y), A::mul(fs, dot<false>(g.dl_y, p))),
          A::add(A::mul(hs2, g.df.z), A::mul(fs, dot<false>(g.dl_z, p)))};
  return t;
}

// The fast tier's: dq as above, dp through r (see the top of this section).
// u = l.p = uxz + ly py with uxz = lx px + lz pz = (r P1 + a P2) / bb, P1 =
// x px + z pz, P2 = z px - x pz; so u_r = (P1 - 2 r uxz) / bb - ly py / r,
// and e = ((r px - a pz) / bb, py / r, (r pz + a px) / bb).
__device__ __forceinline__ KsTerms ks_terms(const KsGeom<true>& g, Vec3 p) {
  const float uxz = g.l.x * p.x + g.l.z * p.z;
  const float uy = g.l.y * p.y;
  const float s = 1.0f + uxz + uy;
  const float fs = g.f * s;
  const float hs2 = 0.5f * s * s;
  KsTerms t;
  t.dq = {p.x - fs * g.l.x, p.y - fs * g.l.y, p.z - fs * g.l.z};
  const float p1 = g.x * p.x + g.z * p.z;
  const float u_r = (p1 - 2.0f * g.r * uxz) * g.inv_bb - uy * g.inv_r;
  const float kk = (hs2 * g.g1 + fs * u_r) * g.r_w;
  const float fs_bb = fs * g.inv_bb;
  t.dp = {kk * g.dr.x + fs_bb * (g.r * p.x - g.a * p.z),
          kk * g.dr.y + fs * (p.y * g.inv_r) - hs2 * g.g2y,
          kk * g.dr.z + fs_bb * (g.r * p.z + g.a * p.x)};
  return t;
}

// One Kerr-Schild step (ops/trace.py:_trace_rays_kerr_schild step_*) from
// (q, p), with the geometry at q, gq, from the loop's head. Each derivs call
// of the oracle at a point already visited reuses that point's geometry,
// which it would compute bit for bit alike: Euler takes 1 geometry, rk4 4,
// leapfrog 3 for its 5 calls.
template <bool FAST, int INTEG>
__device__ __forceinline__ void ks_step(Vec3 q, Vec3 p, const KsGeom<FAST>& gq, float dt,
                                        const KsConst& k, Vec3& nq, Vec3& np) {
  using A = Arith<FAST>;
  if constexpr (INTEG == kEuler) {
    // semi-implicit (pallas_trace.py ks_substep :616-626): p' from dp(q, p),
    // then q' from dq(q, p')
    np = axpy<FAST>(p, ks_terms(gq, p).dp, dt);
    nq = axpy<FAST>(q, ks_terms(gq, np).dq, dt);
  } else if constexpr (INTEG == kRk4) {
    // classic RK4 on (q, p) (ks_rk4 :628-650), summed k1 + 2k2 + 2k3 + k4
    const float half = A::mul(0.5f, dt);
    const KsTerms k1 = ks_terms(gq, p);
    const Vec3 q2 = axpy<FAST>(q, k1.dq, half);
    const KsTerms k2 = ks_terms(ks_geom_at<FAST>(q2, k), axpy<FAST>(p, k1.dp, half));
    const Vec3 q3 = axpy<FAST>(q, k2.dq, half);
    const KsTerms k3 = ks_terms(ks_geom_at<FAST>(q3, k), axpy<FAST>(p, k2.dp, half));
    const Vec3 q4 = axpy<FAST>(q, k3.dq, dt);
    const KsTerms k4 = ks_terms(ks_geom_at<FAST>(q4, k), axpy<FAST>(p, k3.dp, dt));
    const float sixth = A::mul(dt, static_cast<float>(1.0 / 6.0));
    auto sum = [&](Vec3 a1, Vec3 a2, Vec3 a3, Vec3 a4) -> Vec3 {
      return {A::add(A::add(A::add(a1.x, A::mul(2.0f, a2.x)), A::mul(2.0f, a3.x)), a4.x),
              A::add(A::add(A::add(a1.y, A::mul(2.0f, a2.y)), A::mul(2.0f, a3.y)), a4.y),
              A::add(A::add(A::add(a1.z, A::mul(2.0f, a2.z)), A::mul(2.0f, a3.z)), a4.z)};
    };
    nq = axpy<FAST>(q, sum(k1.dq, k2.dq, k3.dq, k4.dq), sixth);
    np = axpy<FAST>(p, sum(k1.dp, k2.dp, k3.dp, k4.dp), sixth);
  } else {
    // kick-drift-kick with a midpoint-corrected drift and a corrector on the
    // final kick (ks_leapfrog :652-666)
    const float half = A::mul(0.5f, dt);
    const Vec3 ph = axpy<FAST>(p, ks_terms(gq, p).dp, half);
    const Vec3 q_mid = axpy<FAST>(q, ks_terms(gq, ph).dq, half);
    nq = axpy<FAST>(q, ks_terms(ks_geom_at<FAST>(q_mid, k), ph).dq, dt);
    const KsGeom<FAST> gn = ks_geom_at<FAST>(nq, k);
    const Vec3 p_pred = axpy<FAST>(ph, ks_terms(gn, ph).dp, half);
    np = axpy<FAST>(ph, ks_terms(gn, p_pred).dp, half);
  }
}

// Null momentum with E = 1 for a photon at q with unit coordinate
// direction d (models/kerr_schild.py init_momentum; ks_init_p :668-693).
template <bool FAST>
__device__ __forceinline__ Vec3 ks_init_p(Vec3 q, Vec3 d, const KsConst& k) {
  using A = Arith<FAST>;
  const float x = q.x, y = q.y, z = q.z;
  const float a = k.a, a2 = k.a2;
  const float rho2 = dot<FAST>(q, q);
  const float b = A::sub(rho2, a2);
  const float r2 = maximum(
      A::mul(0.5f, A::add(b, A::sqrt(A::add(A::mul(b, b), A::mul(A::mul(A::mul(4.0f, a2), y), y))))),
      static_cast<float>(1e-12));
  const float r = A::sqrt(r2);
  const float w = A::add(A::mul(r2, r2), A::mul(A::mul(a2, y), y));
  const float f = A::div(A::mul(A::mul(k.rs, r2), r), w);
  const float bb = A::add(r2, a2);
  const float lx = A::div(A::add(A::mul(r, x), A::mul(a, z)), bb);
  const float ly = A::div(y, r);
  const float lz = A::div(A::sub(A::mul(r, z), A::mul(a, x)), bb);
  const float c = dot<FAST>({lx, ly, lz}, d);
  const float disc =
      A::sqrt(maximum(A::sub(1.0f, A::mul(f, A::sub(1.0f, A::mul(c, c)))), static_cast<float>(1e-12)));
  const float ut = A::div(A::add(A::mul(f, c), disc),
                          maximum(A::sub(1.0f, f), static_cast<float>(1e-6)));
  const float fl = A::mul(f, A::add(ut, c));
  const float e_inv = recip<FAST>(maximum(A::sub(ut, fl), static_cast<float>(1e-12)));
  return {A::mul(A::add(d.x, A::mul(fl, lx)), e_inv), A::mul(A::add(d.y, A::mul(fl, ly)), e_inv),
          A::mul(A::add(d.z, A::mul(fl, lz)), e_inv)};
}

// The shading direction dq/dl, normalised (models/kerr_schild.py
// final_direction: dq / sqrt(max(|dq|^2, 1e-12)); fast, ks_direction
// :695-700: dq * rsqrt(|dq|^2)).
template <bool FAST>
__device__ __forceinline__ Vec3 ks_direction(Vec3 q, Vec3 p, const KsConst& k) {
  using A = Arith<FAST>;
  const Vec3 dq = ks_terms(ks_geom_at<FAST>(q, k), p).dq;
  if constexpr (FAST) {
    return vnorm<true>(dq);
  } else {
    const float n = A::sqrt(maximum(dot<false>(dq, dq), static_cast<float>(1e-12)));
    return {A::div(dq.x, n), A::div(dq.y, n), A::div(dq.z, n)};
  }
}

// The oracle's Kerr-Schild loop (ops/trace.py:_trace_rays_kerr_schild) for
// one ray: escape on |q| (exact: |q|^2 against escape_threshold, the same
// test) or |q|^2 (fast) against the escape radius, capture on the
// Kerr-Schild r (r^2) against P_CAP = 1.05 r_+, adaptive dt on the
// Kerr-Schild r (fast: r^2 rsqrt(r^2)), the disk as for the acceleration
// models. After the loop the momentum becomes the unit
// coordinate direction, evaluated at the disk hit point for a disk ray
// (exact: the oracle's interpolated point; fast: y = 0, pallas_trace.py
// :1134-1146); the returned rel of a disk ray has y = 0.
//
// DISK_APART (the exact tier): a step tests only whether the segment
// crosses y = 0, and a step that does takes the rest of the crossing in
// disk_hit_exact, its quotient and root one group. The same values; the
// step's path has no crossing result to carry and test, so it issues fewer
// instructions. trace_ray takes it for a kernel whose flags are fixed.
template <bool FAST, int INTEG, bool DISK_APART = false>
__device__ __forceinline__ Ray trace_ray_ks(const Params& p, int flags, int row, int col,
                                            int max_steps) {
  static_assert(!(FAST && DISK_APART), "the fast tier's crossing has one layout");
  using A = Arith<FAST>;
  Ray ray;
  Vec3 d;
  generate_ray<FAST>(p, row, col, ray.rel, d);
  ray.status = kRunning;
  ray.steps = 0;
  KsConst k;
  k.rs = p.v[P_RS];
  k.m = A::mul(k.rs, 0.5f);
  k.a = A::mul(p.v[P_SPIN], k.m);
  k.a2 = A::mul(k.a, k.a);
  const bool adaptive = flags & kFlagAdaptive;
  const bool disk = flags & kFlagDisk;
  const float base_dt = p.v[P_DT];
  const float esc = p.v[P_ESC];
  const float cap = p.v[P_CAP];
  // escape when |q|^2 > esc_bound: esc^2 (fast); exact, the T for which
  // that is __fsqrt_rn(|q|^2) > esc
  float esc_bound;
  if constexpr (FAST) {
    esc_bound = A::mul(esc, esc);
  } else {
    esc_bound = escape_threshold(esc);
  }
  const float cap2 = A::mul(cap, cap);
  const float r_isco = p.v[P_RISCO];
  const float r_outer = p.v[P_ROUTER];
  Vec3 mom = ks_init_p<FAST>(ray.rel, d, k);
  Vec3 dir_at = ray.rel;  // where the shading direction is evaluated
  for (int i = 0; i < max_steps; ++i) {
    ray.steps = i + 1;
    const float rho2 = dot<FAST>(ray.rel, ray.rel);
    if (rho2 > esc_bound) { ray.status = kEscaped; break; }
    const KsRadii g = ks_radii<FAST>(ray.rel, rho2, k.a2);
    if constexpr (FAST) {
      if (g.r2 < cap2) { ray.status = kCaptured; break; }
    } else {
      if (g.r < cap) { ray.status = kCaptured; break; }
    }
    float dt = base_dt;
    if (adaptive) {
      dt = A::mul(base_dt, fminf(fmaxf(A::mul(A::sub(g.r, k.rs), static_cast<float>(0.1)),
                                       static_cast<float>(0.01)), 1.0f));
    }
    Vec3 nq, np;
    ks_step<FAST, INTEG>(ray.rel, mom, ks_geom<FAST>(ray.rel, g, k), dt, k, nq, np);
    if constexpr (DISK_APART) {
      if (disk && A::mul(ray.rel.y, nq.y) < 0.0f) {  // the segment crosses y = 0
        Vec3 hit;
        if (disk_hit_exact(ray.rel, nq, r_isco, r_outer, hit)) {
          dir_at = hit;
          ray.rel = {hit.x, 0.0f, hit.z};
          mom = np;
          ray.status = kOnDisk;
          break;
        }
      }
    } else {
      Vec3 hit;
      if (disk && disk_crossing<FAST>(ray.rel, nq, r_isco, r_outer, hit)) {
        dir_at = hit;
        ray.rel = {hit.x, 0.0f, hit.z};
        mom = np;
        ray.status = kOnDisk;
        break;
      }
    }
    ray.rel = nq;
    mom = np;
  }
  ray.vel = ks_direction<FAST>(ray.status == kOnDisk ? dir_at : ray.rel, mom, k);
  return ray;
}

// One ray of either loop: the Kerr-Schild one (KS) or the acceleration one,
// traced with trace_flags<FLAGS>(flags), the kernel's FLAGS template
// argument. An exact Kerr-Schild kernel whose flags are fixed takes the
// crossing test apart (trace_ray_ks's DISK_APART).
template <bool FAST, int INTEG, bool KS, int FLAGS = kFlagsAtLaunch>
__device__ __forceinline__ Ray trace_ray(const Params& p, int flags, int row, int col,
                                         int max_steps) {
  if constexpr (KS) {
    constexpr bool apart = !FAST && FLAGS != kFlagsAtLaunch;
    return trace_ray_ks<FAST, INTEG, apart>(p, trace_flags<FLAGS>(flags), row, col, max_steps);
  } else {
    return trace_ray_accel<FAST, INTEG>(p, trace_flags<FLAGS>(flags), row, col, max_steps);
  }
}

}  // namespace bhr
