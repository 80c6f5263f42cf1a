// The Iteration action (one stage, Run) of d2q9_heat and the two models
// built on it, for the generic 2D kernels (csrc/generic2d.cu): included by
// d2q9_heat.cuh, d2q9_heat_conjugate.cuh (TCLB_HEAT_CONJUGATE) and
// d2q9_hb.cuh (TCLB_HEAT_HB) after their layouts and enums.
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_heat.py:run and of
// the conjugate and hb runs on top of it, op for op in their order
// (d2q9_common.cuh's conventions).  Written against the template's node
// context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.setting(i)         setting i (enum Setting, registry order)
//   c.zonal(j)           zonal setting j at the node's zone (enum Zonal;
//                        the series flavours' per-step value where a
//                        series overrides that zone)
//   c.nt_is(t)           the node's group field equals node type t
//   c.nt_in_group(g)     any bit of group g is set
//   c.add_global(g, v)   a node's contribution to SUM global g
//   c.store(k, v)        plane k of the stage's output

#pragma once

#include "d2q9_common.cuh"

#ifndef TCLB_HEAT_CONJUGATE
#define TCLB_HEAT_CONJUGATE 0
#endif
#ifndef TCLB_HEAT_HB
#define TCLB_HEAT_HB 0
#endif

namespace model {

// the temperature equilibrium (models/d2q9_heat.py:_t_eq): w_0 T at
// rest, w_k T (1 + 3 e_k.u) else
__device__ __forceinline__ void t_equilibrium(float T, float ux, float uy,
                                              float* teq) {
  teq[0] = (float)d2q9::wd(0) * T;
#pragma unroll
  for (int k = 1; k < 9; ++k)
    teq[k] = (float)d2q9::wd(k) * T * (1.f + 3.f * d2q9::edot(k, ux, uy));
}

#if TCLB_HEAT_HB
// |non-equilibrium stress| of f (models/d2q9_hb.py:_neq_stress's ss)
__device__ __forceinline__ float stress_norm(const float* f) {
  const float rho = d2q9::sum9(f);
  const float ux = d2q9::jx(f) / rho;
  const float uy = d2q9::jy(f) / rho;
  float d[9];
  d2q9::equilibrium(rho, ux, uy, d);
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = f[k] - d[k];
  using d2q9::vx;
  using d2q9::vy;
  const float qxx = d2q9::combo([](int k) { return (float)(vx(k) * vx(k)); },
                                d);
  const float qxy = d2q9::combo([](int k) { return (float)(vx(k) * vy(k)); },
                                d);
  const float qyy = d2q9::combo([](int k) { return (float)(vy(k) * vy(k)); },
                                d);
  return sqrtf(qxx * qxx + 2.f * qxy * qxy + qyy * qyy);
}
#endif

// stage 0, Run: the boundary cases of f and T, the BGK collision of f, the
// temperature collision towards the Heater's pinned value or the local
// temperature, the OutFlux global; the conjugate build then collides T
// inside Solid nodes, the hb build erodes T on Destroy nodes
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], t[9];
  d2q9::pull<0>(c, f);
  d2q9::pull<T0>(c, t);
  const bool solid = c.nt_is(T_Solid);
  if (c.nt_is(T_Wall) || solid) {
    d2q9::bounce(f);
  } else if (c.nt_is(T_WVelocity)) {
    d2q9::zou_he_x<true, true>(f, c.setting(S_InletVelocity));
  } else if (c.nt_is(T_EVelocity)) {
    d2q9::zou_he_x<false, true>(f, c.setting(S_InletVelocity));
  } else if (c.nt_is(T_WPressure)) {
    d2q9::zou_he_x<true, false>(f, c.setting(S_InletDensity));
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, c.setting(S_InletDensity));
  }
  // temperature: adiabatic walls (the conjugate build conducts through
  // Solid), the inlet temperature at rest on WVelocity and EPressure
  if (c.nt_is(T_Wall) || (!TCLB_HEAT_CONJUGATE && solid)) {
    d2q9::bounce(t);
  } else if (c.nt_is(T_WVelocity) || c.nt_is(T_EPressure)) {
    const float tin = c.setting(S_InletTemperature);
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = (float)d2q9::wd(k) * tin;
  }
  const float rho = d2q9::sum9(f);
  const float ux = d2q9::jx(f) / rho;
  const float uy = d2q9::jy(f) / rho;
  const float temp = d2q9::sum9(t);
  if (c.nt_in_group(G_COLLISION)) {
    const float om = c.setting(S_omega);
    float eq[9];
    d2q9::equilibrium(rho, ux, uy, eq);
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = f[k] + om * (eq[k] - f[k]);
    const float target = c.nt_is(T_Heater) ? c.zonal(Z_HeaterTemperature)
                                           : temp;
    const float om_t = 1.f / (3.f * c.setting(S_FluidAlfa) + 0.5f);
    t_equilibrium(target, ux, uy, eq);
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = t[k] + om_t * (eq[k] - t[k]);
  }
  if (c.nt_is(T_Outlet)) c.add_global(GL_OutFlux, temp * ux);
#if TCLB_HEAT_CONJUGATE
  if (solid) {
    // models/d2q9_heat_conjugate.py: towards the local temperature at rest
    const float ts = d2q9::sum9(t);
    const float om_s = 1.f / (3.f * c.setting(S_SolidAlfa) + 0.5f);
    float eq[9];
    t_equilibrium(ts, 0.f, 0.f, eq);
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = t[k] + om_s * (eq[k] - t[k]);
  }
#endif
#if TCLB_HEAT_HB
  if (c.nt_is(T_Destroy)) {
    // models/d2q9_hb.py: erosion at DestructionRate * SS^DestructionPower
    const float rate = c.setting(S_DestructionRate)
                       * powf(fmaxf(stress_norm(f), 1e-30f),
                              c.setting(S_DestructionPower));
    const float scale = fmaxf(1.f - rate, 0.f);
    c.add_global(GL_DestroyedCellFlux, d2q9::sum9(t) * (1.f - scale));
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = t[k] * scale;
  }
#endif
  d2q9::store<0>(c, f);
  d2q9::store<T0>(c, t);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  static_assert(S == 0, "the heat models' Iteration is one stage");
  run(c);
}

}  // namespace model
