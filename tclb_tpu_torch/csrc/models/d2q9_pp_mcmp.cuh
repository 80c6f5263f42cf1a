// d2q9_pp_MCMP device physics for the generic 2D kernels
// (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_pp_mcmp.py's
// Iteration action, op for op in its order (d2q9_common.cuh's conventions):
//
//   stage 0, BaseIteration  the boundary case on both populations
//                           (bounce-back walls, per-component Zou/He
//                           faces), then at a collision node the two BGK
//                           collisions toward the common velocity, each
//                           shifted by its component's Shan-Chen force (the
//                           other component's pseudopotential read over
//                           +-1); TotalDensity1 and TotalDensity2 sum the
//                           collision nodes' densities.
//   stage 1, CalcPsi_f      psi_f = the streamed f's density (Gad2/Gc on a
//                           wall).
//   stage 2, CalcPsi_g      psi_g = the streamed g's density (Gad1/Gc on a
//                           wall).
//
// The plan [(BaseIteration, 2), (CalcPsi_f, 1), (CalcPsi_g, 0)] runs one
// pass a stage.  Written against the template's node context (see
// d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: f[0..8] and g[0..8] over the d2q9 velocity set, then the
// Fields psi_f and psi_g
constexpr int N_STORAGE = 20;
constexpr int F = 0, G = 9, PSI_F = 18, PSI_G = 19;
__host__ __device__ constexpr int ex(int k) {
  return k < PSI_F ? d2q9::vx(k % 9) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < PSI_F ? d2q9::vy(k % 9) : 0;
}

// the Iteration action: stage 0 writes f and g, stage 1 psi_f, stage 2
// psi_g; stage_ext is generic_kernels.action_plan's ring
constexpr int N_STAGES = 3;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x3ffffu : (s == 1 ? 1u << PSI_F : 1u << PSI_G);
}
__host__ __device__ constexpr int stage_ext(int s) {
  return s == 0 ? 2 : (s == 1 ? 1 : 0);
}

enum Setting {
  S_omega, S_omega_g, S_nu, S_nu_g, S_Velocity_f, S_Pressure_f,
  S_Velocity_g, S_Pressure_g, S_Density, S_Density_dry, S_Gc, S_Gad1,
  S_Gad2, S_R, S_T, S_a, S_b, S_Smag, S_SL_U, S_SL_lambda, S_SL_delta,
  S_SL_L, S_GravitationX, S_GravitationY, S_TotalDensity1InObj,
  S_TotalDensity2InObj, S_PressureLossInObj, S_OutletFluxInObj,
  S_InletFluxInObj, N_SETTINGS
};
enum NodeType {
  T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure, T_EVelocity,
  N_TYPES
};
enum Group { G_COLLISION, N_GROUPS };
enum Zonal {
  Z_Velocity_f, Z_Pressure_f, Z_Velocity_g, Z_Pressure_g, Z_Density,
  Z_Density_dry, N_ZONAL
};
enum Global {
  GL_TotalDensity1, GL_TotalDensity2, GL_PressureLoss, GL_OutletFlux,
  GL_InletFlux, N_GLOBALS
};

// both components' Zou/He on a face (rho = 3 P + 1 at a pressure face)
template <int side, bool velocity, class Ctx>
__device__ __forceinline__ void zou_he(const Ctx& c, float* f, float* g) {
  if (velocity) {
    d2q9::nebb_x<side, true>(f, c.zonal(Z_Velocity_f));
    d2q9::nebb_x<side, true>(g, c.zonal(Z_Velocity_g));
  } else {
    d2q9::nebb_x<side, false>(f, 3.f * c.zonal(Z_Pressure_f) + 1.f);
    d2q9::nebb_x<side, false>(g, 3.f * c.zonal(Z_Pressure_g) + 1.f);
  }
}

// the cross-component Shan-Chen force on `own` from `other`'s
// pseudopotential (_sc_force)
template <class Ctx>
__device__ __forceinline__ void sc_force(const Ctx& c, int own, int other,
                                         float& fx, float& fy) {
  const float psi0 = c.load(own, 0, 0);
  bool fx0 = true, fy0 = true;
  fx = fy = 0.f;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float o = c.load(other, d2q9::vx(k), d2q9::vy(k));
    if (d2q9::vx(k)) {
      const float t = (float)(d2q9::wd(k) * d2q9::vx(k)) * o;
      fx = fx0 ? t : fx + t;
      fx0 = false;
    }
    if (d2q9::vy(k)) {
      const float t = (float)(d2q9::wd(k) * d2q9::vy(k)) * o;
      fy = fy0 ? t : fy + t;
      fy0 = false;
    }
  }
  const float gc = c.setting(S_Gc);
  fx = -gc * psi0 * fx + c.setting(S_GravitationX);
  fy = -gc * psi0 * fy + c.setting(S_GravitationY);
}

// u_c shifted by force / (omega rho) where rho > 1e-4
__device__ __forceinline__ float shifted(float u, float force, float om,
                                         float rho) {
  return rho > 1e-4f ? u + force / (om * rho) : u;
}

// q <- q - om (q - feq(rho, ux, uy))
__device__ __forceinline__ void bgk(float* q, float om, float rho, float ux,
                                    float uy) {
  float feq[9];
  d2q9::equilibrium(rho, ux, uy, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = q[k] - om * (q[k] - feq[k]);
}

// stage 0, BaseIteration
template <class Ctx>
__device__ __forceinline__ void base_iteration(Ctx& c) {
  float f[9], g[9];
  d2q9::pull<F>(c, f);
  d2q9::pull<G>(c, g);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
    d2q9::bounce(g);
  } else if (c.nt_is(T_EVelocity)) {
    zou_he<-1, true>(c, f, g);
  } else if (c.nt_is(T_WPressure)) {
    zou_he<1, false>(c, f, g);
  } else if (c.nt_is(T_WVelocity)) {
    zou_he<1, true>(c, f, g);
  } else if (c.nt_is(T_EPressure)) {
    zou_he<-1, false>(c, f, g);
  }
  if (c.nt_in_group(G_COLLISION)) {
    const float rf = d2q9::sum9(f), rg = d2q9::sum9(g);
    const float om_f = c.setting(S_omega), om_g = c.setting(S_omega_g);
    // the viscosity-weighted common velocity (_common_u)
    float den = rf / om_f + rg / om_g;
    den = fabsf(den) > 1e-12f ? den : 1.f;
    const float ux = (d2q9::jx(f) / om_f + d2q9::jx(g) / om_g) / den;
    const float uy = (d2q9::jy(f) / om_f + d2q9::jy(g) / om_g) / den;
    float ffx, ffy, fgx, fgy;
    sc_force(c, PSI_F, PSI_G, ffx, ffy);
    sc_force(c, PSI_G, PSI_F, fgx, fgy);
    bgk(f, om_f, rf, shifted(ux, ffx, om_f, rf), shifted(uy, ffy, om_f, rf));
    bgk(g, om_g, rg, shifted(ux, fgx, om_g, rg), shifted(uy, fgy, om_g, rg));
    c.add_global(GL_TotalDensity1, rf);
    c.add_global(GL_TotalDensity2, rg);
  }
  d2q9::store<F>(c, f);
  d2q9::store<G>(c, g);
}

// stages 1 and 2, CalcPsi_f and CalcPsi_g: the streamed group `base`'s
// density, or on a wall the adhesion `gad` / Gc
template <int base, int plane, int gad, class Ctx>
__device__ __forceinline__ void calc_psi(Ctx& c) {
  float q[9];
  d2q9::pull<base>(c, q);
  const float rho = d2q9::sum9(q);
  c.store(plane, c.nt_is(T_Wall) ? c.setting(gad) / c.setting(S_Gc) : rho);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) base_iteration(c);
  else if constexpr (S == 1) calc_psi<F, PSI_F, S_Gad2>(c);
  else calc_psi<G, PSI_G, S_Gad1>(c);
}

}  // namespace model
