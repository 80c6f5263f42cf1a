// d2q9_pp_LBL device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_pp_lbl.py, op for op
// in its order (d2q9_common.cuh's conventions; e_k.u and e_k.F keep their
// zero terms, as the model writes them):
//
//   stage 0, Run      the boundary cases (bounce-back, the Zou/He faces at
//                     the zonal Velocity and Density, an equilibrium
//                     velocity inlet, the two symmetry rows); at a
//                     collision node BGK at tempomega with the
//                     Lycett-Brown & Luo forcing: the Shan-Chen force from
//                     the psi Field over the +-1 stencil, gravity, and the
//                     mechanical-stability coefficient gamma.
//   stage 1, calcPsi  psi = sqrt(2 (p0 - rho/3) / (G/3)) from the streamed
//                     density's Carnahan-Starling pressure, clamped at 0.
//
// The plan [(BaseIteration, 1), (calcPsi, 0)] runs in one launch (the ring
// form): stage 0 on a 32x32 tile, stage 1 on its inner 30x30 nodes.  The
// model declares three globals and sums none: the globals flavour returns
// zeros, as the plain version does.  Written against the template's node
// context (see d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: f[0..8] over the d2q9 velocity set, then the Field psi
constexpr int N_STORAGE = 10;
constexpr int PSI = 9;
__host__ __device__ constexpr int ex(int k) {
  return k < PSI ? d2q9::vx(k) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < PSI ? d2q9::vy(k) : 0;
}

// the Iteration action: stage 0 (Run) writes f, stage 1 (calcPsi) psi;
// stage_ext is generic_kernels.action_plan's ring of each stage
constexpr int N_STAGES = 2;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x1ffu : 0x200u;
}
__host__ __device__ constexpr int stage_ext(int s) { return s == 0 ? 1 : 0; }

enum Setting {
  S_G, S_T, S_alpha, S_R, S_beta, S_kappa, S_eps_0, S_betaforcing, S_omega,
  S_tempomega, S_nu, S_Velocity, S_VelocityY, S_Density, S_GravitationY,
  S_GravitationX, S_S0, S_S1, S_S2, S_S3, S_S4, S_S5, S_S6, S_S7, S_S8,
  S_PressureLossInObj, S_OutletFluxInObj, S_InletFluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_EVelocity, T_WPressure, T_WVelocity,
                T_EPressure, T_TopSymmetry, T_BottomSymmetry, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_VelocityY, Z_Density, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, N_GLOBALS };

constexpr float CS2 = (float)(1.0 / 3.0);

// the Shan-Chen force plus gravity (models/d2q9_pp_lbl.py:_force): psi at
// x + e_i weighted with w_i e_i, in plane order
template <class Ctx>
__device__ __forceinline__ void force(Ctx& c, float rho, float psi0,
                                      float& fx, float& fy) {
  bool fx0 = true, fy0 = true;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const float p = c.load(PSI, d2q9::vx(i), d2q9::vy(i));
    if (d2q9::vx(i)) {
      const float t = (float)(d2q9::wd(i) * d2q9::vx(i)) * p;
      fx = fx0 ? t : fx + t;
      fx0 = false;
    }
    if (d2q9::vy(i)) {
      const float t = (float)(d2q9::wd(i) * d2q9::vy(i)) * p;
      fy = fy0 ? t : fy + t;
      fy0 = false;
    }
  }
  const float gp = -c.setting(S_G) * psi0;
  fx = gp * fx + c.setting(S_GravitationX) * rho;
  fy = gp * fy + c.setting(S_GravitationY) * rho;
}

// stage 0, Run: the boundary cases, then BGK with the LBL forcing
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
  } else if (c.nt_is(T_EVelocity)) {
    d2q9::zou_he_x<false, true>(f, c.zonal(Z_Velocity));
  } else if (c.nt_is(T_WPressure)) {
    d2q9::zou_he_x<true, false>(f, c.zonal(Z_Density));
  } else if (c.nt_is(T_WVelocity)) {
    // an equilibrium inlet at the zonal Density and Velocity
    d2q9::equilibrium(c.zonal(Z_Density), c.zonal(Z_Velocity), 0.f, f);
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, c.zonal(Z_Density));
  } else if (c.nt_is(T_TopSymmetry) || c.nt_is(T_BottomSymmetry)) {
    // the populations moving into the row are the mirrors of those
    // leaving it
    const bool top = c.nt_is(T_TopSymmetry);
    constexpr int tmap[9] = {0, 1, 2, 3, 2, 5, 6, 6, 5};
    constexpr int bmap[9] = {0, 1, 4, 3, 4, 8, 7, 7, 8};
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = top ? f[tmap[k]] : f[bmap[k]];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
  }
  if (!c.nt_in_group(G_COLLISION)) {
    d2q9::store<0>(c, f);
    return;
  }
  const float rho = d2q9::sum9(f);
  const float ux = d2q9::jx(f) / rho;
  const float uy = d2q9::jy(f) / rho;
  const float psi0 = c.load(PSI, 0, 0);
  float fx, fy;
  force(c, rho, psi0, fx, fy);
  const float om = c.setting(S_tempomega);
  const float ps = fabsf(psi0) > 1e-30f ? psi0 : 1e-30f;
  const float gamma = 1.f - 0.25f * om
                      - rho * om / (4.f * c.setting(S_G) * CS2 * ps * ps);
  float feq[9];
  d2q9::equilibrium(rho, ux, uy, feq);
  const float ff = fx * fx + fy * fy;
  const float gr = gamma / (2.f * rho);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float ex = (float)d2q9::vx(k), ey = (float)d2q9::vy(k);
    const float eu = ex * ux + ey * uy;
    const float ef = ex * fx + ey * fy;
    const float s = (float)d2q9::wd(k)
                    * ((ex - ux + ex * eu * 3.f) * fx
                       + (ey - uy + ey * eu * 3.f) * fy
                       + gr * (ef * ef * 3.f - ff)) * 3.f;
    c.store(k, f[k] - om * (f[k] - feq[k]) + s);
  }
}

// stage 1, calcPsi: the pseudopotential from the streamed density
template <class Ctx>
__device__ __forceinline__ void calc_psi(Ctx& c) {
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  const float rho = d2q9::sum9(f);
  // models/d2q9_pp_lbl.py:_cs_pressure
  const float bp = rho * c.setting(S_beta) * 0.25f;
  const float om = 1.f - bp;
  const float p0 = rho * c.setting(S_R) * c.setting(S_T)
                   * (1.f + bp + bp * bp - bp * bp * bp) / (om * om * om)
                   - c.setting(S_alpha) * rho * rho;
  const float arg = 2.f * (p0 - rho * (1.f / 3.f))
                    / (c.setting(S_G) * (1.f / 3.f));
  c.store(PSI, sqrtf(arg > 0.f ? arg : 0.f));
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
  else calc_psi(c);
}

}  // namespace model
