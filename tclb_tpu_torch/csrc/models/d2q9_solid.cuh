// d2q9_solid device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_solid.py's Iteration
// action (one stage, Run), op for op in its order (d2q9_common.cuh's
// conventions): bounce-back of the three lattices, the Zou/He faces of f
// with the equilibrium refills of g and h, the Dirichlet forcing of
// ForceTemperature and ForceConcentration nodes, the interface growth from
// the fi_s neighbourhood (a Field read through c.load on the un-streamed
// input: the template wraps it periodically, as the plain version's
// loader does), Cl_eq with the Gibbs-Thomson curvature (powf(safe, -1.5),
// PyTorch's pow) and the 4-fold anisotropy (cosf and sinf of 4 Theta0),
// the forcing accelerations and the three collisions.  Besides the list
// in d2q9_heat_physics.cuh, the node context gives
//
//   c.load(k, dx, dy)    plane k of the un-streamed storage at x + (dx, dy)
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: f[0..8], g[0..8], h[0..8] over the d2q9 velocity set,
// then Cs and the Field fi_s (not streamed)
constexpr int N_STORAGE = 29;
constexpr int G0 = 9, H0 = 18, CS = 27, FI = 28;
__host__ __device__ constexpr int ex(int k) {
  return k < 27 ? d2q9::vx(k % 9) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < 27 ? d2q9::vy(k % 9) : 0;
}

// the Iteration action: one stage (Run) that writes every plane
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) {
  return 0x1fffffffu;
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_FluidAlfa, S_SoluteDiffusion, S_C0, S_T0, S_Teq, S_Velocity,
  S_Pressure, S_Temperature, S_Concentration, S_Theta0, S_PartitionCoef,
  S_LiquidusSlope, S_GTCoef, S_SurfaceAnisotropy, S_SoluteCapillar,
  S_Buoyancy, S_OutFluxInObj, S_MaterialInObj, N_SETTINGS
};
enum NodeType {
  T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EVelocity, T_EPressure,
  T_ForceTemperature, T_ForceConcentration, T_Obj, N_TYPES
};
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Pressure, Z_Temperature, Z_Concentration,
             Z_Theta0, N_ZONAL };
enum Global { GL_OutFlux, GL_Material, N_GLOBALS };

// west-face refill of g or h (models/d2q9_solid.py:_refill_w): the e_x = +1
// populations w_i 6 (target - sum_{e_x <= 0} q)
__device__ __forceinline__ void refill_w(float* q, float target) {
  const float keep = q[0] + q[2] + q[3] + q[4] + q[6] + q[7];
  const float s = 6.f * (target - keep);
  q[1] = (float)d2q9::wd(1) * s;
  q[5] = (float)d2q9::wd(5) * s;
  q[8] = (float)d2q9::wd(8) * s;
}

// east-face outflow refill (models/d2q9_solid.py:_refill_e): the e_x = -1
// populations from the e_x = +1 ones
__device__ __forceinline__ void refill_e(float* q) {
  const float s = 6.f * (q[1] + q[5] + q[8]);
  q[3] = (float)d2q9::wd(3) * s;
  q[6] = (float)d2q9::wd(6) * s;
  q[7] = (float)d2q9::wd(7) * s;
}

// q <- keep (q - xeq(x, u)) + xeq(x2, u2), the three collisions
__device__ __forceinline__ void relax(float* q, float keep, float x,
                                      float ux, float uy, float x2,
                                      float ux2, float uy2) {
  float eq[9], eq2[9];
  d2q9::equilibrium(x, ux, uy, eq);
  d2q9::equilibrium(x2, ux2, uy2, eq2);
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = keep * (q[k] - eq[k]) + eq2[k];
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], g[9], h[9];
  d2q9::pull<0>(c, f);
  d2q9::pull<G0>(c, g);
  d2q9::pull<H0>(c, h);
  const float fi_s = c.pulled(FI);
  const float cs = c.pulled(CS);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
    d2q9::bounce(g);
    d2q9::bounce(h);
  } else if (c.nt_is(T_WVelocity) || c.nt_is(T_WPressure)) {
    if (c.nt_is(T_WVelocity))
      d2q9::zou_he_x<true, true>(f, c.zonal(Z_Velocity));
    else
      d2q9::zou_he_x<true, false>(
          f, 1.f + c.zonal(Z_Pressure) * (1.f / 3.f));
    refill_w(g, c.zonal(Z_Temperature));
    refill_w(h, c.zonal(Z_Concentration));
  } else if (c.nt_is(T_EVelocity)) {
    // the reference's EVelocity touches f only
    d2q9::zou_he_x<false, true>(f, c.zonal(Z_Velocity));
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, 1.f);
    refill_e(g);
    refill_e(h);
  }
  const float rho = d2q9::sum9(f);
  const float ux = d2q9::jx(f) / rho;
  const float uy = d2q9::jy(f) / rho;
  const float rhoT = d2q9::sum9(g);
  const float conc = d2q9::sum9(h);
  if (c.nt_is(T_Obj)) c.add_global(GL_Material, fi_s);
  float fi_out = fi_s, cs_out = cs;
  if (c.nt_in_group(G_COLLISION)) {
    // Dirichlet forcing (reference Q / dC)
    const float q_force = c.nt_is(T_ForceTemperature)
                              ? c.zonal(Z_Temperature) - rhoT : 0.f;
    float dc = c.nt_is(T_ForceConcentration)
                   ? c.zonal(Z_Concentration) - conc : 0.f;
    const float kf = 1.f - 1.f / (3.f * c.setting(S_nu) + 0.5f);
    const float kt = 1.f - 1.f / (3.f * c.setting(S_FluidAlfa) + 0.5f);
    const float kc0 = 1.f - 1.f / (3.f * c.setting(S_SoluteDiffusion)
                                   + 0.5f);
    const float kc = (-kc0 - 1.f) * fi_s + kc0;
    // the fi_s neighbourhood, dx outer and dy inner (NEIGHBOURS)
    float fi[3][3];
    bool all_liquid = true;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        fi[i][j] = c.load(FI, i - 1, j - 1);
        all_liquid = all_liquid && fi[i][j] < 1.f;
      }
    // central differences (_fi_derivs), fi[dx + 1][dy + 1]
    const float dx_ = 0.5f * (fi[2][1] - fi[0][1]);
    const float dy_ = 0.5f * (fi[1][2] - fi[1][0]);
    const float dxx = fi[2][1] - 2.f * fi[1][1] + fi[0][1];
    const float dyy = fi[1][2] - 2.f * fi[1][1] + fi[1][0];
    const float dxy = 0.25f * (fi[2][2] + fi[0][0] - fi[2][0] - fi[0][2]);
    // curvature and Cl_eq (_curvature, _cl_eq)
    const float d2 = dx_ * dx_ + dy_ * dy_;
    const bool grad = d2 > 0.f;
    const float safe = grad ? d2 : 1.f;
    const float kcurv = grad ? (2.f * dx_ * dy_ * dxy - dx_ * dx_ * dyy
                                - dy_ * dy_ * dxx) * powf(safe, -1.5f)
                             : 0.f;
    const float c2 = (dx_ * dx_ - dy_ * dy_) / safe;
    const float s2 = 2.f * dx_ * dy_ / safe;
    const float c4 = grad ? c2 * c2 - s2 * s2 : 1.f;
    const float s4 = grad ? 2.f * s2 * c2 : 0.f;
    const float th0 = 4.f * c.zonal(Z_Theta0);
    const float cos4 = c4 * cosf(th0) + s4 * sinf(th0);
    const float aniso = 1.f - 15.f * c.setting(S_SurfaceAnisotropy) * cos4;
    const float cl_eq = c.setting(S_C0)
        + ((rhoT / rho - c.setting(S_Teq))
           + c.setting(S_GTCoef) * kcurv * aniso)
          / c.setting(S_LiquidusSlope);
    // interface growth
    const float pk = c.setting(S_PartitionCoef);
    const bool grow = !all_liquid && cl_eq > conc;
    float dfi = 0.f;
    if (grow) {
      const float dfi_raw = (cl_eq - conc) / (cl_eq * (1.f - pk));
      dfi = fminf(dfi_raw, 1.f - fi_s);
    }
    const float fi_new = fi_s + dfi;
    if (grow) dc = conc * (1.f - pk) * dfi;
    fi_out = fi_new;
    cs_out = cs + conc * pk * dfi;
    // forcing accelerations
    const float ax = -2.f * ux * fi_new;
    const float ay = -2.f * uy * fi_new
                     + c.setting(S_Buoyancy) * (rhoT / rho - c.setting(S_T0));
    // the collisions: g and h ride the midpoint velocity u + a / 2
    relax(f, kf, rho, ux, uy, rho, ux + ax, uy + ay);
    const float uxm = ux + 0.5f * ax, uym = uy + 0.5f * ay;
    relax(g, kt, rhoT, uxm, uym, rhoT + q_force, uxm, uym);
    relax(h, kc, conc, uxm, uym, conc + dc, uxm, uym);
  }
  d2q9::store<0>(c, f);
  d2q9::store<G0>(c, g);
  d2q9::store<H0>(c, h);
  c.store(CS, cs_out);
  c.store(FI, fi_out);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  static_assert(S == 0, "d2q9_solid's Iteration is one stage");
  run(c);
}

}  // namespace model
