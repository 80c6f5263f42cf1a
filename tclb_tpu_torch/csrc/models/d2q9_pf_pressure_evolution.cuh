// d2q9_pf_pressureEvolution device physics for the generic 2D kernels
// (csrc/generic2d.cu).
//
// The CUDA counterpart of
// tclb_tpu_torch/models/d2q9_pf_pressure_evolution.py's Iteration action,
// op for op in its order (d2q9_common.cuh's conventions; `c / x` of a
// plane is PyTorch's reciprocal times c):
//
//   stage 0, BaseIter   bounce-back of f and h on Wall and Solid; at an MRT
//                       node the pressure-evolution collision of f (the
//                       PhaseF stencil's gradient, laplacian and
//                       directional differences, read over +-2, give the
//                       interface and body-force corrections; the
//                       classical-matrix MRT relaxes the stress pair at the
//                       phase-interpolated rate) and the conservative
//                       Allen-Cahn collision of h; TotalDensity sums the
//                       interpolated density of the MRT nodes.
//   stage 1, calcPhase  PhaseF = the sum of the streamed h.
//
// The plan [(BaseIter, 2), (calcPhase, 0)] runs in one launch: stage 0 on
// the 28x12 output tile plus a ring of two, its 19 planes in shared
// memory.  Written against the template's node context (see
// d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: f[0..8] and h[0..8] over the d2q9 velocity set, then the
// Field PhaseF
constexpr int N_STORAGE = 19;
constexpr int F = 0, H = 9, PF = 18;
__host__ __device__ constexpr int ex(int k) {
  return k < PF ? d2q9::vx(k % 9) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < PF ? d2q9::vy(k % 9) : 0;
}

// the Iteration action: stage 0 (BaseIter) writes f and h, stage 1
// (calcPhase) PhaseF; stage_ext is generic_kernels.action_plan's ring
constexpr int N_STAGES = 2;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x3ffffu : 0x40000u;
}
__host__ __device__ constexpr int stage_ext(int s) { return s == 0 ? 2 : 0; }

enum Setting {
  S_Density_h, S_Density_l, S_PhaseField_h, S_PhaseField_l, S_PhaseField,
  S_W, S_M, S_sigma, S_omega_l, S_omega_h, S_nu_l, S_nu_h, S_S0, S_S1, S_S2,
  S_S3, S_S4, S_S5, S_S6, S_VelocityX, S_VelocityY, S_Pressure,
  S_GravitationX, S_GravitationY, S_BuoyancyX, S_BuoyancyY, S_GmatchedX,
  S_GmatchedY, S_PressureLossInObj, S_OutletFluxInObj, S_InletFluxInObj,
  S_TotalDensityInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_MRT, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_PhaseField, Z_VelocityX, Z_VelocityY, Z_Pressure, N_ZONAL };
enum Global {
  GL_PressureLoss, GL_OutletFlux, GL_InletFlux, GL_TotalDensity, N_GLOBALS
};

// the classical (integer Lallemand-Luo) moment rows rho, e, eps, jx, qx,
// jy, qy, pxx, pxy (models/d2q9_pf_pressure_evolution.py:M_CLASSIC) and
// their squared norms; the inverse is classic(r, k) / cnorm(r)
__host__ __device__ constexpr int classic(int r, int k) {
  constexpr int t[9][9] = {
      {1, 1, 1, 1, 1, 1, 1, 1, 1},
      {-4, -1, -1, -1, -1, 2, 2, 2, 2},
      {4, -2, -2, -2, -2, 1, 1, 1, 1},
      {0, 1, 0, -1, 0, 1, -1, -1, 1},
      {0, -2, 0, 2, 0, 1, -1, -1, 1},
      {0, 0, 1, 0, -1, 1, 1, -1, -1},
      {0, 0, -2, 0, 2, 1, 1, -1, -1},
      {0, 1, -1, 1, -1, 0, 0, 0, 0},
      {0, 0, 0, 0, 0, 1, -1, 1, -1}};
  return t[r][k];
}
__host__ __device__ constexpr double cnorm(int r) {
  constexpr double t[9] = {9, 36, 36, 6, 12, 6, 12, 4, 4};
  return t[r];
}

template <class Ctx>
__device__ __forceinline__ float phase(const Ctx& c, int dx, int dy) {
  return c.load(PF, dx, dy);
}

// the interpolated density (_rho_of)
template <class Ctx>
__device__ __forceinline__ float rho_of(const Ctx& c, float pf) {
  const float rl = c.setting(S_Density_l), rh = c.setting(S_Density_h);
  const float pl = c.setting(S_PhaseField_l);
  const float ph = c.setting(S_PhaseField_h);
  return rl + (rh - rl) * (pf - pl) / (ph - pl);
}

// the isotropic central gradient (_grad_phi)
template <class Ctx>
__device__ __forceinline__ void grad_phi(const Ctx& c, float& gx,
                                         float& gy) {
  const float d11 = phase(c, 1, 1) - phase(c, -1, -1);
  gx = (phase(c, 1, 0) - phase(c, -1, 0)) * (1.f / 3.f)
       + (d11 + phase(c, 1, -1) - phase(c, -1, 1)) * (1.f / 12.f);
  gy = (phase(c, 0, 1) - phase(c, 0, -1)) * (1.f / 3.f)
       + (d11 + phase(c, -1, 1) - phase(c, 1, -1)) * (1.f / 12.f);
}

// the chemical potential with the nine-point laplacian (_mu)
template <class Ctx>
__device__ __forceinline__ float mu_of(const Ctx& c, float pf) {
  const float pl = c.setting(S_PhaseField_l);
  const float ph = c.setting(S_PhaseField_h);
  const float pavg = 0.5f * (pl + ph);
  const float w = c.setting(S_W), sig = c.setting(S_sigma);
  const float lp =
      (phase(c, 1, 1) + phase(c, -1, 1) + phase(c, 1, -1) + phase(c, -1, -1)
       + 4.f * (phase(c, 1, 0) + phase(c, -1, 0) + phase(c, 0, 1)
                + phase(c, 0, -1))
       - 20.f * pf)
      * (1.f / 6.f);
  return 4.f * (12.f * sig / w) * (pf - pl) * (pf - ph) * (pf - pavg)
         - 1.5f * sig * w * lp;
}

// (rho - rho_h) Buoyancy + rho Gravitation + (1 - pf) rho_h Gmatched
template <class Ctx>
__device__ __forceinline__ void body_force(const Ctx& c, float rho,
                                           float pf, float& fbx,
                                           float& fby) {
  const float rh = c.setting(S_Density_h);
  fbx = (rho - rh) * c.setting(S_BuoyancyX)
        + rho * c.setting(S_GravitationX)
        + (1.f - pf) * rh * c.setting(S_GmatchedX);
  fby = (rho - rh) * c.setting(S_BuoyancyY)
        + rho * c.setting(S_GravitationY)
        + (1.f - pf) * rh * c.setting(S_GmatchedY);
}

// the h equilibrium Gamma_i pf + theta w_i e_i.n (_heq)
template <class Ctx>
__device__ __forceinline__ void heq(const Ctx& c, float pf,
                                    const float* gamma, float nx, float ny,
                                    float* out) {
  const float pavg =
      0.5f * (c.setting(S_PhaseField_l) + c.setting(S_PhaseField_h));
  const float theta = (3.f * c.setting(S_M))
                      * (1.f - 4.f * (pf - pavg) * (pf - pavg))
                      / c.setting(S_W);
  out[0] = gamma[0] * pf;
#pragma unroll
  for (int k = 1; k < 9; ++k)
    out[k] = gamma[k] * pf
             + theta * (float)d2q9::wd(k) * d2q9::edot(k, nx, ny);
}

// stage 0, BaseIter
template <class Ctx>
__device__ __forceinline__ void base_iter(Ctx& c) {
  float f[9], h[9];
  d2q9::pull<F>(c, f);
  d2q9::pull<H>(c, h);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
    d2q9::bounce(h);
  }
  if (!c.nt_is(T_MRT)) {
    d2q9::store<F>(c, f);
    d2q9::store<H>(c, h);
    return;
  }
  const float pf = phase(c, 0, 0);
  const float rho = rho_of(c, pf);
  c.add_global(GL_TotalDensity, rho);
  const float mu = mu_of(c, pf);
  float fbx, fby, gx, gy;
  body_force(c, rho, pf, fbx, fby);
  grad_phi(c, gx, gy);
  const float inv = (1.f / rho) * 3.f;
  const float ux = inv * (d2q9::jx(f) + (float)(0.5 / 3.0) * (mu * gx + fbx));
  const float uy = inv * (d2q9::jy(f) + (float)(0.5 / 3.0) * (mu * gy + fby));
  const float drho = c.setting(S_Density_h) - c.setting(S_Density_l);
  const float p = d2q9::sum9(f) + drho * (gx * ux + gy * uy) * (1.f / 6.f);

  // Gamma, the corrections and the relaxed non-equilibrium r
  float gamma[9], iface[9], body[9], r[9], m[9];
  d2q9::equilibrium(1.f, ux, uy, gamma);
  const float ugrad = ux * gx + uy * gy;
  const float prho = p - rho * (1.f / 3.f);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float rc =
        k == 0 ? 0.f
               : 0.5f * (phase(c, d2q9::vx(k), d2q9::vy(k))
                         - phase(c, -d2q9::vx(k), -d2q9::vy(k)));
    iface[k] = ((gamma[k] - (float)d2q9::wd(k)) * drho * (1.f / 3.f)
                + mu * gamma[k])
               * (rc - ugrad);
    body[k] = gamma[k] * (((float)d2q9::vx(k) - ux) * fbx
                          + ((float)d2q9::vy(k) - uy) * fby);
    const float geq = gamma[k] * rho * (1.f / 3.f)
                      + (float)d2q9::wd(k) * prho;
    r[k] = f[k] - (geq - 0.5f * iface[k] - 0.5f * body[k]);
  }
  const float pl = c.setting(S_PhaseField_l);
  const float ph = c.setting(S_PhaseField_h);
  const float oml = c.setting(S_omega_l);
  const float tau =
      1.f / (oml + (c.setting(S_omega_h) - oml) * (pf - pl) / (ph - pl));
  const float s_stress = 1.f / (tau + 0.5f);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float mq =
        d2q9::combo([q](int k) { return (float)classic(q, k); }, r);
    m[q] = mq * (q < 7 ? c.setting(S_S0 + q) : s_stress);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    r[k] = d2q9::combo(
        [k](int q) { return (float)(classic(q, k) / cnorm(q)); }, m);
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = f[k] - r[k] + iface[k] + body[k];
  d2q9::store<F>(c, f);

  // the phase-field collision
  const float gn = sqrtf(gx * gx + gy * gy);
  const float nx = gn > 0.f ? gx / gn : 0.f;
  const float ny = gn > 0.f ? gy / gn : 0.f;
  const float omega_ph = 1.f / (3.f * c.setting(S_M) + 0.5f);
  float he[9];
  heq(c, pf, gamma, nx, ny, he);
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = h[k] - omega_ph * (h[k] - he[k]);
  d2q9::store<H>(c, h);
}

// stage 1, calcPhase
template <class Ctx>
__device__ __forceinline__ void calc_phase(Ctx& c) {
  float h[9];
  d2q9::pull<H>(c, h);
  c.store(PF, d2q9::sum9(h));
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) base_iter(c);
  else calc_phase(c);
}

}  // namespace model
