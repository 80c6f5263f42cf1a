// d2q9_pf_curvature device physics for the generic 2D kernels
// (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_pf_curvature.py, op
// for op in its order (d2q9_common.cuh's conventions):
//
//   stage 0, Run      the boundary cases (bounce-back of f and h, the
//                     Zou/He faces on f, a pressure face also pinning h to
//                     the zonal PhaseField's equilibrium, the y mirror of
//                     both on NSymmetry and SSymmetry); at a collision node
//                     the surface tension from the wall-repaired phi
//                     stencil (a link holding the -999 sentinel takes the
//                     opposite link's value, else the running mean of the
//                     valid links), the phase-interpolated gravity and
//                     relaxation rate, and the collisions of f and h.
//   stage 1, CalcPhi  phi = the sum of the streamed h (the symmetry rows
//                     count the mirrors of the populations leaving them),
//                     -999 on Wall nodes.
//
// The sentinel test is phi > -998: a bf16 stack narrows -999 to -1000
// and keeps phi's plane unshifted (a Field), so every rung classifies a
// link the same way.  The plan [(BaseIteration, 1), (CalcPhi, 0)] runs in
// one launch (the ring form): stage 0 on a 32x32 tile, its 19 planes in
// 77,824 B of shared memory, stage 1 on the inner 30x30 nodes.  The model
// declares three globals and sums none: the globals flavour returns zeros,
// as the plain version does.  Written against the template's node context
// (see d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_pf_common.cuh"

namespace model {

// storage planes: f[0..8] and h[0..8] over the d2q9 velocity set, then the
// Field phi
constexpr int N_STORAGE = 19;
constexpr int F = 0, H = 9, PHI = 18;
__host__ __device__ constexpr int ex(int k) {
  return k < PHI ? d2q9::vx(k % 9) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < PHI ? d2q9::vy(k % 9) : 0;
}

// the Iteration action: stage 0 (Run) writes f and h, stage 1 (CalcPhi)
// phi; stage_ext is generic_kernels.action_plan's ring of each stage
constexpr int N_STAGES = 2;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x3ffffu : 0x40000u;
}
__host__ __device__ constexpr int stage_ext(int s) { return s == 0 ? 1 : 0; }

enum Setting {
  S_omega, S_omega_l, S_nu, S_Velocity, S_Pressure, S_W, S_M, S_PhaseField,
  S_GravitationX, S_GravitationY, S_GravitationX_l, S_GravitationY_l,
  S_SurfaceTensionDecay, S_SurfaceTensionRate, S_WettingAngle,
  S_PressureLossInObj, S_OutletFluxInObj, S_InletFluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_EVelocity, T_WPressure, T_WVelocity,
                T_EPressure, T_NSymmetry, T_SSymmetry, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Pressure, Z_PhaseField, Z_WettingAngle,
             N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, N_GLOBALS };

// CalcPhi's wall value, and the test that finds it (phi > SENTINEL + 1)
constexpr float SENTINEL = -999.f;

// the y mirror (models/d2q9_pf_curvature.py:MIRY)
__host__ __device__ constexpr int mirror_y(int k) {
  constexpr int t[9] = {0, 1, 4, 3, 2, 8, 7, 6, 5};
  return t[k];
}

// The wall-repaired stencil of phi (models/d2q9_pf_curvature.py:
// repaired_stencil): phi at x + e_j, a sentinel link replaced by the
// opposite link's value if that is valid, else by the running mean of the
// valid links in link order
template <class Ctx>
__device__ __forceinline__ void repaired_stencil(const Ctx& c, float* r) {
  float phis[9];
  bool valid[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    phis[j] = c.load(PHI, d2q9::vx(j), d2q9::vy(j));
    valid[j] = phis[j] > SENTINEL + 1.f;
  }
  float temp = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j)
    temp = ((float)j * temp + (valid[j] ? phis[j] : temp))
           * (1.f / (float)(j + 1));
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int o = d2q9::opp(j);
    r[j] = valid[j] ? phis[j] : (valid[o] ? phis[o] : temp);
  }
}

// the surface tension and the phase-interpolated gravity
// (models/d2q9_pf_curvature.py:_force); pf is sum(h), n the unit gradient
// of the repaired stencil
template <class Ctx>
__device__ __forceinline__ void force(const Ctx& c, float pf, float& fx,
                                      float& fy, float& nx, float& ny) {
  float r[9];
  repaired_stencil(c, r);
  // _normal: the unit gradient sum_j r_j e_j
  const float gx = d2q9::jx(r), gy = d2q9::jy(r);
  const float ln = sqrtf(gx * gx + gy * gy);
  nx = ln > 0.f ? gx / ln : 0.f;
  ny = ln > 0.f ? gy / ln : 0.f;
  // _curvature
  const float w = c.setting(S_W);
  const float laplace = 3.f * (d2q9::sum9(r) * (1.f / 9.f) - r[0]);
  const float phi0 = c.load(PHI, 0, 0);
  const float lc = (4.f * phi0 * phi0 - 1.f) * w;
  const bool dead = fabsf(lc) < 1e-6f;
  const float curv =
      dead ? 0.f
           : (laplace - 2.f * phi0 * (16.f * phi0 * phi0 - 4.f) * w * w)
                 / lc;
  const float decay = expf(-c.setting(S_SurfaceTensionDecay) * pf * pf);
  const float rate = c.setting(S_SurfaceTensionRate);
  fx = rate * curv * nx * decay;
  fy = rate * curv * ny * decay;
  const float gxl = c.setting(S_GravitationX_l);
  const float gyl = c.setting(S_GravitationY_l);
  fx = fx + gxl - (pf - 0.5f) * (c.setting(S_GravitationX) - gxl);
  fy = fy + gyl - (pf - 0.5f) * (c.setting(S_GravitationY) - gyl);
}

// a pressure face's h: the zonal PhaseField at the face's Zou/He velocity
template <class Ctx>
__device__ __forceinline__ void pin_h(const Ctx& c, const float* f,
                                      float* h) {
  const float rho = d2q9::sum9(f);
  d2q9::equilibrium(c.zonal(Z_PhaseField), d2q9::jx(f) / rho,
                    d2q9::jy(f) / rho, h);
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], h[9];
  d2q9::pull<F>(c, f);
  d2q9::pull<H>(c, h);
  const float den = 1.f + 3.f * c.zonal(Z_Pressure);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
    d2q9::bounce(h);
  } else if (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry)) {
    float g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = f[mirror_y(k)];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = h[mirror_y(k)];
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = g[k];
  } else if (c.nt_is(T_EVelocity)) {
    d2q9::zou_he_x<false, true>(f, c.zonal(Z_Velocity));
  } else if (c.nt_is(T_WPressure)) {
    d2q9::zou_he_x<true, false>(f, den);
    pin_h(c, f, h);
  } else if (c.nt_is(T_WVelocity)) {
    d2q9::zou_he_x<true, true>(f, c.zonal(Z_Velocity));
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, den);
    pin_h(c, f, h);
  }
  if (!c.nt_in_group(G_COLLISION)) {
    d2q9::store<F>(c, f);
    d2q9::store<H>(c, h);
    return;
  }
  const float pf = d2q9::sum9(h);
  float fx, fy, nx, ny;
  force(c, pf, fx, fy, nx, ny);
  // the phase-interpolated relaxation rate
  const float oml = c.setting(S_omega_l);
  const float omega_eff = oml - (pf - 0.5f) * (c.setting(S_omega) - oml);
  const float rho = d2q9::sum9(f);
  const float jx = d2q9::jx(f), jy = d2q9::jy(f);
  float feq[9], feq2[9];
  d2q9::equilibrium(rho, jx / rho, jy / rho, feq);
  // the force enters the momentum directly (J += F)
  d2q9::equilibrium(rho, (jx + fx) / rho, (jy + fy) / rho, feq2);
  const float om1 = 1.f - omega_eff;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.store(F + k, feq2[k] + om1 * (f[k] - feq[k]));
  // h toward Heq at the momentum-like velocity J + 1.5 F
  const float m = c.setting(S_M);
  const float omega_ph = 1.f / (3.f * m + 0.5f);
  float heq[9];
  d2q9pf::heq(pf, nx, ny, jx + 1.5f * fx, jy + 1.5f * fy,
              d2q9pf::sharpening(pf, m, c.setting(S_W)), heq);
  const float keep = 1.f - omega_ph;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    c.store(H + k, keep * h[k] + omega_ph * heq[k]);
}

// stage 1, CalcPhi
template <class Ctx>
__device__ __forceinline__ void calc_phi(Ctx& c) {
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = c.pulled(H + k);
  float phi;
  if (c.nt_is(T_Wall)) {
    phi = SENTINEL;
  } else if (c.nt_is(T_SSymmetry) || c.nt_is(T_NSymmetry)) {
    const float tang = h[0] + h[1] + h[3];
    phi = c.nt_is(T_SSymmetry) ? tang + 2.f * (h[4] + h[7] + h[8])
                               : tang + 2.f * (h[2] + h[5] + h[6]);
  } else {
    phi = d2q9::sum9(h);
  }
  c.store(PHI, phi);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
  else calc_phi(c);
}

}  // namespace model
