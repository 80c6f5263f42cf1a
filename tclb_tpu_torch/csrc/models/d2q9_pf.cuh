// d2q9_pf device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_pf.py, op for op in
// its order (d2q9_common.cuh's conventions): bounce-back of f and h on
// Wall and Solid, the Zou/He faces on f alone (a pressure face at rho = 1
// + 3 Pressure); at a collision node f relaxes every non-conserved moment
// at omega toward the equilibrium at u + g (exact-difference gravity), and
// h toward the phase field advected at u + g plus the sharpening flux
// along the normal from h's first central moments.  The model declares
// three globals and sums none: the globals flavour returns zeros, as the
// plain version does.  Written against the template's node context (see
// d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_pf_common.cuh"

namespace model {

// storage planes: f[0..8] and h[0..8] over the d2q9 velocity set
constexpr int N_STORAGE = 18;
constexpr int F = 0, H = 9;
__host__ __device__ constexpr int ex(int k) { return d2q9::vx(k % 9); }
__host__ __device__ constexpr int ey(int k) { return d2q9::vy(k % 9); }

// the Iteration action: one stage (Run) that writes f and h
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x3ffffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_Velocity, S_Pressure, S_W, S_M, S_PhaseField,
  S_GravitationX, S_GravitationY, S_PressureLossInObj, S_OutletFluxInObj,
  S_InletFluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_EVelocity, T_WPressure, T_WVelocity,
                T_EPressure, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Pressure, Z_PhaseField, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, N_GLOBALS };

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], h[9];
  d2q9::pull<F>(c, f);
  d2q9::pull<H>(c, h);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
    d2q9::bounce(h);
  } else if (c.nt_is(T_EVelocity)) {
    d2q9::zou_he_x<false, true>(f, c.zonal(Z_Velocity));
  } else if (c.nt_is(T_WPressure)) {
    d2q9::zou_he_x<true, false>(f, 1.f + 3.f * c.zonal(Z_Pressure));
  } else if (c.nt_is(T_WVelocity)) {
    d2q9::zou_he_x<true, true>(f, c.zonal(Z_Velocity));
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, 1.f + 3.f * c.zonal(Z_Pressure));
  }
  if (!c.nt_in_group(G_COLLISION)) {
    d2q9::store<F>(c, f);
    d2q9::store<H>(c, h);
    return;
  }
  // the flow: every non-conserved moment at omega, exact-difference gravity
  const float rho = d2q9::sum9(f);
  const float ux = d2q9::jx(f) / rho;
  const float uy = d2q9::jy(f) / rho;
  const float om1 = 1.f - c.setting(S_omega);
  const float u2x = ux + c.setting(S_GravitationX);
  const float u2y = uy + c.setting(S_GravitationY);
  float feq[9], feq2[9];
  d2q9::equilibrium(rho, ux, uy, feq);
  d2q9::equilibrium(rho, u2x, u2y, feq2);
#pragma unroll
  for (int k = 0; k < 9; ++k) c.store(F + k, feq2[k] + om1 * (f[k] - feq[k]));
  // the phase field at the post-collision velocity
  const float pf = d2q9::sum9(h);
  float nx, ny;
  d2q9pf::normal_of(d2q9::jx(h) - pf * u2x, d2q9::jy(h) - pf * u2y, nx, ny);
  const float m = c.setting(S_M);
  const float omega_ph = 1.f / (3.f * m + 0.5f);
  float heq[9];
  d2q9pf::heq(pf, nx, ny, u2x, u2y, d2q9pf::sharpening(pf, m, c.setting(S_W)),
              heq);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    c.store(H + k, h[k] - omega_ph * (h[k] - heq[k]));
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

}  // namespace model
