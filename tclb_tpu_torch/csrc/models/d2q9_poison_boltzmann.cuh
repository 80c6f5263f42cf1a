// d2q9_poison_boltzmann device physics for the generic 2D kernels
// (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_poison_boltzmann.py's
// Iteration action, op for op in its order (d2q9_common.cuh's
// conventions):
//
//   stage 0, BaseIteration  the zeta potential's equilibrium wp_i psi_bc on
//                           Wall and Solid, then at a collision node Guo's
//                           Poisson sweep with the nonlinear charge density
//                           -2 n_inf z el sinh(z el / (kb T) psi).
//   stage 1, CalcPsi        psi = the streamed g's potential.
//   stage 2, CalcSubiter    subiter + 1 (no streaming).
//
// The plan [(BaseIteration, 2), (CalcPsi, 1), (CalcSubiter, 0)] runs in
// one launch (generic2d.cu's staged form).  No globals.  Written against
// the template's node context (see d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: g[0..8] over the d2q9 velocity set, the density subiter
// (at rest) and the Field psi
constexpr int N_STORAGE = 11;
constexpr int G = 0, SUBITER = 9, PSI = 10;
__host__ __device__ constexpr int ex(int k) {
  return k < SUBITER ? d2q9::vx(k) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < SUBITER ? d2q9::vy(k) : 0;
}

// the Iteration action: stage 0 writes g, stage 1 psi, stage 2 subiter;
// stage_ext is generic_kernels.action_plan's ring
constexpr int N_STAGES = 3;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x1ffu : (s == 1 ? 1u << PSI : 1u << SUBITER);
}
__host__ __device__ constexpr int stage_ext(int s) {
  return s == 0 ? 2 : (s == 1 ? 1 : 0);
}
// the rows of input the plan reads beyond its output (action_plan's
// reach): the halo generic2d.cu's staged form stages
constexpr int REACH = 3;

enum Setting {
  S_tau_psi, S_n_inf, S_z, S_el, S_kb, S_T, S_epsilon, S_dt, S_psi_bc,
  S_psi0, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_psi_bc, Z_psi0, N_ZONAL };
enum Global { N_GLOBALS };

// Guo's Poisson weights (models/guo_poisson.py: WP, WPS)
__host__ __device__ constexpr double wp(int k) {
  return k == 0 ? 1.0 / 9.0 - 1.0 : 1.0 / 9.0;
}
constexpr double WPS = 1.0 / 8.0;     // the source weight of k > 0

// psi of the solver populations (guo_poisson.psi_of: / (1 - 1/9) as a
// multiply by 1.125)
__device__ __forceinline__ float psi_of(const float* g) {
  float s = g[1];
#pragma unroll
  for (int k = 2; k < 9; ++k) s = s + g[k];
  return s * 1.125f;
}

// stage 0, BaseIteration
template <class Ctx>
__device__ __forceinline__ void base_iteration(Ctx& c) {
  float g[9];
  d2q9::pull<G>(c, g);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    const float psi_bc = c.zonal(Z_psi_bc);
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = (float)wp(k) * psi_bc;
  }
  if (c.nt_in_group(G_COLLISION)) {
    const float psi = psi_of(g);
    const float z = c.setting(S_z), el = c.setting(S_el);
    const float rho_e = -2.f * c.setting(S_n_inf) * z * el
                        * sinhf(z * el / c.setting(S_kb) / c.setting(S_T)
                                * psi);
    const float tau = c.setting(S_tau_psi), dt = c.setting(S_dt);
    const float rd = (float)(-2.0 / 3.0) * (0.5f - tau) * dt * rho_e
                     / c.setting(S_epsilon);
    g[0] = g[0] - (g[0] - (float)wp(0) * psi) / tau;
#pragma unroll
    for (int k = 1; k < 9; ++k)
      g[k] = g[k] - (g[k] - (float)wp(k) * psi) / tau
             + (dt * (float)WPS) * rd;
  }
  d2q9::store<G>(c, g);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) {
    base_iteration(c);
  } else if constexpr (S == 1) {       // CalcPsi
    float g[9];
    d2q9::pull<G>(c, g);
    c.store(PSI, psi_of(g));
  } else {                             // CalcSubiter
    c.store(SUBITER, c.load(SUBITER, 0, 0) + 1.f);
  }
}

}  // namespace model
