// sw device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/sw.py's Iteration action
// (one stage, Run), op for op in its order (d2q9_common.cuh's
// conventions): the Zou/He faces and bounce-back, the moments of f in the
// orthogonal basis, the shallow-water equilibrium moments (g h^2 in the
// energy rows) before and after the design field w damps the momentum,
// the relaxed non-equilibrium moments, f back from the moments; the
// TotalDiff and EnergyGain objectives on Obj1 nodes and the Material
// total.  Written against the template's node context (see
// d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: f[0..8] over the d2q9 velocity set, then the design
// field w (read, never written)
constexpr int N_STORAGE = 10;
constexpr int WP = 9;
__host__ __device__ constexpr int ex(int k) {
  return k < 9 ? d2q9::vx(k) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < 9 ? d2q9::vy(k) : 0;
}

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x1ffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_InletVelocity, S_InletPressure, S_InletDensity,
  S_Gravity, S_SolidH, S_EnergySink, S_Height, S_S2, S_S3, S_S5, S_S7,
  S_S8, S_S9, S_PressDiffInObj, S_TotalDiffInObj, S_MaterialInObj,
  S_EnergyGainInObj, N_SETTINGS
};
enum NodeType {
  T_Wall, T_WVelocity, T_WPressure, T_EPressure, T_EVelocity, T_Obj1,
  N_TYPES
};
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Height, N_ZONAL };
enum Global { GL_PressDiff, GL_TotalDiff, GL_Material, GL_EnergyGain,
              N_GLOBALS };

// rows 3..8 of the shallow-water equilibrium moments (models/sw.py:
// _eq_moments; rows 0..2 are dd, jx, jy themselves)
__device__ __forceinline__ void eq_moments(float dd, float jx, float jy,
                                           float g, float* req) {
  const float inv = 1.f / dd;
  const float usq = (jx * jx + jy * jy) * inv;
  req[3] = -4.f * dd + 3.f * usq + 3.f * dd * dd * g;
  req[4] = 4.f * dd - 3.f * usq - 4.5f * dd * dd * g;
  req[5] = -jx;
  req[6] = -jy;
  req[7] = (jx * jx - jy * jy) * inv;
  req[8] = jx * jy * inv;
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9];
  d2q9::pull<0>(c, f);
  const float w = c.pulled(WP);
  if (c.nt_is(T_Wall)) {
    d2q9::bounce(f);
  } else if (c.nt_is(T_EVelocity)) {
    d2q9::zou_he_x<false, true>(f, c.setting(S_InletVelocity));
  } else if (c.nt_is(T_WPressure)) {
    d2q9::zou_he_x<true, false>(f, c.setting(S_InletDensity));
  } else if (c.nt_is(T_WVelocity)) {
    d2q9::zou_he_x<true, true>(f, c.setting(S_InletVelocity));
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, c.setting(S_InletDensity));
  }
  const float g = c.setting(S_Gravity);
  float m[9];
#pragma unroll
  for (int r = 0; r < 9; ++r)
    m[r] = d2q9::combo([r](int k) { return (float)d2q9::basis(r, k); }, f);
  const float dd = m[0], jx = m[1], jy = m[2];
  float req[9];
  eq_moments(dd, jx, jy, g, req);
  const float rate[9] = {0.f, 0.f, 0.f, c.setting(S_S2), c.setting(S_S3),
                         c.setting(S_S5), c.setting(S_S7), c.setting(S_S8),
                         c.setting(S_S9)};
#pragma unroll
  for (int r = 3; r < 9; ++r) m[r] = (1.f - rate[r]) * (m[r] - req[r]);
  const bool obj = c.nt_is(T_Obj1);
  if (obj) c.add_global(GL_TotalDiff, jx * jx + jy * jy);
  const float pre = jx * jx + jy * jy;
  // momentum damping by the design field: energy extraction
  const float jx2 = jx * w, jy2 = jy * w;
  if (obj) c.add_global(GL_EnergyGain, pre - (jx2 * jx2 + jy2 * jy2));
  c.add_global(GL_Material, w);
  if (c.nt_in_group(G_COLLISION)) {
    eq_moments(dd, jx2, jy2, g, req);
    m[1] = jx2;
    m[2] = jy2;
#pragma unroll
    for (int r = 3; r < 9; ++r) m[r] = m[r] + req[r];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      f[k] = d2q9::combo([k](int r) {
        return (float)(d2q9::basis(r, k) / d2q9::norm(r));
      }, m);
  }
  d2q9::store<0>(c, f);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  static_assert(S == 0, "sw's Iteration is one stage");
  run(c);
}

}  // namespace model
