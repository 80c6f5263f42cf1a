// d3q27_viscoplastic device physics for the generic 3D kernels
// (csrc/generic3d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q27_viscoplastic.py: one
// stage (Run) with the 27-velocity Zou/He faces on X and Y, the Y and Z
// mirrors and bounce-back, then on MRT nodes the Bingham stress-projection
// collision: the He forcing terms and the equilibria shifted by half of
// them, the deviatoric non-equilibrium momentum flux S, its contraction
// S:S against the yield stress (an unyielded node keeps its stress, a
// yielded one scales it by (6 nu - 1) / (6 nu + 1) + sqrt(2 / S:S) Y omega),
// the apparent viscosity and the yield state; the 18 slice monitors sum on
// their slices.  Written against the template's node context `c`:
//
//   c.pulled(k)            plane k streamed to the node (from x - e_k)
//   c.load(k, dz, dy, dx)  plane k of the un-streamed storage at an offset
//   c.setting(i)           setting i (enum Setting, registry order)
//   c.zonal(j)             zonal setting j (enum Zonal) in the node's zone
//   c.nt_is(t)             the node's group field equals node type t
//   c.add_global(g, v)     a node's contribution to SUM global g
//   c.store(k, v)          plane k of the stage's output
//
// The arithmetic repeats the PyTorch model op for op in the same order
// (a division by a constant as PyTorch's CUDA kernels do it: a multiply by
// its float reciprocal) and generic3d.cu is built with --fmad=false, so
// the kernels agree with the plain versions to a few ulps.  The globals
// flavour holds 20 double sums a thread (Flux and TotalRho, which the
// reference never adds to, stay zero).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file's enums and tables against that list and the model.

#pragma once

#include "d3q27_common.cuh"

namespace model {

// storage planes: f[0..26] in the tensor-product order, then nu_app and
// yield_stat, which do not stream
constexpr int N_STORAGE = 29;
constexpr int NU_APP = 27, YIELD_STAT = 28;
__host__ __device__ constexpr int ex(int k) { return k < Q ? c27(0, k) : 0; }
__host__ __device__ constexpr int ey(int k) { return k < Q ? c27(1, k) : 0; }
__host__ __device__ constexpr int ez(int k) { return k < Q ? c27(2, k) : 0; }

// the Iteration action: one stage (Run) that writes every plane
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) {
  return 0x1fffffffu;
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_Velocity, S_Pressure, S_ForceX, S_ForceY, S_ForceZ,
  S_YieldStress, S_FluxInObj, S_TotalRhoInObj, S_XYvxInObj, S_XYvyInObj,
  S_XYvzInObj, S_XYrho1InObj, S_XYrho2InObj, S_XYareaInObj, S_XZvxInObj,
  S_XZvyInObj, S_XZvzInObj, S_XZrho1InObj, S_XZrho2InObj, S_XZareaInObj,
  S_YZvxInObj, S_YZvyInObj, S_YZvzInObj, S_YZrho1InObj, S_YZrho2InObj,
  S_YZareaInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_SymmetryY, T_SymmetryZ,
                T_NVelocity_ZouHe, T_SVelocity_ZouHe, T_EVelocity_ZouHe,
                T_WVelocity_ZouHe, T_NPressure_ZouHe, T_SPressure_ZouHe,
                T_EPressure_ZouHe, T_WPressure_ZouHe, T_MRT, T_XYslice1,
                T_XZslice1, T_YZslice1, T_XYslice2, T_XZslice2, T_YZslice2,
                N_TYPES };
// the collision runs on MRT nodes (a node type): no group is read, the
// entry only keeps the argument layout's group array non-empty
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Pressure, N_ZONAL };
enum Global { GL_Flux, GL_TotalRho, GL_XYvx, GL_XYvy, GL_XYvz, GL_XYrho1,
              GL_XYrho2, GL_XYarea, GL_XZvx, GL_XZvy, GL_XZvz, GL_XZrho1,
              GL_XZrho2, GL_XZarea, GL_YZvx, GL_YZvy, GL_YZvz, GL_YZrho1,
              GL_YZrho2, GL_YZarea, N_GLOBALS };

// models/d3q27_viscoplastic.py:_zou_he_3d on face (AXIS, SIDE): SIDE +1
// where the fluid lies toward +AXIS; VELOCITY imposes the zonal Velocity
// `value` as the +AXIS velocity, else the density 1 + 3 Pressure
template <int AXIS, int SIDE, bool VELOCITY>
__device__ __forceinline__ void zou_he(const float* f, float value,
                                       float* out) {
  float s_t = 0.f, s_i = 0.f;
  bool first_t = true, first_i = true;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (c27(AXIS, k) == 0) {
      s_t = first_t ? f[k] : s_t + f[k];
      first_t = false;
    } else if (c27(AXIS, k) == -SIDE) {
      s_i = first_i ? f[k] : s_i + f[k];
      first_i = false;
    }
  }
  float jn;
  if (VELOCITY) {
    const float rho = (s_t + 2.f * s_i) / (1.f - (SIDE > 0 ? value : -value));
    jn = value * rho;
  } else {
    const float rho = 1.f + 3.f * value;
    const float x = s_t + 2.f * s_i - rho;
    jn = SIDE > 0 ? -x : x;
  }
  float jt[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AXIS) continue;
    float qt = 0.f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (c27(AXIS, k) != 0 || c27(t, k) == 0) continue;
      const float v = c27(t, k) > 0 ? f[k] : -f[k];
      qt = first ? v : qt + v;
      first = false;
    }
    jt[t] = -3.f * qt;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (c27(AXIS, k) != SIDE) {
      out[k] = f[k];
      continue;
    }
    float ej = c27(AXIS, k) > 0 ? jn : -jn;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (t != AXIS && c27(t, k) != 0)
        ej = ej + (c27(t, k) > 0 ? jt[t] : -jt[t]);
    out[k] = f[opp(k)] + (float)(6.0 * wd(k)) * ej;
  }
}

// the boundary cases (models/d3q27_viscoplastic.py:run)
template <class Ctx>
__device__ __forceinline__ void boundaries(Ctx& c, const float* f,
                                           float* fb) {
  if (c.nt_is(T_EPressure_ZouHe))
    zou_he<0, -1, false>(f, c.zonal(Z_Pressure), fb);
  else if (c.nt_is(T_WPressure_ZouHe))
    zou_he<0, 1, false>(f, c.zonal(Z_Pressure), fb);
  else if (c.nt_is(T_SPressure_ZouHe))
    zou_he<1, 1, false>(f, c.zonal(Z_Pressure), fb);
  else if (c.nt_is(T_NPressure_ZouHe))
    zou_he<1, -1, false>(f, c.zonal(Z_Pressure), fb);
  else if (c.nt_is(T_WVelocity_ZouHe))
    zou_he<0, 1, true>(f, c.zonal(Z_Velocity), fb);
  else if (c.nt_is(T_NVelocity_ZouHe))
    zou_he<1, -1, true>(f, c.zonal(Z_Velocity), fb);
  else if (c.nt_is(T_SVelocity_ZouHe))
    zou_he<1, 1, true>(f, c.zonal(Z_Velocity), fb);
  else if (c.nt_is(T_EVelocity_ZouHe))
    zou_he<0, -1, true>(f, c.zonal(Z_Velocity), fb);
  else if (c.nt_is(T_SymmetryY)) {
#pragma unroll
    for (int k = 0; k < Q; ++k) fb[k] = f[mirror_y(k)];
  } else if (c.nt_is(T_SymmetryZ)) {
#pragma unroll
    for (int k = 0; k < Q; ++k) fb[k] = f[mirror_z(k)];
  } else if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
#pragma unroll
    for (int k = 0; k < Q; ++k) fb[k] = f[opp(k)];
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) fb[k] = f[k];
  }
}

// the six independent entries of S in the order (xx, xy, xz, yy, yz, zz)
__host__ __device__ constexpr int s_axis(int s, int which) {
  constexpr int t[2][6] = {{0, 0, 0, 1, 1, 2}, {0, 1, 2, 1, 2, 2}};
  return t[which][s];
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[Q], fb[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
  boundaries(c, f, fb);
  const float fx = c.setting(S_ForceX), fy = c.setting(S_ForceY),
              fz = c.setting(S_ForceZ);
  const float rho = sum27(fb);
  const float u[3] = {lat3::moment<D3Q27>(0, fb) / rho + fx * 0.5f,
                      lat3::moment<D3Q27>(1, fb) / rho + fy * 0.5f,
                      lat3::moment<D3Q27>(2, fb) / rho + fz * 0.5f};
  // the slice monitors (reference Dynamics.c:540-578)
  if (c.nt_is(T_XYslice1)) {
    c.add_global(GL_XYvx, u[0]);
    c.add_global(GL_XYvy, u[1]);
    c.add_global(GL_XYvz, u[2]);
    c.add_global(GL_XYrho1, rho);
    c.add_global(GL_XYarea, 1.f);
  } else if (c.nt_is(T_XZslice1)) {
    c.add_global(GL_XZvx, u[0]);
    c.add_global(GL_XZvy, u[1]);
    c.add_global(GL_XZvz, u[2]);
    c.add_global(GL_XZrho1, rho);
    c.add_global(GL_XZarea, 1.f);
  } else if (c.nt_is(T_YZslice1)) {
    c.add_global(GL_YZvx, u[0]);
    c.add_global(GL_YZvy, u[1]);
    c.add_global(GL_YZvz, u[2]);
    c.add_global(GL_YZrho1, rho);
    c.add_global(GL_YZarea, 1.f);
  } else if (c.nt_is(T_XYslice2)) {
    c.add_global(GL_XYrho2, rho);
  } else if (c.nt_is(T_XZslice2)) {
    c.add_global(GL_XZrho2, rho);
  } else if (c.nt_is(T_YZslice2)) {
    c.add_global(GL_YZrho2, rho);
  }
  if (!c.nt_is(T_MRT)) {
#pragma unroll
    for (int k = 0; k < Q; ++k) c.store(k, fb[k]);
    c.store(NU_APP, c.load(NU_APP, 0, 0, 0));
    c.store(YIELD_STAT, c.load(YIELD_STAT, 0, 0, 0));
    return;
  }
  const float usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  float phi[Q], feq[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float ef = (float)c27(0, k) * fx + (float)c27(1, k) * fy
                     + (float)c27(2, k) * fz;
    const bool rest = c27(0, k) == 0 && c27(1, k) == 0 && c27(2, k) == 0;
    phi[k] = rest ? 0.f : (float)(3.0 * wd(k)) * rho * ef;
    const float eu = (float)c27(0, k) * u[0] + (float)c27(1, k) * u[1]
                     + (float)c27(2, k) * u[2];
    feq[k] = (float)wd(k) * rho
                 * (1.f + 3.f * eu * (1.f + 1.5f * eu) - 1.5f * usq)
             - 0.5f * phi[k];
  }
  // the non-equilibrium momentum flux, made deviatoric
  float S[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int a = s_axis(s, 0), b = s_axis(s, 1);
    float acc = 0.f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int cc = c27(a, k) * c27(b, k);
      if (cc == 0) continue;
      const float t = cc > 0 ? fb[k] - feq[k] : -(fb[k] - feq[k]);
      acc = first ? t : acc + t;
      first = false;
    }
    S[s] = acc;
  }
  const float tr3 = (S[0] + S[3] + S[5]) * (1.f / 3.f);
  S[0] = S[0] - tr3;
  S[3] = S[3] - tr3;
  S[5] = S[5] - tr3;
  const float scontr = S[0] * S[0] + 2.f * S[1] * S[1] + 2.f * S[2] * S[2]
                       + S[3] * S[3] + 2.f * S[4] * S[4] + S[5] * S[5];
  const float y = c.setting(S_YieldStress);
  const float nu = c.setting(S_nu);
  const float omega = 1.f / (3.f * nu + 0.5f);
  const bool unyielded = scontr < 2.f * y * y;
  // the `safe` guard: S:S = 0 takes sqrt(2 / 1) where no one reads it
  const float safe = scontr > 0.f ? scontr : 1.f;
  const float sq2s = sqrtf(1.f / safe * 2.f);
  const float c_bgk = (6.f * nu - 1.f) / (6.f * nu + 1.f);
  const float cy = y < 1e-15f ? c_bgk : c_bgk + sq2s * y * omega;
  const float scale = unyielded ? 1.f : cy;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float quad = 0.f;
    bool first = true;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const int a = s_axis(s, 0), b = s_axis(s, 1);
      const int cc = c27(a, k) * c27(b, k) * (a == b ? 1 : 2);
      if (cc == 0) continue;
      const float t = term((double)cc, S[s]);
      quad = first ? t : quad + t;
      first = false;
    }
    const float coef = first ? 0.f : (float)(4.5 * wd(k)) * quad * scale;
    c.store(k, coef + feq[k] + phi[k]);
  }
  c.store(NU_APP, unyielded ? 0.f : nu + y / sq2s);
  c.store(YIELD_STAT, unyielded ? 1.f : 0.f);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

}  // namespace model
