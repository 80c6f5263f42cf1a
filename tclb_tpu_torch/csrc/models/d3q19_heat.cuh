// d3q19_heat device physics for the generic 3D kernels (csrc/generic3d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q19_heat.py: one stage
// (Run) that takes the d3q19 flow through the family's boundary cases and
// d3q19's two-rate MRT (models/d3q19.py:relax) and the temperature, a d3q7
// lattice advected at the flow's velocity, through its bounce-back, the
// inlet equilibrium at InletTemperature on WVelocity and EPressure nodes
// and a BGK relaxation toward the Heater's temperature, written against
// the template's node context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.setting(i)         setting i (enum Setting, registry order)
//   c.zonal(j)           zonal setting j (enum Zonal) in the node's zone
//   c.nt_is(t)           the node's group field equals node type t
//   c.nt_in_group(g)     any bit of group g is set
//   c.add_global(g, v)   a node's contribution to SUM global g
//   c.store(k, v)        plane k of the stage's output
//
// The arithmetic repeats the PyTorch model op for op in the same order
// (csrc/models/d3q19_common.cuh, lattice3d.cuh) and generic3d.cu is built
// with --fmad=false, so the kernels agree with the plain versions to a few
// ulps.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file's enums and tables against that list and the model.

#pragma once

#include "d3q19_common.cuh"

namespace model {

// storage planes: f[0..18] over the d3q19 velocity set, then T[0..6] over
// d3q7 (rest, +x, -x, +y, -y, +z, -z)
constexpr int N_STORAGE = 26;
constexpr int TP = 19;         // T[0]
constexpr int QT = 7;
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1,
                                -1, -1, 0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 0,
                                0, 0, 1, 1, -1, -1, 0, 0, 0, 1, -1, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ez(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1,
                                1, -1, 1, -1, 1, -1, 0, 0, 0, 0, 0, 1, -1};
  return t[k];
}

// d3q7's weights and bounce-back pairs (lbm.weights, lbm.opposite)
__host__ __device__ constexpr double wt(int k) {
  constexpr double t[QT] = {0.25, 0.125, 0.125, 0.125, 0.125, 0.125, 0.125};
  return t[k];
}
__host__ __device__ constexpr int oppt(int k) {
  constexpr int t[QT] = {0, 2, 1, 4, 3, 6, 5};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f and T
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) {
  return 0x3ffffffu;
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_GravitationZ, S_S_high, S_InletTemperature, S_InitTemperature,
  S_FluidAlfa, S_HeaterTemperature, S_PressureLossInObj,
  S_OutletFluxInObj, S_InletFluxInObj, S_OutFluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, T_NSymmetry, T_SSymmetry, T_Heater, T_Outlet,
                N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, GL_OutFlux,
              N_GLOBALS };

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[Q], fb[Q], t[QT], tb[QT];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
#pragma unroll
  for (int k = 0; k < QT; ++k) t[k] = c.pulled(TP + k);
  const bool bounce = c.nt_is(T_Wall) || c.nt_is(T_Solid);
  const int bc = bounce ? BC_BOUNCE
                 : c.nt_is(T_WVelocity) ? BC_WVELOCITY
                 : c.nt_is(T_WPressure) ? BC_WPRESSURE
                 : c.nt_is(T_EVelocity) ? BC_EVELOCITY
                 : c.nt_is(T_EPressure) ? BC_EPRESSURE
                 : (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry))
                     ? BC_MIRROR_Y : BC_NONE;
  boundary19(bc, f, [&] { return c.zonal(Z_Velocity); },
             [&] { return c.zonal(Z_Density); }, fb);
  // the temperature's cases: bounce-back, the inlet equilibrium at rest
  if (bounce) {
#pragma unroll
    for (int k = 0; k < QT; ++k) tb[k] = t[oppt(k)];
  } else if (c.nt_is(T_WVelocity) || c.nt_is(T_EPressure)) {
    const float t_in = c.setting(S_InletTemperature);
#pragma unroll
    for (int k = 0; k < QT; ++k) tb[k] = (float)wt(k) * t_in;
  } else {
#pragma unroll
    for (int k = 0; k < QT; ++k) tb[k] = t[k];
  }
  // rho and u, the two-rate MRT at the velocity shifted by gravity
  const float rho = sum19(fb);
  float u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    u[d] = combo<Q>([d](int k) { return (double)c19(d, k); }, fb) / rho;
  const float temp = combo<QT>([](int) { return 1.0; }, tb);
  if (c.nt_in_group(G_COLLISION)) {
    float feq[Q], fneq[Q], back[Q];
    equilibrium(rho, u, feq);
#pragma unroll
    for (int k = 0; k < Q; ++k) fneq[k] = fb[k] - feq[k];
    stress_back(fneq, back);
    const float keep_high = 1.f - c.setting(S_S_high);
    const float d = (1.f - c.setting(S_omega)) - keep_high;
    const float v[3] = {u[0] + c.setting(S_GravitationX),
                        u[1] + c.setting(S_GravitationY),
                        u[2] + c.setting(S_GravitationZ)};
    float feq2[Q];
    equilibrium(rho, v, feq2);
#pragma unroll
    for (int k = 0; k < Q; ++k)
      c.store(k, keep_high * fneq[k] + d * back[k] + feq2[k]);
    // the temperature relaxes toward its equilibrium at the Heater's
    // temperature or its own
    const float target =
        c.nt_is(T_Heater) ? c.setting(S_HeaterTemperature) : temp;
    const float om_t = 1.f / (4.f * c.setting(S_FluidAlfa) + 0.5f);
#pragma unroll
    for (int k = 0; k < QT; ++k) {
      const float wtt = (float)wt(k) * target;
      float teq = wtt;
      if (k > 0) {
        const int a = (k - 1) / 2;
        const float eu = k % 2 ? u[a] : -u[a];
        teq = wtt * (1.f + 4.f * eu);
      }
      c.store(TP + k, tb[k] + om_t * (teq - tb[k]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) c.store(k, fb[k]);
#pragma unroll
    for (int k = 0; k < QT; ++k) c.store(TP + k, tb[k]);
  }
  if (c.nt_is(T_Outlet)) c.add_global(GL_OutFlux, temp * u[0]);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

}  // namespace model
