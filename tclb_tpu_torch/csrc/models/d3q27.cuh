// d3q27 device physics for the generic 3D kernels (csrc/generic3d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q27.py: one stage (Run)
// that takes the 27 populations through the family's boundary cases and
// flux objectives and, on collision nodes, the cascaded central-moment MRT
// (csrc/models/d3q27_moments.cuh with correlated = false: the higher
// moments of the factorized Gaussian) with gravity as a velocity shift,
// written against the template's node context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.setting(i)         setting i (enum Setting, registry order)
//   c.zonal(j)           zonal setting j (enum Zonal) in the node's zone
//   c.nt_is(t)           the node's group field equals node type t
//   c.nt_in_group(g)     any bit of group g is set
//   c.add_global(g, v)   a node's contribution to SUM global g
//   c.store(k, v)        plane k of the stage's output
//
// The boundary cases repeat the PyTorch ops op for op
// (csrc/models/lattice3d.cuh); the collision is the z-slab kernels' own
// (csrc/d3q27.cu), whose order is ops/cumulant.py's but for its divisions
// by 3, so the kernel agrees with its plain version to a few ulps where
// generic3d.cu is built with --fmad=false.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file's enums and tables against that list and the model.

#pragma once

#include "d3q27_common.cuh"

namespace model {

// storage planes: f[0..26] in the tensor-product order
constexpr int N_STORAGE = 27;
__host__ __device__ constexpr int ex(int k) { return c27(0, k); }
__host__ __device__ constexpr int ey(int k) { return c27(1, k); }
__host__ __device__ constexpr int ez(int k) { return c27(2, k); }

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) {
  return 0x7ffffffu;
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_GravitationZ, S_omega_bulk, S_PressureLossInObj, S_OutletFluxInObj,
  S_InletFluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, T_NSymmetry, T_SSymmetry, T_Inlet, T_Outlet,
                N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, N_GLOBALS };

// models/family.py:add_flux_objectives on an Inlet or Outlet collision
// node
template <class Ctx>
__device__ __forceinline__ void flux_objectives(Ctx& c, const float* f,
                                                bool inlet, bool outlet) {
  float u[3];
  const float r = macroscopic(f, u);
  const float usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  const float flux = u[0] / r;
  const float ploss = u[0] / r * ((r - 1.f) * (1.f / 3.f) + usq / r * 0.5f);
  // constant indices keep the kernel's global sums in registers
  if (outlet) c.add_global(GL_OutletFlux, flux);
  else c.add_global(GL_InletFlux, flux);
  c.add_global(GL_PressureLoss, inlet ? ploss : -ploss);
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[Q], fb[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
  const int bc = (c.nt_is(T_Wall) || c.nt_is(T_Solid)) ? BC_BOUNCE
                 : c.nt_is(T_WVelocity) ? BC_WVELOCITY
                 : c.nt_is(T_WPressure) ? BC_WPRESSURE
                 : c.nt_is(T_EVelocity) ? BC_EVELOCITY
                 : c.nt_is(T_EPressure) ? BC_EPRESSURE
                 : (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry))
                     ? BC_MIRROR_Y : BC_NONE;
  boundary27(bc, f, [&] { return c.zonal(Z_Velocity); },
             [&] { return c.zonal(Z_Density); }, fb);
  const bool coll = c.nt_in_group(G_COLLISION);
  const bool inlet = c.nt_is(T_Inlet), outlet = c.nt_is(T_Outlet);
  if (coll && (inlet || outlet)) flux_objectives(c, fb, inlet, outlet);
  const float force[3] = {c.setting(S_GravitationX),
                          c.setting(S_GravitationY),
                          c.setting(S_GravitationZ)};
  float rho, ux, uy, uz;
  d3q27_moments::collide<false, false>(fb, c.setting(S_omega),
                                       c.setting(S_omega_bulk), force, 0.f,
                                       coll, rho, ux, uy, uz);
#pragma unroll
  for (int k = 0; k < Q; ++k) c.store(k, fb[k]);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

}  // namespace model
