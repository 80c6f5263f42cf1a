// d3q27_cumulant_qibb_small device physics for the generic 3D kernels
// (csrc/generic3d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q27_cumulant_qibb.py:
// one stage (Run) around the cumulant collision with Galilean correction
// (csrc/models/d3q27_moments.cuh, correlated; the Buffer layer at the
// nubuffer rate): the family's boundary cases, then on a QIBB node each
// cut link (its distance q[i] >= 0) takes the node's own population f_i
// from before streaming in place of the one pulled in from the solid side
// (c.load at offset 0), and after the collision the Bouzidi blend
// ((1 - q) f_pre + q (f_i + f_opp)) / (1 + q) on the cut links.  Written
// against the template's node context `c`:
//
//   c.pulled(k)            plane k streamed to the node (from x - e_k)
//   c.load(k, dz, dy, dx)  plane k of the un-streamed storage at an offset
//   c.setting(i)           setting i (enum Setting, registry order)
//   c.zonal(j)             zonal setting j (enum Zonal) in the node's zone
//   c.nt_is(t)             the node's group field equals node type t
//   c.nt_in_group(g)       any bit of group g is set
//   c.add_global(g, v)     a node's contribution to SUM global g
//   c.store(k, v)          plane k of the stage's output
//
// A node holds 53 planes (f and the 26 cut distances, which do not stream
// and which the stage leaves: the template copies them), so the write set
// is 64 bits wide.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file's enums and tables against that list and the model.

#pragma once

#include "d3q27_common.cuh"

namespace model {

// storage planes: f[0..26] in the tensor-product order, then q[1..26], the
// cut distance of link i (-1: no cut), aligned with f[1..26]
constexpr int N_STORAGE = 53;
constexpr int QP = 27;         // q[1]
__host__ __device__ constexpr int ex(int k) { return k < Q ? c27(0, k) : 0; }
__host__ __device__ constexpr int ey(int k) { return k < Q ? c27(1, k) : 0; }
__host__ __device__ constexpr int ez(int k) { return k < Q ? c27(2, k) : 0; }

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned long long stage_writes(int) {
  return 0x7ffffffull;
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_GravitationZ, S_nubuffer, S_GalileanCorrection, S_omega_bulk, S_ForceX,
  S_ForceY, S_ForceZ, S_FluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, T_SVelocity, T_SPressure, T_NVelocity,
                T_NPressure, T_NSymmetry, T_SSymmetry, T_QIBB, T_Buffer,
                N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, N_ZONAL };
enum Global { GL_Flux, N_GLOBALS };

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
                 : c.nt_is(T_SVelocity) ? BC_SVELOCITY
                 : c.nt_is(T_SPressure) ? BC_SPRESSURE
                 : c.nt_is(T_NVelocity) ? BC_NVELOCITY
                 : c.nt_is(T_NPressure) ? BC_NPRESSURE
                 : (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry))
                     ? BC_MIRROR_Y : BC_NONE;
  boundary27(bc, f, [&] { return c.zonal(Z_Velocity); },
             [&] { return c.zonal(Z_Density); }, fb);
  // pre-collision: a cut link i takes the node's own f_i from before
  // streaming in place of f[opp(i)], pulled in from the solid side
  const bool qibb = c.nt_is(T_QIBB);
  float cut[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    cut[i] = qibb && i > 0 ? c.pulled(QP + i - 1) : -1.f;
    if (cut[i] >= 0.f) fb[opp(i)] = c.load(i, 0, 0, 0);
  }
  float fpre[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) fpre[k] = fb[k];
  const float om = c.nt_is(T_Buffer)
                       ? 1.f / (3.f * c.setting(S_nubuffer) + 0.5f)
                       : c.setting(S_omega);
  const float force[3] = {c.setting(S_ForceX) + c.setting(S_GravitationX),
                          c.setting(S_ForceY) + c.setting(S_GravitationY),
                          c.setting(S_ForceZ) + c.setting(S_GravitationZ)};
  const bool coll = c.nt_in_group(G_COLLISION);
  float rho, ux, uy, uz;
  d3q27_moments::collide<true, true>(fb, om, c.setting(S_omega_bulk), force,
                                     c.setting(S_GalileanCorrection), coll,
                                     rho, ux, uy, uz);
  if (coll) c.add_global(GL_Flux, ux);
  // post-collision: the interpolated bounce-back on the cut links
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float v = fb[k];
    if (cut[k] >= 0.f) {
      const float q = fmaxf(cut[k], 0.f);
      v = ((1.f - q) * fpre[k] + q * (fb[k] + fb[opp(k)])) / (1.f + q);
    }
    c.store(k, v);
  }
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

}  // namespace model
