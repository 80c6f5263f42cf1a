// d2q9_diff device physics for the generic 2D kernels (csrc/generic2d.cu,
// csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_diff.py: the forward
// stage<0> (Run) and its hand-written reverse stage_b<0>, which plays the
// role of the reference's Tapenade-generated Run_b.  Bounce-back on Wall
// and Solid; at a collision node the BGK relaxation of the concentration
// toward w_k c (1 + 3 e_k.u) at the prescribed (UX, UY), plus the source
// w_k Source w on DesignSpace nodes; TotalC sums c over the collision
// nodes, OutC over the Outlet nodes.  Written against the template's node
// contexts (see d2q9_heat_adj.cuh for both lists).
//
// The forward repeats the PyTorch model op for op in its order
// (d2q9_common.cuh's conventions; e_k.u keeps its zero terms, as the model
// writes it); the reverse is the exact derivative of that arithmetic in
// another order.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

// generic2d.cu builds generic2d_step_b for this model
#define TCLB_MODEL_ADJOINT 1

namespace model {

// storage planes: f[0..8] over the d2q9 velocity set, then w
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
  S_omega, S_Diffusivity, S_UX, S_UY, S_InitC, S_Source, S_TotalCInObj,
  S_OutCInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_Outlet, N_TYPES };
enum Group { G_COLLISION, G_DESIGNSPACE, N_GROUPS };
enum Zonal { Z_InitC, N_ZONAL };
enum Global { GL_TotalC, GL_OutC, N_GLOBALS };

using d2q9::opp;
using d2q9::sum9;
using d2q9::wd;

// e_k.u with both components written out (models/d2q9_diff.py:_eq)
__device__ __forceinline__ float eu_of(int k, float ux, float uy) {
  return (float)d2q9::vx(k) * ux + (float)d2q9::vy(k) * uy;
}

// The forward of one node up to the collision, shared by stage<0> and its
// reverse
struct Forward {
  float fb[9];             // after the bounce-back
  float w, c, src;
  bool wall, coll, design;

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& cx) {
    wall = cx.nt_is(T_Wall) || cx.nt_is(T_Solid);
    d2q9::pull<0>(cx, fb);
    if (wall) d2q9::bounce(fb);
    w = cx.pulled(WP);
    coll = cx.nt_in_group(G_COLLISION);
    design = cx.nt_in_group(G_DESIGNSPACE);
    c = sum9(fb);
    src = design ? cx.setting(S_Source) * w : 0.f;
  }
};

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& cx) {
  const Forward s(cx);
  if (s.coll) {
    const float ux = cx.setting(S_UX), uy = cx.setting(S_UY);
    const float om = cx.setting(S_omega);
    const float ux0 = ux * 0.f, uy0 = uy * 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float eq = (float)wd(k) * s.c * (1.f + 3.f * eu_of(k, ux, uy));
      const float fc = s.fb[k] + om * (eq - s.fb[k]);
      cx.store(k, fc + (float)wd(k) * s.src
                           * (1.f + 3.f * eu_of(k, ux0, uy0)));
    }
    cx.add_global(GL_TotalC, s.c);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) cx.store(k, s.fb[k]);
  }
  if (cx.nt_is(T_Outlet)) cx.add_global(GL_OutC, s.c);
}

// reverse of stage 0: the cotangents of the ten pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& cx) {
  const Forward s(cx);
  float afb[9];
  float ac = cx.nt_is(T_Outlet) ? cx.lam_global(GL_OutC) : 0.f;
  float aw = 0.f;
  if (s.coll) {
    const float ux = cx.setting(S_UX), uy = cx.setting(S_UY);
    const float om = cx.setting(S_omega);
    float aom = 0.f, aux = 0.f, auy = 0.f, asrc = 0.f;
    ac += cx.lam_global(GL_TotalC);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float l = cx.lam(k);
      const float eq = (float)wd(k) * s.c * (1.f + 3.f * eu_of(k, ux, uy));
      afb[k] = l * (1.f - om);
      aom += l * (eq - s.fb[k]);
      const float aeq = l * om;
      ac += aeq * (float)wd(k) * (1.f + 3.f * eu_of(k, ux, uy));
      const float aeu = aeq * (float)wd(k) * s.c * 3.f;
      aux += aeu * (float)d2q9::vx(k);
      auy += aeu * (float)d2q9::vy(k);
      // the source term's e_k.u is 0 u: no cotangent to UX, UY
      asrc += l * (float)wd(k);
    }
    cx.add_setting(S_omega, aom);
    cx.add_setting(S_UX, aux);
    cx.add_setting(S_UY, auy);
    if (s.design) {
      cx.add_setting(S_Source, asrc * s.w);
      aw = asrc * cx.setting(S_Source);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] = cx.lam(k);
  }
  // c = sum fb; fb the pulled populations, bounced on walls
#pragma unroll
  for (int k = 0; k < 9; ++k) afb[k] += ac;
  if (s.wall) d2q9::bounce(afb);
#pragma unroll
  for (int k = 0; k < 9; ++k) cx.set_q(k, afb[k]);
  cx.set_q(WP, aw);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage_b(Ctx& c) {
  if constexpr (S == 0) run_b(c);
}

}  // namespace model
