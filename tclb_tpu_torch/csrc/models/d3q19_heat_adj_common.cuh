// d3q19_heat_adj device physics for the generic 3D kernels
// (csrc/generic3d.cu, csrc/generic3d_adjoint.cuh), shared by the three
// variants' headers (d3q19_heat_adj.cuh, d3q19_heat_adj_art.cuh,
// d3q19_heat_adj_prop.cuh), each of which defines HEAT_ADJ_VARIANT (0 the
// base, 1 _art, 2 _prop) before it includes this file.
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q19_heat_adj.py: the
// forward stage<0> (Run) and its hand-written reverse stage_b<0>.  Run
// takes the d3q19 flow through the family's boundary cases
// (d3q19_common.cuh) and a BGK collision whose post-collision equilibrium
// is at the velocity scaled by the design (w; 2 w - 1 for _art), and the
// d3q7 temperature of d3q19_heat.cuh through its bounce-back, the inlet
// equilibrium at InletTemperature on WVelocity nodes and a BGK relaxation
// at the rate of the w-interpolated diffusivity; _prop's effective design
// is w - PropagateX (1 - w1(x - 1)) on Propagate nodes, clipped to [0, 1]
// everywhere and written to w0 and w1.  The node contexts are those of
// csrc/models/d3q19_adj.cuh.
//
// The forward repeats the PyTorch model op for op in the same order and
// generic3d.cu is built with --fmad=false, so the forward kernels agree
// with the plain versions to a few ulps.  The reverse is the exact
// derivative of that arithmetic in another order, with the JAX package's
// conventions where PyTorch's differ: |u_x| in Drag has derivative +1 at
// u_x = 0 (and -0), and the clip's derivative is 0.5 at either bound, as
// jnp.clip's is.  Velocity, Density and Porocity are zonal, so no settings
// cotangent flows to them.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks each variant's enums and tables against that list and the model.

#pragma once

// generic3d.cu builds generic3d_step_b for this model
#define TCLB_MODEL_ADJOINT 1

#include "d3q19_common.cuh"

namespace model {

constexpr bool PROP = HEAT_ADJ_VARIANT == 2;

// storage planes: f[0..18] over d3q19, T[0..6] over d3q7 (rest, +x, -x,
// +y, -y, +z, -z), the design density w, which does not stream, and for
// _prop the streamed pair w0 (dx -1) and w1 (dx +1)
constexpr int TP = 19;         // T[0]
constexpr int QT = 7;
constexpr int WP = 26;         // w
constexpr int W0 = 27, W1 = 28;
constexpr int N_STORAGE = PROP ? 29 : 27;
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[29] = {0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1,
                         0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 0, -1, 1};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[29] = {0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 0, 0, 0,
                         1, 1, -1, -1, 0, 0, 0, 1, -1, 0, 0, 0, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ez(int k) {
  constexpr int t[29] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1,
                         1, -1, 1, -1, 0, 0, 0, 0, 0, 1, -1, 0, 0, 0};
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

// the Iteration action: one stage (Run) that writes f and T (and w0, w1)
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) {
  return PROP ? 0x1bffffffu : 0x3ffffffu;
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }

#if HEAT_ADJ_VARIANT == 2
enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_GravitationZ, S_InletTemperature, S_InitTemperature, S_FluidAlfa,
  S_SolidAlfa, S_Porocity, S_PropagateX, S_PressureLossInObj,
  S_OutletFluxInObj, S_InletFluxInObj, S_HeatFluxInObj, S_MaterialInObj,
  S_DragInObj, S_MaterialPenaltyInObj, N_SETTINGS
};
enum NodeType { T_Propagate, T_Wall, T_Solid, T_WVelocity, T_WPressure,
                T_EPressure, T_EVelocity, T_NSymmetry, T_SSymmetry,
                T_Outlet, N_TYPES };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, GL_HeatFlux,
              GL_Material, GL_Drag, GL_MaterialPenalty, N_GLOBALS };
#else
enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_GravitationZ, S_InletTemperature, S_InitTemperature, S_FluidAlfa,
  S_SolidAlfa, S_Porocity, S_PressureLossInObj, S_OutletFluxInObj,
  S_InletFluxInObj, S_HeatFluxInObj, S_MaterialInObj, S_DragInObj,
  N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, T_NSymmetry, T_SSymmetry, T_Outlet, N_TYPES };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, GL_HeatFlux,
              GL_Material, GL_Drag, N_GLOBALS };
#endif
enum Group { G_COLLISION, G_DESIGNSPACE, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, Z_Porocity, N_ZONAL };

// the momentum factor of the variant's design weight: w, or 2 w - 1 for
// _art, and its derivative
__device__ __forceinline__ float momentum_scale(float w) {
  return HEAT_ADJ_VARIANT == 1 ? 2.f * w - 1.f : w;
}
constexpr float SCALE_SLOPE = HEAT_ADJ_VARIANT == 1 ? 2.f : 1.f;

// The forward of one node up to its outputs, shared by stage<0> and its
// reverse: the boundary cases, the effective design, the macroscopic values
// and the scaled velocity
struct Forward {
  float fb[Q], tb[QT];     // after the boundary cases
  float w, x, weff;        // the design, _prop's unclipped weight, w_eff
  float rho, u[3], s, u2[3], temp;
  bool coll, design, outlet, prop;
  int bc;                  // which boundary case (BoundaryCase)
  bool bounce, inlet_t;    // the temperature's cases

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
    float f[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
    w = c.pulled(WP);
    coll = c.nt_in_group(G_COLLISION);
    design = c.nt_in_group(G_DESIGNSPACE);
    outlet = c.nt_is(T_Outlet);
    bounce = c.nt_is(T_Wall) || c.nt_is(T_Solid);
    inlet_t = c.nt_is(T_WVelocity);
    bc = bounce ? BC_BOUNCE
         : inlet_t ? BC_WVELOCITY
         : c.nt_is(T_WPressure) ? BC_WPRESSURE
         : c.nt_is(T_EVelocity) ? BC_EVELOCITY
         : c.nt_is(T_EPressure) ? BC_EPRESSURE
         : (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry)) ? BC_MIRROR_Y
         : BC_NONE;
    boundary19(bc, f, [&] { return c.zonal(Z_Velocity); },
               [&] { return c.zonal(Z_Density); }, fb);
    if (bounce) {
#pragma unroll
      for (int k = 0; k < QT; ++k) tb[k] = c.pulled(TP + oppt(k));
    } else if (inlet_t) {
      const float t_in = c.setting(S_InletTemperature);
#pragma unroll
      for (int k = 0; k < QT; ++k) tb[k] = (float)wt(k) * t_in;
    } else {
#pragma unroll
      for (int k = 0; k < QT; ++k) tb[k] = c.pulled(TP + k);
    }
    x = w;
    prop = false;
#if HEAT_ADJ_VARIANT == 2
    prop = c.nt_is(T_Propagate);
    if (prop) x = w - c.setting(S_PropagateX) * (1.f - c.pulled(W1));
    weff = fminf(fmaxf(x, 0.f), 1.f);
#else
    weff = w;
#endif
    rho = sum19(fb);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      u[d] = combo<Q>([d](int k) { return (double)c19(d, k); }, fb) / rho;
    s = momentum_scale(weff);
#pragma unroll
    for (int d = 0; d < 3; ++d) u2[d] = u[d] * s;
    temp = combo<QT>([](int) { return 1.0; }, tb);
  }
};

// the d3q7 equilibrium at the scaled velocity: w_k T (1 + 4 e_k.u2)
__device__ __forceinline__ float t_eq(int k, float temp, const float* u2) {
  const float wtt = (float)wt(k) * temp;
  if (k == 0) return wtt;
  const int a = (k - 1) / 2;
  return wtt * (1.f + 4.f * (k % 2 ? u2[a] : -u2[a]));
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  if (s.coll) {
    c.add_global(GL_Drag,
                 (1.f - s.weff) * (s.u[0] >= 0.f ? s.u[0] : -s.u[0]));
    const float om = c.setting(S_omega);
    float feq[Q], feq2[Q];
    equilibrium(s.rho, s.u, feq);
    equilibrium(s.rho, s.u2, feq2);
#pragma unroll
    for (int k = 0; k < Q; ++k)
      c.store(k, s.fb[k] + om * (feq[k] - s.fb[k]) + (feq2[k] - feq[k]));
    const float alfa = c.setting(S_FluidAlfa) * s.weff
                       + c.setting(S_SolidAlfa) * (1.f - s.weff);
    const float om_t = 1.f / (4.f * alfa + 0.5f);
#pragma unroll
    for (int k = 0; k < QT; ++k)
      c.store(TP + k,
              s.tb[k] + om_t * (t_eq(k, s.temp, s.u2) - s.tb[k]));
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) c.store(k, s.fb[k]);
#pragma unroll
    for (int k = 0; k < QT; ++k) c.store(TP + k, s.tb[k]);
  }
  if (s.outlet) c.add_global(GL_HeatFlux, s.temp * s.u2[0]);
  if (s.design) {
    c.add_global(GL_Material, 1.f - s.weff);
#if HEAT_ADJ_VARIANT == 2
    c.add_global(GL_MaterialPenalty, s.weff * (1.f - s.weff));
#endif
  }
  if constexpr (PROP) {
    c.store(W0, s.weff);
    c.store(W1, s.weff);
  }
}

// reverse of stage 0: the cotangents of the pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  float aweff = 0.f;
  if constexpr (PROP) aweff = c.lam(W0) + c.lam(W1);
  if (s.design) {
    aweff -= c.lam_global(GL_Material);
#if HEAT_ADJ_VARIANT == 2
    const float lp = c.lam_global(GL_MaterialPenalty);
    aweff += lp * (1.f - s.weff) - lp * s.weff;
#endif
  }
  float afb[Q], atb[QT];
  float arho = 0.f, au[3] = {0.f, 0.f, 0.f}, au2[3] = {0.f, 0.f, 0.f};
  float atemp = 0.f;
  if (s.outlet) {
    const float lh = c.lam_global(GL_HeatFlux);
    atemp += lh * s.u2[0];
    au2[0] += lh * s.temp;
  }
  if (s.coll) {
    // fc_k = fb_k + om (feq_k - fb_k) + (feq2_k - feq_k)
    const float om = c.setting(S_omega);
    float feq[Q], a[Q], afeq[Q];
    equilibrium(s.rho, s.u, feq);
    float aom = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      a[k] = c.lam(k);
      aom += a[k] * (feq[k] - s.fb[k]);
      afb[k] = a[k] - om * a[k];
      afeq[k] = om * a[k] - a[k];
    }
    c.add_setting(S_omega, aom);
    equilibrium_b(s.rho, s.u, afeq, arho, au);
    equilibrium_b(s.rho, s.u2, a, arho, au2);
    // Drag = (1 - w_eff) |u_x|, d|u_x| / du_x = +1 at 0 (JAX's)
    const float ld = c.lam_global(GL_Drag);
    const bool pos = s.u[0] >= 0.f;
    aweff -= ld * (pos ? s.u[0] : -s.u[0]);
    au[0] += pos ? ld * (1.f - s.weff) : -(ld * (1.f - s.weff));
    // tc_k = tb_k + om_t (teq_k - tb_k), om_t = 1 / (4 alfa + 1/2)
    const float fa = c.setting(S_FluidAlfa), sa = c.setting(S_SolidAlfa);
    const float alfa = fa * s.weff + sa * (1.f - s.weff);
    const float om_t = 1.f / (4.f * alfa + 0.5f);
    float aom_t = 0.f;
#pragma unroll
    for (int k = 0; k < QT; ++k) {
      const float at = c.lam(TP + k);
      const float teq = t_eq(k, s.temp, s.u2);
      aom_t += at * (teq - s.tb[k]);
      atb[k] = at - om_t * at;
      const float ateq = om_t * at;
      const float wk = (float)wt(k);
      if (k == 0) {
        atemp += ateq * wk;
      } else {
        const int d = (k - 1) / 2;
        const float eu = k % 2 ? s.u2[d] : -s.u2[d];
        atemp += ateq * wk * (1.f + 4.f * eu);
        const float aeu = ateq * wk * s.temp * 4.f;
        au2[d] += k % 2 ? aeu : -aeu;
      }
    }
    const float aalfa = -aom_t * om_t * om_t * 4.f;
    aweff += aalfa * (fa - sa);
    c.add_setting(S_FluidAlfa, aalfa * s.weff);
    c.add_setting(S_SolidAlfa, aalfa * (1.f - s.weff));
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) afb[k] = c.lam(k);
#pragma unroll
    for (int k = 0; k < QT; ++k) atb[k] = c.lam(TP + k);
  }
  // u2 = u s(w_eff)
  float as = 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    au[d] += au2[d] * s.s;
    as += au2[d] * s.u[d];
  }
  aweff += as * SCALE_SLOPE;
  // temp = sum tb
#pragma unroll
  for (int k = 0; k < QT; ++k) atb[k] += atemp;
  // u = j / rho, rho = sum fb
  float aj[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) aj[d] = au[d] / s.rho;
  arho -= (au[0] * s.u[0] + au[1] * s.u[1] + au[2] * s.u[2]) / s.rho;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float t = arho;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (c19(d, k)) t += c19(d, k) > 0 ? aj[d] : -aj[d];
    afb[k] += t;
  }
  // the flow's boundary cases
  float q[Q];
  switch (s.bc) {
    case BC_BOUNCE:
#pragma unroll
      for (int k = 0; k < Q; ++k) q[k] = afb[opp(k)];
      break;
    case BC_WVELOCITY: nebb_b<0, 1, true>(c.zonal(Z_Velocity), afb, q); break;
    case BC_WPRESSURE: nebb_b<0, 1, false>(c.zonal(Z_Density), afb, q); break;
    case BC_EVELOCITY: nebb_b<0, -1, true>(c.zonal(Z_Velocity), afb, q); break;
    case BC_EPRESSURE: nebb_b<0, -1, false>(c.zonal(Z_Density), afb, q); break;
    case BC_MIRROR_Y:
#pragma unroll
      for (int k = 0; k < Q; ++k) q[k] = afb[mirror_y(k)];
      break;
    default:
#pragma unroll
      for (int k = 0; k < Q; ++k) q[k] = afb[k];
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) c.set_q(k, q[k]);
  // the temperature's cases: the inlet's equilibrium reads no pulled T
  if (s.bounce) {
#pragma unroll
    for (int k = 0; k < QT; ++k) c.set_q(TP + k, atb[oppt(k)]);
  } else if (s.inlet_t) {
    float at_in = 0.f;
#pragma unroll
    for (int k = 0; k < QT; ++k) {
      at_in += atb[k] * (float)wt(k);
      c.set_q(TP + k, 0.f);
    }
    c.add_setting(S_InletTemperature, at_in);
  } else {
#pragma unroll
    for (int k = 0; k < QT; ++k) c.set_q(TP + k, atb[k]);
  }
  // w_eff: w, or _prop's clip of w - PropagateX (1 - w1) on Propagate
  // nodes (d clip / dx = 0.5 at either bound, as jnp.clip's)
#if HEAT_ADJ_VARIANT == 2
  const float slope = (s.x > 0.f && s.x < 1.f) ? 1.f
                      : (s.x == 0.f || s.x == 1.f) ? 0.5f : 0.f;
  const float ax = aweff * slope;
  c.set_q(WP, ax);
  c.set_q(W0, 0.f);
  if (s.prop) {
    const float w1 = c.pulled(W1);
    const float px = c.setting(S_PropagateX);
    c.set_q(W1, ax * px);
    c.add_setting(S_PropagateX, -(ax * (1.f - w1)));
  } else {
    c.set_q(W1, 0.f);
  }
#else
  c.set_q(WP, aweff);
#endif
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
