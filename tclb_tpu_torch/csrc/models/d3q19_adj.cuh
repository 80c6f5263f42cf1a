// d3q19_adj device physics for the generic 3D kernels (csrc/generic3d.cu,
// csrc/generic3d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q19_adj.py: the forward
// stage<0> (Run) and its hand-written reverse stage_b<0>, which plays the
// role of the reference's Tapenade-generated Run_b.  The forward is
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
// and the reverse against the adjoint context, which adds
//
//   c.lam(k)             the cotangent of output plane k at the node
//   c.lam_global(g)      the cotangent of SUM global g
//   c.add_setting(i, v)  a contribution to setting i's cotangent
//   c.set_q(k, v)        the cotangent of pulled input plane k
//
// The forward repeats the PyTorch model op for op in the same order
// (population sums in plane order, the boundary closures of
// ops/lbm.py:nebb_boundary term by term, PyTorch's divisions by constants
// as multiplies by their reciprocals) and generic3d.cu is built with
// --fmad=false, so the forward kernels agree with the plain versions to a
// few ulps.  The reverse is the exact derivative of that arithmetic in
// another order.  Each boundary closure is linear in f at fixed Velocity or
// Density, so its reverse is a fixed transpose; Velocity, Density and
// Porocity are zonal, so no settings cotangent flows to them.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file's enums and tables against that list and the model.

#pragma once

// generic3d.cu builds generic3d_step_b for this model
#define TCLB_MODEL_ADJOINT 1

#include "d3q19_common.cuh"

namespace model {

// storage planes: f[0..18] over the d3q19 velocity set (models/d3q19.py,
// shell-ordered; d3q19_common.cuh), then the design density w, which does
// not stream
constexpr int N_STORAGE = 20;
constexpr int WP = 19;         // the design density w
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, -1, 0, 0, 0, 0, 1, 1, -1,
                                -1, 1, 1, -1, -1, 0, 0, 0, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 0, 1, -1, 0, 0, 1, -1, 1,
                                -1, 0, 0, 0, 0, 1, 1, -1, -1, 0};
  return t[k];
}
__host__ __device__ constexpr int ez(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0,
                                0, 1, -1, 1, -1, 1, -1, 1, -1, 0};
  return t[k];
}
__host__ __device__ constexpr int e(int a, int k) {
  return a == 0 ? ex(k) : (a == 1 ? ey(k) : ez(k));
}

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x7ffffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_GravitationZ, S_S_high, S_Porocity, S_PorocityGamma,
  S_PressureLossInObj, S_OutletFluxInObj, S_InletFluxInObj, S_DragInObj,
  S_LiftInObj, S_MaterialInObj, S_MaterialPenaltyInObj,
  N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, T_NSymmetry, T_SSymmetry, T_Inlet, T_Outlet,
                N_TYPES };
enum Group { G_COLLISION, G_DESIGNSPACE, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, Z_Porocity, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, GL_Drag,
              GL_Lift, GL_Material, GL_MaterialPenalty, N_GLOBALS };

// The forward of one node up to its outputs, shared by stage<0> and its
// reverse: the boundary cases, the macroscopic values, the relaxed
// non-equilibrium and the Brinkman velocity
struct Forward {
  float fb[Q];             // after the boundary cases
  float w, rho, u[3];
  float fneq[Q], back[Q];  // f - feq and the stress projection
  float v[3], den, nw, un2[3];
  bool coll, design, inlet, outlet;
  int bc;                  // which boundary case (0: none)

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
    float f[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
    w = c.pulled(WP);
    coll = c.nt_in_group(G_COLLISION);
    design = c.nt_in_group(G_DESIGNSPACE);
    inlet = c.nt_is(T_Inlet);
    outlet = c.nt_is(T_Outlet);
    bc = (c.nt_is(T_Wall) || c.nt_is(T_Solid)) ? 1
         : c.nt_is(T_WVelocity) ? 2 : c.nt_is(T_WPressure) ? 3
         : c.nt_is(T_EVelocity) ? 4 : c.nt_is(T_EPressure) ? 5
         : (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry)) ? 6 : 0;
    boundary19(bc, f, [&] { return c.zonal(Z_Velocity); },
               [&] { return c.zonal(Z_Density); }, fb);
    rho = sum19(fb);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      u[d] = combo<Q>([d](int k) { return (double)e(d, k); }, fb) / rho;
    float feq[Q];
    equilibrium(rho, u, feq);
#pragma unroll
    for (int k = 0; k < Q; ++k) fneq[k] = fb[k] - feq[k];
    stress_back(fneq, back);
    const float pg = c.setting(S_PorocityGamma);
    den = 1.f - pg * (1.f - w);
    nw = w / den;
    v[0] = u[0] + c.setting(S_GravitationX);
    v[1] = u[1] + c.setting(S_GravitationY);
    v[2] = u[2] + c.setting(S_GravitationZ);
#pragma unroll
    for (int d = 0; d < 3; ++d) un2[d] = v[d] * nw;
  }
};

// stage 0, Run: the boundary cases, the flux objectives, the two-rate MRT
// with the Brinkman velocity, Drag and Lift, the material globals
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  if (s.coll && (s.inlet || s.outlet)) {
    // models/family.py:add_flux_objectives
    const float r = s.rho;
    const float* uf = s.u;
    const float usq = uf[0] * uf[0] + uf[1] * uf[1] + uf[2] * uf[2];
    const float flux = uf[0] / r;
    const float ploss =
        uf[0] / r * ((r - 1.f) * (1.f / 3.f) + usq / r * 0.5f);
    // constant indices keep the kernel's global sums in registers
    if (s.outlet) c.add_global(GL_OutletFlux, flux);
    else c.add_global(GL_InletFlux, flux);
    c.add_global(GL_PressureLoss, s.inlet ? ploss : -ploss);
  }
  if (s.coll) {
    c.add_global(GL_Drag, (1.f - s.nw) * s.v[0]);
    c.add_global(GL_Lift, (1.f - s.nw) * s.v[1]);
    const float keep_stress = 1.f - c.setting(S_omega);
    const float keep_high = 1.f - c.setting(S_S_high);
    const float d = keep_stress - keep_high;
    float feq2[Q];
    equilibrium(s.rho, s.un2, feq2);
#pragma unroll
    for (int k = 0; k < Q; ++k)
      c.store(k, keep_high * s.fneq[k] + d * s.back[k] + feq2[k]);
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) c.store(k, s.fb[k]);
  }
  if (s.design) {
    c.add_global(GL_MaterialPenalty, s.w * (1.f - s.w));
    c.add_global(GL_Material, 1.f - s.w);
  }
}

// reverse of stage 0: the cotangents of the 20 pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  float afb[Q];
  float aw = 0.f;
  if (s.design) {
    const float lp = c.lam_global(GL_MaterialPenalty);
    aw += lp * (1.f - s.w) - lp * s.w - c.lam_global(GL_Material);
  }
  float arho = 0.f, au[3] = {0.f, 0.f, 0.f};
  if (s.coll) {
    // fc_k = kh fneq_k + d back_k + feq2_k, d = ks - kh
    const float kh = 1.f - c.setting(S_S_high);
    const float d = (1.f - c.setting(S_omega)) - kh;
    float a[Q], afneq[Q], amn[NSTRESS];
    float akh = 0.f, ad = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      a[k] = c.lam(k);
      afneq[k] = kh * a[k];
      akh += a[k] * s.fneq[k];
      ad += a[k] * s.back[k];
    }
    // back = B mn, mn = M6 fneq
#pragma unroll
    for (int j = 0; j < NSTRESS; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < Q; ++k)
        if (basis(j, k) != 0.0)
          acc += (float)(basis(j, k) / norm(j)) * (d * a[k]);
      amn[j] = acc;
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
#pragma unroll
      for (int j = 0; j < NSTRESS; ++j)
        if (basis(j, k) != 0.0) afneq[k] += (float)basis(j, k) * amn[j];
    }
    // ks = 1 - omega, kh = 1 - S_high
    c.add_setting(S_omega, -ad);
    c.add_setting(S_S_high, -(akh - ad));
    // fneq = fb - feq(rho, u); feq2 = feq(rho, un2)
    float afeq[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      afb[k] = afneq[k];
      afeq[k] = -afneq[k];
    }
    equilibrium_b(s.rho, s.u, afeq, arho, au);
    float aun2[3] = {0.f, 0.f, 0.f};
    equilibrium_b(s.rho, s.un2, a, arho, aun2);
    // un2 = v nw; Drag = (1 - nw) v_x, Lift = (1 - nw) v_y
    const float ld = c.lam_global(GL_Drag), ll = c.lam_global(GL_Lift);
    float anw = -(ld * s.v[0] + ll * s.v[1]);
    float av[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      av[k] = aun2[k] * s.nw;
      anw += aun2[k] * s.v[k];
    }
    av[0] += ld * (1.f - s.nw);
    av[1] += ll * (1.f - s.nw);
    // v = u + g
#pragma unroll
    for (int k = 0; k < 3; ++k) au[k] += av[k];
    c.add_setting(S_GravitationX, av[0]);
    c.add_setting(S_GravitationY, av[1]);
    c.add_setting(S_GravitationZ, av[2]);
    // nw = w / den, den = 1 - pg (1 - w)
    const float pg = c.setting(S_PorocityGamma);
    const float aden = -anw * s.nw / s.den;
    aw += anw / s.den + aden * pg;
    c.add_setting(S_PorocityGamma, -aden * (1.f - s.w));
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) afb[k] = c.lam(k);
  }
  // u = j / rho, rho = sum fb
  float aj[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) aj[d] = au[d] / s.rho;
  arho -= (au[0] * s.u[0] + au[1] * s.u[1] + au[2] * s.u[2]) / s.rho;
  if (s.coll && (s.inlet || s.outlet)) {
    // the flux objectives: A = ux / r, B = (r - 1) / 3 + usq / r / 2,
    // InletFlux or OutletFlux = A, PressureLoss = +-A B
    const float r = s.rho;
    const float* uf = s.u;
    const float usq = uf[0] * uf[0] + uf[1] * uf[1] + uf[2] * uf[2];
    const float A = uf[0] / r;
    const float B = (r - 1.f) / 3.f + usq / r * 0.5f;
    const float lp = s.inlet ? c.lam_global(GL_PressureLoss)
                             : -c.lam_global(GL_PressureLoss);
    const float aA = c.lam_global(s.outlet ? GL_OutletFlux : GL_InletFlux)
                     + lp * B;
    const float aB = lp * A;
    float ar = -aA * A / r + aB / 3.f - aB * 0.5f * usq / (r * r);
    const float ausq = aB * 0.5f / r;
    float auf[3] = {aA / r + 2.f * uf[0] * ausq, 2.f * uf[1] * ausq,
                    2.f * uf[2] * ausq};
    ar -= (auf[0] * uf[0] + auf[1] * uf[1] + auf[2] * uf[2]) / r;
    arho += ar;
#pragma unroll
    for (int d = 0; d < 3; ++d) aj[d] += auf[d] / r;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float t = arho;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (e(d, k)) t += e(d, k) > 0 ? aj[d] : -aj[d];
    afb[k] += t;
  }
  // the boundary cases
  float q[Q];
  switch (s.bc) {
    case 1:
#pragma unroll
      for (int k = 0; k < Q; ++k) q[k] = afb[opp(k)];
      break;
    case 2: nebb_b<0, 1, true>(c.zonal(Z_Velocity), afb, q); break;
    case 3: nebb_b<0, 1, false>(c.zonal(Z_Density), afb, q); break;
    case 4: nebb_b<0, -1, true>(c.zonal(Z_Velocity), afb, q); break;
    case 5: nebb_b<0, -1, false>(c.zonal(Z_Density), afb, q); break;
    case 6:
#pragma unroll
      for (int k = 0; k < Q; ++k) q[k] = afb[mirror_y(k)];
      break;
    default:
#pragma unroll
      for (int k = 0; k < Q; ++k) q[k] = afb[k];
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) c.set_q(k, q[k]);
  c.set_q(WP, aw);
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
