// d2q9_adj device physics for the generic 2D kernels (csrc/generic2d.cu,
// csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_adj.py: the forward
// stage<0> (Run) and its hand-written reverse stage_b<0>, which plays the
// role of the reference's Tapenade-generated Run_b.  The forward is
// written against the template's node context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.setting(i)         setting i (enum Setting, registry order)
//   c.zonal(j)           zonal setting j at the node's zone (enum Zonal)
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
// (d2q9_common.cuh's conventions) and generic2d.cu is built with
// --fmad=false, so the forward kernels agree with the plain versions to a
// few ulps.  The reverse is the exact derivative of that arithmetic in
// another order: the moment transforms are constant matrices, so their
// reverse is the transpose.  Velocity, Pressure and Porocity are zonal, so
// no settings cotangent flows to them.  omega is the stress rows' keep
// factor (the registry derives 1 - 1 / (3 nu + 0.5)) and PorocityGamma
// comes from PorocityTheta there too: the header reads both as given.
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

// storage planes: f[0..8] over the d2q9 velocity set, then the design
// density w, which does not stream
constexpr int N_STORAGE = 10;
constexpr int WP = 9;          // the design density w
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1, 0};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x1ffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_Velocity, S_Pressure, S_ForceX, S_ForceY,
  S_PorocityGamma, S_PorocityTheta, S_Porocity, S_DragInObj, S_LiftInObj,
  S_MaterialPenaltyInObj, S_MaterialInObj, S_PressureLossInObj,
  S_OutletFluxInObj, S_InletFluxInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, T_MRT, T_Inlet, T_Outlet, N_TYPES };
enum Group { G_DESIGNSPACE, N_GROUPS };
enum Zonal { Z_Velocity, Z_Pressure, Z_Porocity, N_ZONAL };
enum Global { GL_Drag, GL_Lift, GL_MaterialPenalty, GL_Material,
              GL_PressureLoss, GL_OutletFlux, GL_InletFlux, N_GLOBALS };

using d2q9::basis;
using d2q9::combo;
using d2q9::norm;
using d2q9::opp;

// the moment rows the collision keeps (3: -1/3; 7 and 8: omega)
__host__ __device__ constexpr int kept_row(int i) { return i ? 6 + i : 3; }
__device__ __forceinline__ float keep(int r, float om) {
  return r == 3 ? (float)(-1.0 / 3.0) : om;
}

// The forward of one node, shared by stage<0> and its reverse: the
// boundary case, the macroscopic values, and on MRT nodes the kept
// moments and the Brinkman velocity
struct Forward {
  float f[9];              // pulled populations
  float fb[9];             // after the boundary case
  float w, value;          // design density; the face's zonal value
  float rho, ux, uy, usq;
  float mn[3];             // the kept rows of M (fb - feq)
  float ux2, uy2, dn, nw;  // u + Force; nw = w / dn
  int bc;                  // 1 bounce-back, 2-5 the Zou/He faces, 0 none
  bool mrt, inlet, outlet, design;

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = fb[k] = c.pulled(k);
    w = c.pulled(WP);
    mrt = c.nt_is(T_MRT);
    inlet = c.nt_is(T_Inlet);
    outlet = c.nt_is(T_Outlet);
    design = c.nt_in_group(G_DESIGNSPACE);
    bc = (c.nt_is(T_Wall) || c.nt_is(T_Solid)) ? 1
         : c.nt_is(T_EVelocity) ? 2 : c.nt_is(T_WPressure) ? 3
         : c.nt_is(T_WVelocity) ? 4 : c.nt_is(T_EPressure) ? 5 : 0;
    value = 0.f;
    if (bc == 2 || bc == 4) value = c.zonal(Z_Velocity);
    if (bc == 3 || bc == 5) value = 1.f + 3.f * c.zonal(Z_Pressure);
    switch (bc) {
      case 1:
#pragma unroll
        for (int k = 0; k < 9; ++k) fb[k] = f[opp(k)];
        break;
      case 2: d2q9::zou_he_x<false, true>(fb, value); break;
      case 3: d2q9::zou_he_x<true, false>(fb, value); break;
      case 4: d2q9::zou_he_x<true, true>(fb, value); break;
      case 5: d2q9::zou_he_x<false, false>(fb, value); break;
      default: break;
    }
    rho = d2q9::sum9(fb);
    ux = d2q9::jx(fb) / rho;
    uy = d2q9::jy(fb) / rho;
    usq = ux * ux + uy * uy;
    if (!mrt) return;
    float d[9];
    d2q9::equilibrium(rho, ux, uy, d);
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k] = fb[k] - d[k];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      mn[i] = combo([i](int k) { return (float)basis(kept_row(i), k); }, d);
    ux2 = ux + c.setting(S_ForceX);
    uy2 = uy + c.setting(S_ForceY);
    dn = 1.f - c.setting(S_PorocityGamma) * (1.f - w);
    nw = w / dn;
  }
};

// stage 0, Run: the boundary case, the flux objectives, on MRT nodes the
// collision (the kept moments relaxed, the penalised equilibrium's added)
// with Drag and Lift, and the material globals
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  if (s.inlet || s.outlet) {
    // on every Inlet and Outlet node, colliding or not
    const float flux = s.ux / s.rho;
    const float ploss = s.ux / s.rho * ((s.rho - 1.f) * (1.f / 3.f)
                                        + s.usq / s.rho * 0.5f);
    // constant indices keep the kernel's global sums in registers
    if (s.outlet) c.add_global(GL_OutletFlux, flux);
    else c.add_global(GL_InletFlux, flux);
    c.add_global(GL_PressureLoss, s.inlet ? ploss : -ploss);
  }
  if (s.mrt) {
    c.add_global(GL_Drag, (1.f - s.nw) * s.ux2);
    c.add_global(GL_Lift, (1.f - s.nw) * s.uy2);
    float feq2[9], mp[9];
    d2q9::equilibrium(s.rho, s.ux2 * s.nw, s.uy2 * s.nw, feq2);
    // m_post = m_neq + M feq2, the dropped rows' m_neq a zero plane
    const float om = c.setting(S_omega);
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      const float m = combo([r](int k) { return (float)basis(r, k); }, feq2);
      float kept = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (kept_row(i) == r) kept = s.mn[i] * keep(r, om);
      mp[r] = kept + m;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
      c.store(k, combo([k](int r) { return (float)(basis(r, k) / norm(r)); },
                       mp));
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) c.store(k, s.fb[k]);
  }
  if (s.design) {
    c.add_global(GL_MaterialPenalty, s.w * (1.f - s.w));
    c.add_global(GL_Material, 1.f - s.w);
  }
}

// reverse of stage 0: the cotangents of the 10 pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  float afb[9];
  float aw = 0.f, arho = 0.f, aux = 0.f, auy = 0.f;
  if (s.design) {
    const float lp = c.lam_global(GL_MaterialPenalty);
    aw += lp * (1.f - s.w) - lp * s.w - c.lam_global(GL_Material);
  }
  if (s.mrt) {
    // out = Minv mp: amp = Minv^T a; mp = m_neq + M feq2: afeq2 = M^T amp
    float a[9], amp[9], afeq2[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) a[k] = c.lam(k);
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (basis(r, k) != 0) acc += (float)(basis(r, k) / norm(r)) * a[k];
      amp[r] = acc;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < 9; ++r)
        if (basis(r, k) != 0) acc += (float)basis(r, k) * amp[r];
      afeq2[k] = acc;
    }
    // m_neq_r = mn_r keep_r, mn = M (fb - feq)
    const float om = c.setting(S_omega);
    float aom = 0.f, afeq[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int r = kept_row(i);
      if (r != 3) aom += amp[r] * s.mn[i];
      const float amn = amp[r] * keep(r, om);
#pragma unroll
      for (int k = 0; k < 9; ++k)
        if (basis(r, k) != 0) afb[k] += (float)basis(r, k) * amn;
    }
    c.add_setting(S_omega, aom);
#pragma unroll
    for (int k = 0; k < 9; ++k) afeq[k] = -afb[k];
    d2q9::equilibrium_b(s.rho, s.ux, s.uy, afeq, arho, aux, auy);
    // feq2 = feq(rho, ux2 nw, uy2 nw); Drag = (1 - nw) ux2, Lift likewise
    float aun = 0.f, avn = 0.f;
    d2q9::equilibrium_b(s.rho, s.ux2 * s.nw, s.uy2 * s.nw, afeq2, arho, aun,
                        avn);
    const float ld = c.lam_global(GL_Drag), ll = c.lam_global(GL_Lift);
    const float aux2 = aun * s.nw + ld * (1.f - s.nw);
    const float auy2 = avn * s.nw + ll * (1.f - s.nw);
    const float anw = aun * s.ux2 + avn * s.uy2 - (ld * s.ux2 + ll * s.uy2);
    // ux2 = ux + ForceX, uy2 = uy + ForceY
    aux += aux2;
    auy += auy2;
    c.add_setting(S_ForceX, aux2);
    c.add_setting(S_ForceY, auy2);
    // nw = w / dn, dn = 1 - PorocityGamma (1 - w)
    const float pg = c.setting(S_PorocityGamma);
    const float adn = -anw * s.nw / s.dn;
    aw += anw / s.dn + adn * pg;
    c.add_setting(S_PorocityGamma, -adn * (1.f - s.w));
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] = c.lam(k);
  }
  if (s.inlet || s.outlet) {
    // flux = ux / rho, PressureLoss = +-(ux / rho) B with
    // B = (rho - 1) / 3 + usq / rho / 2
    const float A = s.ux / s.rho;
    const float B = (s.rho - 1.f) * (1.f / 3.f) + s.usq / s.rho * 0.5f;
    const float lp = s.inlet ? c.lam_global(GL_PressureLoss)
                             : -c.lam_global(GL_PressureLoss);
    const float aA = c.lam_global(s.outlet ? GL_OutletFlux : GL_InletFlux)
                     + lp * B;
    const float aB = lp * A;
    const float ausq = aB * 0.5f / s.rho;
    aux += aA / s.rho + 2.f * s.ux * ausq;
    auy += 2.f * s.uy * ausq;
    arho += -aA * A / s.rho + aB * (1.f / 3.f)
            - aB * 0.5f * s.usq / (s.rho * s.rho);
  }
  if (s.mrt || s.inlet || s.outlet) {
    // u = j / rho, rho = sum fb
    const float ajx = aux / s.rho, ajy = auy / s.rho;
    arho -= (aux * s.ux + auy * s.uy) / s.rho;
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] += arho + ex(k) * ajx + ey(k) * ajy;
  }
  // the boundary case; its zonal value takes no cotangent
  float q[9], av;
  switch (s.bc) {
    case 1:
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = afb[opp(k)];
      break;
    case 2: d2q9::zou_he_x_b<false, true>(s.f, s.value, afb, q, av); break;
    case 3: d2q9::zou_he_x_b<true, false>(s.f, s.value, afb, q, av); break;
    case 4: d2q9::zou_he_x_b<true, true>(s.f, s.value, afb, q, av); break;
    case 5: d2q9::zou_he_x_b<false, false>(s.f, s.value, afb, q, av); break;
    default:
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = afb[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) c.set_q(k, q[k]);
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
