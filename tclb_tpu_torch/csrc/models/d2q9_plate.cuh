// d2q9_plate device physics for the generic 2D kernels (csrc/generic2d.cu,
// csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_plate.py: the forward
// stage<0> (Run) and its hand-written reverse stage_b<0>, which plays the
// role of the reference's Tapenade-generated Run_b.  Written against the
// node contexts d2q9_adj.cuh lists: the wall reaction globals (momentum
// exchange on the pulled populations of Wall nodes), the family's
// boundaries (bounce-back, the W and E faces of ops/lbm.py:nebb_boundary
// on the zonal Velocity and Density) and flux objectives, then BGK at the
// Smagorinsky rate (ops/lbm.py:smagorinsky_omega_unrolled) with the
// velocity-shift body force on collision nodes.
//
// The forward repeats the PyTorch model op for op in the same order
// (d2q9_common.cuh's conventions) and generic2d.cu is built with
// --fmad=false, so the forward kernels agree with the plain versions to a
// few ulps: the stress components pab round alike in both, which the
// reverse needs, since near rest they are rounding-sized and set the
// direction of d|Pi| / d pab = pab / |Pi|.  Where pi2 = |Pi|^2 is exactly
// 0 the reverse takes 0 for that derivative (models/d2q9_plate.py:
// stress_norm); the JAX package's is NaN there.  The reverse is otherwise
// the exact derivative of the forward's arithmetic in another order.  The
// zonal Velocity and Density take no cotangent.
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

// storage planes: f[0..8] over the d2q9 velocity set
constexpr int N_STORAGE = 9;
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x1ffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_nu, S_omega, S_Velocity, S_Density, S_GravitationX, S_GravitationY,
  S_tau0, S_Smag, S_PressureLossInObj, S_OutletFluxInObj, S_InletFluxInObj,
  S_ForceXInObj, S_ForceYInObj, S_MomentInObj, S_PowerXInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EVelocity,
                T_EPressure, T_Inlet, T_Outlet, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, GL_ForceX,
              GL_ForceY, GL_Moment, GL_PowerX, N_GLOBALS };

using d2q9::opp;
using d2q9::vx;
using d2q9::vy;

// 18 sqrt(2) as ops/lbm.py's Python double, rounded once
constexpr float SMAG_C = (float)(18.0 * 1.4142135623730951);

// The forward of one node, shared by stage<0> and its reverse: the
// boundary case and, on collision nodes, the macroscopic values, the
// Smagorinsky rate and both equilibria
struct Forward {
  float f[9];              // pulled populations
  float fb[9];             // after the boundary case
  float vel, value;        // the zonal Velocity; the face's value
  float rho, ux, uy;
  float feq[9], feq2[9];
  float pxx, pxy, pyy, pi2, sn;     // the stress and its norm
  float om0, tau0, x, y, tau, om;   // om = 1 / tau, tau = (tau0 + sqrt y) / 2
  int bc;                  // 1 bounce-back, 2-5 the faces, 0 none
  bool wall, coll, inlet, outlet;

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = fb[k] = c.pulled(k);
    wall = c.nt_is(T_Wall);
    coll = c.nt_in_group(G_COLLISION);
    inlet = c.nt_is(T_Inlet);
    outlet = c.nt_is(T_Outlet);
    vel = c.zonal(Z_Velocity);
    bc = (wall || c.nt_is(T_Solid)) ? 1
         : c.nt_is(T_WVelocity) ? 2 : c.nt_is(T_WPressure) ? 3
         : c.nt_is(T_EVelocity) ? 4 : c.nt_is(T_EPressure) ? 5 : 0;
    value = (bc == 3 || bc == 5) ? c.zonal(Z_Density) : vel;
    switch (bc) {
      case 1:
#pragma unroll
        for (int k = 0; k < 9; ++k) fb[k] = f[opp(k)];
        break;
      case 2: d2q9::nebb_x<1, true>(fb, value); break;
      case 3: d2q9::nebb_x<1, false>(fb, value); break;
      case 4: d2q9::nebb_x<-1, true>(fb, value); break;
      case 5: d2q9::nebb_x<-1, false>(fb, value); break;
      default: break;
    }
    if (!coll) return;
    rho = d2q9::sum9(fb);
    ux = d2q9::jx(fb) / rho;
    uy = d2q9::jy(fb) / rho;
    d2q9::equilibrium(rho, ux, uy, feq);
    // lbm.smagorinsky_omega_unrolled: |Pi|^2 over (xx, xy, yy), each sum
    // from Python's 0
    pxx = pxy = pyy = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float d = fb[k] - feq[k];
      if (vx(k) != 0) pxx = pxx + d;
      if (vx(k) * vy(k) != 0) pxy = pxy + (vx(k) * vy(k) > 0 ? d : -d);
      if (vy(k) != 0) pyy = pyy + d;
    }
    pi2 = (pxx * pxx + (pxy * pxy) * 2.f) + pyy * pyy;
    sn = pi2 == 0.f ? 0.f : sqrtf(pi2);
    om0 = 1.f / (3.f * c.setting(S_nu) + 0.5f);
    tau0 = 1.f / om0;
    const float smag = c.setting(S_Smag);
    x = ((SMAG_C * smag) * smag * sn) / rho;
    y = tau0 * tau0 + x;
    tau = 0.5f * (tau0 + sqrtf(y));
    om = 1.f / tau;
    d2q9::equilibrium(rho, ux + c.setting(S_GravitationX),
                      uy + c.setting(S_GravitationY), feq2);
  }
};

// stage 0, Run: the wall reaction globals, the boundary case, the flux
// objectives and the collision
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  if (s.wall) {
    const float fx = d2q9::jx(s.f), fy = d2q9::jy(s.f);
    c.add_global(GL_ForceX, 2.f * fx);
    c.add_global(GL_ForceY, 2.f * fy);
    c.add_global(GL_PowerX, 2.f * fx * s.vel);
    c.add_global(GL_Moment, 2.f * fy);
  }
  if (s.coll && (s.inlet || s.outlet)) {
    // models/family.py:add_flux_objectives
    const float usq = s.ux * s.ux + s.uy * s.uy;
    const float flux = s.ux / s.rho;
    const float ploss = s.ux / s.rho * ((s.rho - 1.f) * (1.f / 3.f)
                                        + usq / s.rho * 0.5f);
    if (s.outlet) c.add_global(GL_OutletFlux, flux);
    else c.add_global(GL_InletFlux, flux);
    c.add_global(GL_PressureLoss, s.inlet ? ploss : -ploss);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (s.coll)
      c.store(k, (s.fb[k] + s.om * (s.feq[k] - s.fb[k]))
                     + (s.feq2[k] - s.feq[k]));
    else
      c.store(k, s.fb[k]);
  }
}

// reverse of stage 0: the cotangents of the 9 pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  float afb[9];
  if (s.coll) {
    // out = fb + om (feq - fb) + feq2 - feq
    float a[9], afeq[9], aom = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      a[k] = c.lam(k);
      afb[k] = a[k] * (1.f - s.om);
      afeq[k] = a[k] * (s.om - 1.f);
      aom += a[k] * (s.feq[k] - s.fb[k]);
    }
    // om = 1 / tau, tau = (tau0 + sqrt y) / 2, y = tau0^2 + x,
    // x = C smag^2 sn / rho
    const float atau = -aom * s.om * s.om;
    const float ay = atau * 0.25f / sqrtf(s.y);
    const float atau0 = atau * 0.5f + ay * 2.f * s.tau0;
    const float smag = c.setting(S_Smag);
    c.add_setting(S_Smag, ay * 2.f * SMAG_C * smag * s.sn / s.rho);
    const float asn = ay * SMAG_C * smag * smag / s.rho;
    float arho = -ay * s.x / s.rho, aux = 0.f, auy = 0.f;
    // tau0 = 1 / om0, om0 = 1 / (3 nu + 0.5)
    const float aom0 = -atau0 * s.tau0 * s.tau0;
    c.add_setting(S_nu, -aom0 * s.om0 * s.om0 * 3.f);
    // sn = sqrt(pi2), with a derivative of 0 where pi2 == 0
    if (s.pi2 != 0.f) {
      const float api2 = asn * 0.5f / s.sn;
      const float axx = 2.f * s.pxx * api2, axy = 4.f * s.pxy * api2;
      const float ayy = 2.f * s.pyy * api2;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float ad = 0.f;
        if (vx(k) != 0) ad += axx;
        if (vx(k) * vy(k) != 0) ad += vx(k) * vy(k) > 0 ? axy : -axy;
        if (vy(k) != 0) ad += ayy;
        afb[k] += ad;
        afeq[k] -= ad;
      }
    }
    // feq2 = feq(rho, u + g)
    float agx = 0.f, agy = 0.f;
    d2q9::equilibrium_b(s.rho, s.ux + c.setting(S_GravitationX),
                        s.uy + c.setting(S_GravitationY), a, arho, agx, agy);
    c.add_setting(S_GravitationX, agx);
    c.add_setting(S_GravitationY, agy);
    aux += agx;
    auy += agy;
    d2q9::equilibrium_b(s.rho, s.ux, s.uy, afeq, arho, aux, auy);
    if (s.inlet || s.outlet) {
      // the flux objectives: A = ux / rho, PressureLoss = +-A B with
      // B = (rho - 1) / 3 + usq / rho / 2
      const float usq = s.ux * s.ux + s.uy * s.uy;
      const float A = s.ux / s.rho;
      const float B = (s.rho - 1.f) * (1.f / 3.f) + usq / s.rho * 0.5f;
      const float lp = s.inlet ? c.lam_global(GL_PressureLoss)
                               : -c.lam_global(GL_PressureLoss);
      const float aA = c.lam_global(s.outlet ? GL_OutletFlux
                                             : GL_InletFlux) + lp * B;
      const float aB = lp * A;
      const float ausq = aB * 0.5f / s.rho;
      aux += aA / s.rho + 2.f * s.ux * ausq;
      auy += 2.f * s.uy * ausq;
      arho += -aA * A / s.rho + aB * (1.f / 3.f)
              - aB * 0.5f * usq / (s.rho * s.rho);
    }
    // u = j / rho, rho = sum fb
    const float ajx = aux / s.rho, ajy = auy / s.rho;
    arho -= (aux * s.ux + auy * s.uy) / s.rho;
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] += arho + vx(k) * ajx + vy(k) * ajy;
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] = c.lam(k);
  }
  // the boundary case; its zonal value takes no cotangent
  float q[9];
  switch (s.bc) {
    case 1:
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = afb[opp(k)];
      break;
    case 2: d2q9::nebb_x_b<1, true>(s.value, afb, q); break;
    case 3: d2q9::nebb_x_b<1, false>(s.value, afb, q); break;
    case 4: d2q9::nebb_x_b<-1, true>(s.value, afb, q); break;
    case 5: d2q9::nebb_x_b<-1, false>(s.value, afb, q); break;
    default:
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = afb[k];
  }
  if (s.wall) {
    // ForceX, PowerX = 2 jx (times Velocity); ForceY, Moment = 2 jy
    const float ax = 2.f * (c.lam_global(GL_ForceX)
                            + c.lam_global(GL_PowerX) * s.vel);
    const float ay = 2.f * (c.lam_global(GL_ForceY)
                            + c.lam_global(GL_Moment));
#pragma unroll
    for (int k = 0; k < 9; ++k) q[k] += vx(k) * ax + vy(k) * ay;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) c.set_q(k, q[k]);
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
