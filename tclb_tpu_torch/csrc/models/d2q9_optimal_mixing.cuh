// d2q9_optimalMixing device physics for the generic 2D kernels
// (csrc/generic2d.cu, csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_optimal_mixing.py:
// the forward stage<0> (Run) and its hand-written reverse stage_b<0>, which
// plays the role of the reference's Tapenade-generated Run_b.  Written
// against the node contexts d2q9_adj.cuh lists: BGK d2q9 flow and a d2q5
// scalar g, bounce-back on Wall and Solid, on MovingWall nodes
// bounce-back plus 6 w_i e_ix MovingWallVelocity (zonal), the scalar
// bouncing back on all three; TotalTempSqr and CountCells on collision
// nodes, NMovingWallForce on MovingWall nodes.
//
// The forward repeats the PyTorch model op for op in the same order
// (d2q9_common.cuh's conventions; the d2q5 equilibrium's e.u keeps its
// zero terms, as the model writes them) and generic2d.cu is built with
// --fmad=false, so the forward kernels agree with the plain versions to a
// few ulps.  The reverse is the exact derivative of that arithmetic in
// another order.  The four zonal settings take no cotangent.
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

// storage planes: f[0..8] over the d2q9 velocity set, then g[0..4] over
// d2q5 (rest, +x, -x, +y, -y)
constexpr int N_STORAGE = 14;
constexpr int G0 = 9;          // first g plane
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1,
                                0, 1, -1, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1,
                                0, 0, 0, 1, -1};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f and g
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x3fffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_omegaT, S_K, S_MovingWallVelocity, S_Velocity,
  S_Pressure, S_Temperature, S_TotalTempSqrInObj, S_CountCellsInObj,
  S_NMovingWallForceInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_MovingWall, N_TYPES };
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_MovingWallVelocity, Z_Velocity, Z_Pressure, Z_Temperature,
             N_ZONAL };
enum Global { GL_TotalTempSqr, GL_CountCells, GL_NMovingWallForce,
              N_GLOBALS };

using d2q9::opp;
using d2q9::vx;
using d2q9::vy;
using d2q9::wd;

// the d2q5 set of g: weights and bounce-back pairs
__host__ __device__ constexpr double wg(int i) { return i ? 1.0 / 6 : 1.0 / 3; }
__host__ __device__ constexpr int oppg(int i) {
  constexpr int t[5] = {0, 2, 1, 4, 3};
  return t[i];
}
__host__ __device__ constexpr int gx(int i) { return ex(G0 + i); }
__host__ __device__ constexpr int gy(int i) { return ey(G0 + i); }

// the d2q5 equilibrium's e_i.u, zero terms included
__device__ __forceinline__ float eu5(int i, float ux, float uy) {
  return (float)gx(i) * ux + (float)gy(i) * uy;
}

// The forward of one node, shared by stage<0> and its reverse: the
// boundary cases and, on collision nodes, the macroscopic values and both
// equilibria
struct Forward {
  float fb[9], gb[5];      // after the boundary cases
  float mwv;               // the zonal MovingWallVelocity
  float rho, ux, uy, temp;
  float feq[9], geq[5];
  bool wall, mw, coll;

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
    float f[9], g[5];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = fb[k] = c.pulled(k);
#pragma unroll
    for (int i = 0; i < 5; ++i) g[i] = gb[i] = c.pulled(G0 + i);
    wall = c.nt_is(T_Wall) || c.nt_is(T_Solid);
    mw = c.nt_is(T_MovingWall);
    coll = c.nt_in_group(G_COLLISION);
    mwv = c.zonal(Z_MovingWallVelocity);
    if (wall || mw) {
#pragma unroll
      for (int k = 0; k < 9; ++k) fb[k] = f[opp(k)];
#pragma unroll
      for (int i = 0; i < 5; ++i) gb[i] = g[oppg(i)];
    }
    if (mw) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
        fb[k] = fb[k] + (vx(k) ? (float)(6.0 * wd(k) * vx(k)) * mwv : 0.f);
    }
    if (!coll) return;
    rho = d2q9::sum9(fb);
    ux = d2q9::jx(fb) / rho;
    uy = d2q9::jy(fb) / rho;
    d2q9::equilibrium(rho, ux, uy, feq);
    temp = gb[0];
#pragma unroll
    for (int i = 1; i < 5; ++i) temp = temp + gb[i];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      geq[i] = (float)wg(i) * temp * (1.f + 3.f * eu5(i, ux, uy));
  }
};

// stage 0, Run: the boundary cases, both BGK collisions, the three globals
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  float fo[9], go[5];
  if (s.coll) {
    const float om = c.setting(S_omega), omt = c.setting(S_omegaT);
#pragma unroll
    for (int k = 0; k < 9; ++k) fo[k] = s.fb[k] + om * (s.feq[k] - s.fb[k]);
#pragma unroll
    for (int i = 0; i < 5; ++i) go[i] = s.gb[i] + omt * (s.geq[i] - s.gb[i]);
    c.add_global(GL_TotalTempSqr, s.temp * s.temp);
    c.add_global(GL_CountCells, 1.f);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) fo[k] = s.fb[k];
#pragma unroll
    for (int i = 0; i < 5; ++i) go[i] = s.gb[i];
  }
  if (s.mw) c.add_global(GL_NMovingWallForce, 2.f * d2q9::jx(fo) * s.mwv);
#pragma unroll
  for (int k = 0; k < 9; ++k) c.store(k, fo[k]);
#pragma unroll
  for (int i = 0; i < 5; ++i) c.store(G0 + i, go[i]);
}

// reverse of stage 0: the cotangents of the 14 pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  float a[9], ag[5], afb[9], agb[5];
  // NMovingWallForce = 2 mwv jx(out)
  const float an = s.mw ? 2.f * s.mwv * c.lam_global(GL_NMovingWallForce)
                        : 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) a[k] = c.lam(k) + vx(k) * an;
#pragma unroll
  for (int i = 0; i < 5; ++i) ag[i] = c.lam(G0 + i);
  if (s.coll) {
    // fo = fb + om (feq - fb), go = gb + omt (geq - gb)
    const float om = c.setting(S_omega), omt = c.setting(S_omegaT);
    float afeq[9], aom = 0.f, aomt = 0.f;
    float arho = 0.f, aux = 0.f, auy = 0.f;
    float atemp = 2.f * s.temp * c.lam_global(GL_TotalTempSqr);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      afb[k] = a[k] * (1.f - om);
      afeq[k] = a[k] * om;
      aom += a[k] * (s.feq[k] - s.fb[k]);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      agb[i] = ag[i] * (1.f - omt);
      aomt += ag[i] * (s.geq[i] - s.gb[i]);
      // geq_i = wg_i temp (1 + 3 e_i.u)
      const float ae = ag[i] * omt * (float)wg(i);
      atemp += ae * (1.f + 3.f * eu5(i, s.ux, s.uy));
      const float aeu = ae * s.temp * 3.f;
      aux += gx(i) * aeu;
      auy += gy(i) * aeu;
    }
    c.add_setting(S_omega, aom);
    c.add_setting(S_omegaT, aomt);
    d2q9::equilibrium_b(s.rho, s.ux, s.uy, afeq, arho, aux, auy);
    // u = j / rho, rho = sum fb, temp = sum gb
    const float ajx = aux / s.rho, ajy = auy / s.rho;
    arho -= (aux * s.ux + auy * s.uy) / s.rho;
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] += arho + vx(k) * ajx + vy(k) * ajy;
#pragma unroll
    for (int i = 0; i < 5; ++i) agb[i] += atemp;
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) afb[k] = a[k];
#pragma unroll
    for (int i = 0; i < 5; ++i) agb[i] = ag[i];
  }
  // the boundary cases (a moving wall's term is a zonal value's)
  const bool back = s.wall || s.mw;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.set_q(k, back ? afb[opp(k)] : afb[k]);
#pragma unroll
  for (int i = 0; i < 5; ++i) c.set_q(G0 + i, back ? agb[oppg(i)] : agb[i]);
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
