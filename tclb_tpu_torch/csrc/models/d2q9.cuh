// d2q9 device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9.py's Iteration action
// (one stage, Run): the Zou/He velocity and pressure faces, the symmetry
// mirrors and bounce-back, then on MRT nodes the orthogonal-moment
// collision with the velocity-shift body force and the flux and
// pressure-loss objectives.  It lets d2q9 run on the generic engines, whose
// series flavours read a <Control> time series per step; without a series
// d2q9 keeps its own kernels (csrc/d2q9.cu, which this file shares nothing
// with).  Written against the template's node context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.setting(i)         setting i (enum Setting, registry order)
//   c.zonal(j)           zonal setting j at the node's zone (enum Zonal;
//                        the series flavours' per-step value where a
//                        series overrides that zone)
//   c.nt_is(t)           the node's group field equals node type t
//   c.nt_in_group(g)     any bit of group g is set
//   c.add_global(g, v)   a node's contribution to SUM global g
//   c.store(k, v)        plane k of the stage's output
//
// The arithmetic repeats the PyTorch model op for op in the same order
// (population sums in plane order, a division by a constant as PyTorch's
// CUDA kernels do it: a multiply by its reciprocal), and generic2d.cu is
// built with --fmad=false, so the kernels agree with the plain versions to
// a few ulps (rho is torch.sum's reduction there, a sum in plane order
// here).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

namespace model {

// storage planes: f[0..8] over the d2q9 velocity set, then the two BC
// coupling planes (read by the collision, never written)
constexpr int N_STORAGE = 11;
constexpr int BC0 = 9, BC1 = 10;
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1, 0, 0};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x1ffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_Velocity, S_Density, S_GravitationY, S_GravitationX,
  S_S3, S_S4, S_S56, S_S78, S_PressureLossInObj, S_OutletFluxInObj,
  S_InletFluxInObj, N_SETTINGS
};
enum NodeType {
  T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure, T_EVelocity,
  T_BottomSymmetry, T_TopSymmetry, T_MRT, T_Inlet, T_Outlet, N_TYPES
};
enum Group { G_BOUNDARY, N_GROUPS };
enum Zonal { Z_Velocity, Z_Density, N_ZONAL };
enum Global { GL_PressureLoss, GL_OutletFlux, GL_InletFlux, N_GLOBALS };

// lattice weights and bounce-back pairs (models/d2q9.py)
__host__ __device__ constexpr double wd(int k) {
  constexpr double t[9] = {4.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9,
                           1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36};
  return t[k];
}
__host__ __device__ constexpr int opp(int k) {
  constexpr int t[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  return t[k];
}

// the orthogonal MRT basis (ops/lbm.py:mrt_basis_d2q9) and its row norms;
// the inverse basis is basis(r, k) / norm(r)
__host__ __device__ constexpr int basis(int r, int k) {
  constexpr int t[9][9] = {
      {1, 1, 1, 1, 1, 1, 1, 1, 1},
      {0, 1, 0, -1, 0, 1, -1, -1, 1},
      {0, 0, 1, 0, -1, 1, 1, -1, -1},
      {-4, -1, -1, -1, -1, 2, 2, 2, 2},
      {4, -2, -2, -2, -2, 1, 1, 1, 1},
      {0, -2, 0, 2, 0, 1, -1, -1, 1},
      {0, 0, -2, 0, 2, 1, 1, -1, -1},
      {0, 1, -1, 1, -1, 0, 0, 0, 0},
      {0, 0, 0, 0, 0, 1, -1, 1, -1}};
  return t[r][k];
}
__host__ __device__ constexpr double norm(int r) {
  constexpr double t[9] = {9, 6, 6, 36, 36, 12, 12, 4, 4};
  return t[r];
}

// sum_k coef(k) x[k] over the nonzero coefficients of k in [lo, 9), in
// order (ops/lbm.py:edot and unrolled_matvec); +-1 is an add or a subtract
template <class Coef>
__device__ __forceinline__ float combo(Coef coef, const float* x,
                                       int lo = 0) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = lo; k < 9; ++k) {
    const float c = coef(k);
    if (c == 0.f) continue;
    const float t = (c == 1.f) ? x[k] : (c == -1.f ? -x[k] : c * x[k]);
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

// ops/lbm.py:equilibrium for d2q9, with PyTorch's divisions by the
// constants 1/3, 2/9 and 2/3 as multiplies by 3, 4.5 and 1.5
__device__ __forceinline__ void equilibrium(float rho, float ux, float uy,
                                            float* feq) {
  const float usq = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float wr = (float)wd(k) * rho;
    if (k == 0) {
      feq[k] = wr * (1.f - usq * 1.5f);
      continue;
    }
    float eu;
    if (ex(k) == 0) eu = ey(k) > 0 ? uy : -uy;
    else if (ey(k) == 0) eu = ex(k) > 0 ? ux : -ux;
    else eu = (ex(k) > 0 ? ux : -ux) + (ey(k) > 0 ? uy : -uy);
    feq[k] = wr * (1.f + eu * 3.f + eu * eu * 4.5f - usq * 1.5f);
  }
}

// Zou/He faces on x (models/d2q9.py:_zou_he_x): `west` the face the flow
// enters, `velocity` given ux (`v`), else given rho (`v`)
template <bool west, bool velocity>
__device__ __forceinline__ void zou_he_x(float* f, float v) {
  const float tang = f[0] + f[2] + f[4];
  const float known = west ? f[3] + f[7] + f[6] : f[1] + f[5] + f[8];
  float rho, ux;
  if (velocity) {
    ux = v;
    rho = (tang + 2.f * known) / (west ? 1.f - ux : 1.f + ux);
  } else {
    rho = v;
    ux = west ? 1.f - (tang + 2.f * known) / rho
              : -1.f + (tang + 2.f * known) / rho;
  }
  const float ru = rho * ux;
  if (west) {
    f[1] = f[3] + (float)(2.0 / 3.0) * ru;
    const float f5 = f[7] + (float)(1.0 / 6.0) * ru + 0.5f * (f[4] - f[2]);
    const float f8 = f[6] + (float)(1.0 / 6.0) * ru + 0.5f * (f[2] - f[4]);
    f[5] = f5;
    f[8] = f8;
  } else {
    f[3] = f[1] - (float)(2.0 / 3.0) * ru;
    const float f7 = f[5] - (float)(1.0 / 6.0) * ru + 0.5f * (f[2] - f[4]);
    const float f6 = f[8] - (float)(1.0 / 6.0) * ru + 0.5f * (f[4] - f[2]);
    f[7] = f7;
    f[6] = f6;
  }
}

// the MRT collision (models/d2q9.py:_collision_mrt) with its objectives
template <class Ctx>
__device__ __forceinline__ void collide(Ctx& c, float* f) {
  const float rho = combo([](int) { return 1.f; }, f);
  const float ux = combo([](int k) { return (float)ex(k); }, f) / rho;
  const float uy = combo([](int k) { return (float)ey(k); }, f) / rho;
  const float usq = ux * ux + uy * uy;
  const bool inlet = c.nt_is(T_Inlet), outlet = c.nt_is(T_Outlet);
  if (inlet || outlet) {
    const float flux = ux / rho;
    const float ploss = ux / rho * ((rho - 1.f) * (1.f / 3.f)
                                    + usq / rho * 0.5f);
    c.add_global(outlet ? GL_OutletFlux : GL_InletFlux, flux);
    c.add_global(GL_PressureLoss, inlet ? ploss : -ploss);
  }
  // relax the non-equilibrium moments 3..8 (the conserved moments relax
  // at rate 0 and drop out)
  float feq[9], d[9], m[9];
  equilibrium(rho, ux, uy, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = f[k] - feq[k];
  const float rate[9] = {0.f, 0.f, 0.f, c.setting(S_S3), c.setting(S_S4),
                         c.setting(S_S56), c.setting(S_S56),
                         c.setting(S_S78), c.setting(S_S78)};
#pragma unroll
  for (int r = 3; r < 9; ++r)
    m[r] = combo([r](int k) { return (float)basis(r, k); }, d) * rate[r];
  // Minv m_neq + feq(u + g + BC) (== Minv (m_neq + M feq2))
  const float ux2 = ux + c.setting(S_GravitationX) + c.pulled(BC0);
  const float uy2 = uy + c.setting(S_GravitationY) + c.pulled(BC1);
  equilibrium(rho, ux2, uy2, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    f[k] = combo([k](int r) { return (float)(basis(r, k) / norm(r)); }, m,
                 3) + feq[k];
}

// stage 0, Run: the boundary case of the node's type, then the collision
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  if (c.nt_in_group(G_BOUNDARY)) {
    if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) g[k] = f[opp(k)];
#pragma unroll
      for (int k = 0; k < 9; ++k) f[k] = g[k];
    } else if (c.nt_is(T_EVelocity)) {
      zou_he_x<false, true>(f, c.zonal(Z_Velocity));
    } else if (c.nt_is(T_WPressure)) {
      zou_he_x<true, false>(f, c.zonal(Z_Density));
    } else if (c.nt_is(T_WVelocity)) {
      zou_he_x<true, true>(f, c.zonal(Z_Velocity));
    } else if (c.nt_is(T_EPressure)) {
      zou_he_x<false, false>(f, c.zonal(Z_Density));
    } else if (c.nt_is(T_TopSymmetry)) {
      // the wall above: the downward populations mirror the upward ones
      f[4] = f[2];
      f[7] = f[6];
      f[8] = f[5];
    } else if (c.nt_is(T_BottomSymmetry)) {
      f[2] = f[4];
      f[5] = f[8];
      f[6] = f[7];
    }
  }
  if (c.nt_is(T_MRT)) collide(c, f);
#pragma unroll
  for (int k = 0; k < 9; ++k) c.store(k, f[k]);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  static_assert(S == 0, "d2q9's Iteration is one stage");
  run(c);
}

}  // namespace model
