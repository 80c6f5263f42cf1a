// d2q9_lee device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_lee.py's Iteration
// action, op for op in its order (d2q9_common.cuh's conventions):
//
//   stage 0, BaseIteration  the boundary case (bounce-back walls, the
//                           moving lid, Zou/He faces, the equilibrium inlet
//                           with the Wet/Dry densities), then at a BGK or
//                           MRT node Lee's collision: per direction the
//                           biased and central projections of the Fields
//                           rho and nu (read over +-2), the central one in
//                           the velocity and the pre-collision shift, the
//                           biased one after relaxation; Mass, MomentumX
//                           and MomentumY sum the collision nodes.
//   stage 1, CalcRho        rho = the streamed f's density, with the wall
//                           and pressure-face overrides.
//   stage 2, CalcNu         nu = mu0(rho) - Kappa lap(rho) (no streaming).
//
// The plan [(BaseIteration, 4), (CalcRho, 2), (CalcNu, 0)] runs one pass a
// stage.  Written against the template's node context (see
// d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: f[0..8] over the d2q9 velocity set, then the Fields rho
// and nu
constexpr int N_STORAGE = 11;
constexpr int F = 0, RHO = 9, NU = 10;
__host__ __device__ constexpr int ex(int k) {
  return k < RHO ? d2q9::vx(k) : 0;
}
__host__ __device__ constexpr int ey(int k) {
  return k < RHO ? d2q9::vy(k) : 0;
}

// the Iteration action: stage 0 writes f, stage 1 rho, stage 2 nu;
// stage_ext is generic_kernels.action_plan's ring
constexpr int N_STAGES = 3;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x1ffu : (s == 1 ? 1u << RHO : 1u << NU);
}
__host__ __device__ constexpr int stage_ext(int s) {
  return s == 0 ? 4 : (s == 1 ? 2 : 0);
}

enum Setting {
  S_omega, S_nu, S_InletVelocity, S_InletPressure, S_InletDensity,
  S_OutletDensity, S_InitDensity, S_WallDensity, S_GravitationY,
  S_GravitationX, S_MovingWallVelocity, S_WetDensity, S_DryDensity,
  S_Wetting, S_LiquidDensity, S_VaporDensity, S_Beta, S_Kappa,
  S_MomentumXInObj, S_MomentumYInObj, S_MassInObj, N_SETTINGS
};
enum NodeType {
  T_Wet, T_Dry, T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
  T_EVelocity, T_MovingWall, T_ForcedMovingWall, T_BGK, T_MRT, N_TYPES
};
enum Group { G_COLLISION, N_GROUPS };
enum Zonal {
  Z_InletVelocity, Z_InletPressure, Z_InletDensity, Z_OutletDensity,
  Z_InitDensity, Z_WallDensity, Z_MovingWallVelocity, Z_WetDensity,
  Z_DryDensity, Z_Wetting, N_ZONAL
};
enum Global { GL_MomentumX, GL_MomentumY, GL_Mass, N_GLOBALS };

constexpr double CS2 = 1.0 / 3.0;

// the double-well bulk chemical potential (_mu0)
template <class Ctx>
__device__ __forceinline__ float mu0(const Ctx& c, float r) {
  const float rl = c.setting(S_LiquidDensity);
  const float rv = c.setting(S_VaporDensity);
  return 2.f * c.setting(S_Beta) * (r - rl) * (r - rv)
         * (2.f * r - rv - rl);
}

// F = sum_i (w_i / cs2) proj_i e_i (_vec_of)
__device__ __forceinline__ void vec_of(const float* proj, float& fx,
                                       float& fy) {
  fx = d2q9::combo(
      [](int k) { return (float)(d2q9::wd(k) / CS2 * d2q9::vx(k)); }, proj);
  fy = d2q9::combo(
      [](int k) { return (float)(d2q9::wd(k) / CS2 * d2q9::vy(k)); }, proj);
}

// d, j, the velocity with the half central force and the biased (fb) and
// central (fcp) projections (_fill and _projections)
template <class Ctx>
__device__ __forceinline__ void fill(const Ctx& c, const float* f, float& d,
                                     float& jx, float& jy, float& ux,
                                     float& uy, float* fb, float* fcp) {
  d = d2q9::sum9(f);
  jx = d2q9::jx(f);
  jy = d2q9::jy(f);
  const float u0 = jx / d, u1 = jy / d;
  const float gx = c.setting(S_GravitationX);
  const float gy = c.setting(S_GravitationY);
  const float ug = u0 * gx + u1 * gy;
  const float r0 = c.load(RHO, 0, 0), n0 = c.load(NU, 0, 0);
  const bool fmw = c.nt_is(T_ForcedMovingWall);
  const float gx2 = (c.zonal(Z_MovingWallVelocity) - u0) * d;
  const float gy2 = (0.f - u1) * d;
  const float ug2 = u0 * gx2 + u1 * gy2;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dx = d2q9::vx(k), dy = d2q9::vy(k);
    const float eg = (float)dx * gx + (float)dy * gy;
    if (k == 0) {
      fb[k] = 0.f + eg - ug;
      fcp[k] = 0.f + eg - ug;
    } else {
      const float r1 = c.load(RHO, dx, dy), r2 = c.load(RHO, 2 * dx, 2 * dy);
      const float rm = c.load(RHO, -dx, -dy);
      const float n1 = c.load(NU, dx, dy), n2 = c.load(NU, 2 * dx, 2 * dy);
      const float nm = c.load(NU, -dx, -dy);
      const float grad_b = 0.5f * (-r2 + 4.f * r1 - 3.f * r0) * (float)CS2
                           - d * 0.5f * (-n2 + 4.f * n1 - 3.f * n0);
      const float grad_c = 0.5f * (r1 - rm) * (float)CS2
                           - d * 0.5f * (n1 - nm);
      fb[k] = grad_b + eg - ug;
      fcp[k] = grad_c + eg - ug;
    }
    if (fmw) {
      const float extra = (float)dx * gx2 + (float)dy * gy2 - ug2;
      fb[k] = fb[k] + extra;
      fcp[k] = fcp[k] + extra;
    }
  }
  float fcx, fcy;
  vec_of(fcp, fcx, fcy);
  ux = (jx + 0.5f * fcx) / d;
  uy = (jy + 0.5f * fcy) / d;
}

// force(): feq_i (proj_i - u.F) / (d cs2) (_force_term)
__device__ __forceinline__ float force_term(float feq, float d, float proj,
                                            float uf) {
  return feq * (proj - uf) / (d * (float)CS2);
}

// stage 0, BaseIteration
template <class Ctx>
__device__ __forceinline__ void base_iteration(Ctx& c) {
  float f[9];
  d2q9::pull<F>(c, f);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
    d2q9::bounce(f);
  } else if (c.nt_is(T_MovingWall)) {
    // the lid at the bottom of the fluid: f2, f5 and f6 rebuilt
    const float rho = f[0] + f[1] + f[3] + 2.f * (f[7] + f[4] + f[8]);
    const float ru = rho * c.zonal(Z_MovingWallVelocity);
    const float f6 = f[8] - 0.5f * ru - 0.5f * (f[3] - f[1]);
    const float f5 = f[7] + 0.5f * ru + 0.5f * (f[3] - f[1]);
    f[2] = f[4];
    f[5] = f5;
    f[6] = f6;
  } else if (c.nt_is(T_EVelocity)) {
    d2q9::zou_he_x<false, true>(f, c.zonal(Z_InletVelocity));
  } else if (c.nt_is(T_WPressure)) {
    d2q9::zou_he_x<true, false>(f, c.zonal(Z_InletDensity));
  } else if (c.nt_is(T_WVelocity)) {
    // the equilibrium inlet with the Wet/Dry densities
    float rho2 = c.zonal(Z_InletDensity);
    if (c.nt_is(T_Wet)) rho2 = c.zonal(Z_WetDensity);
    if (c.nt_is(T_Dry)) rho2 = c.zonal(Z_DryDensity);
    d2q9::equilibrium(rho2, c.zonal(Z_InletVelocity), 0.f, f);
  } else if (c.nt_is(T_EPressure)) {
    d2q9::zou_he_x<false, false>(f, c.zonal(Z_OutletDensity));
  }
  if (c.nt_in_group(G_COLLISION)) {
    float d, jx, jy, ux, uy, fb[9], fcp[9], fcx, fcy, fbx, fby, feq[9];
    fill(c, f, d, jx, jy, ux, uy, fb, fcp);
    vec_of(fcp, fcx, fcy);
    vec_of(fb, fbx, fby);
    c.add_global(GL_Mass, d);
    c.add_global(GL_MomentumX, jx + 0.5f * fcx);
    c.add_global(GL_MomentumY, jy + 0.5f * fcy);
    d2q9::equilibrium(d, ux, uy, feq);
    const float omega = c.setting(S_omega);
    const float ufc = ux * fcx + uy * fcy;
    const float ufb = ux * fbx + uy * fby;
    if (c.nt_is(T_BGK)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float fneq = f[k] - (feq[k] - 0.5f * force_term(feq[k], d,
                                                              fcp[k], ufc));
        f[k] = (1.f - omega) * fneq + feq[k]
               + 0.5f * force_term(feq[k], d, fb[k], ufb);
      }
    } else if (c.nt_is(T_MRT)) {
      // the reference's literal (S - 1) rates
      float f2[9], m[9], meq[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        f2[k] = f[k] + 0.5f * force_term(feq[k], d, fcp[k], ufc);
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        m[r] = d2q9::combo([r](int k) { return (float)d2q9::basis(r, k); },
                           f2);
        meq[r] = d2q9::combo(
            [r](int k) { return (float)d2q9::basis(r, k); }, feq);
      }
#pragma unroll
      for (int r = 3; r < 9; ++r) {
        const float rate = r == 3 ? (float)(4.0 / 3.0 - 1.0)
                           : r < 7 ? 0.f : omega - 1.f;
        m[r] = (m[r] - meq[r]) * rate + meq[r];
      }
#pragma unroll
      for (int k = 0; k < 9; ++k)
        f[k] = d2q9::combo(
                   [k](int r) {
                     return (float)(d2q9::basis(r, k) / d2q9::norm(r));
                   },
                   m)
               + 0.5f * force_term(feq[k], d, fb[k], ufb);
    }
  }
  d2q9::store<F>(c, f);
}

// stage 1, CalcRho
template <class Ctx>
__device__ __forceinline__ void calc_rho(Ctx& c) {
  float f[9];
  d2q9::pull<F>(c, f);
  float rho = d2q9::sum9(f);
  const bool wallish = c.nt_is(T_Wall) || c.nt_is(T_MovingWall);
  if (wallish) {
    rho = c.zonal(Z_WallDensity);
    if (c.nt_is(T_Wet)) rho = c.zonal(Z_WetDensity);
    if (c.nt_is(T_Dry)) rho = c.zonal(Z_DryDensity);
  }
  if (c.nt_is(T_EPressure)) rho = c.zonal(Z_OutletDensity);
  if (c.nt_is(T_WPressure)) rho = c.zonal(Z_InletDensity);
  c.store(RHO, rho);
}

// stage 2, CalcNu: lap = sum_i (w_i/cs2)(rho(e_i) - 2 rho + rho(-e_i))
template <class Ctx>
__device__ __forceinline__ void calc_nu(Ctx& c) {
  const float r0 = c.load(RHO, 0, 0);
  float lap = 0.f;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const int dx = d2q9::vx(k), dy = d2q9::vy(k);
    const float t = (float)(d2q9::wd(k) / CS2)
                    * (c.load(RHO, dx, dy) - 2.f * r0 + c.load(RHO, -dx, -dy));
    lap = k == 1 ? t : lap + t;
  }
  c.store(NU, mu0(c, r0) - c.setting(S_Kappa) * lap);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) base_iteration(c);
  else if constexpr (S == 1) calc_rho(c);
  else calc_nu(c);
}

}  // namespace model
