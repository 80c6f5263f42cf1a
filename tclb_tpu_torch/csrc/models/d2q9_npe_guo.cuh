// d2q9_npe_guo device physics for the generic 2D kernels
// (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_npe_guo.py's Iteration
// action (one stage, Run), op for op in its order (d2q9_common.cuh's
// conventions): the boundary case of the node's type on each of the five
// d2q9 groups (walls: bounce-back of phi and f, the zeta potential's and
// the Boltzmann ion densities' equilibria for g, h_0 and h_1 with expf;
// pressure faces: Zou/He on f, the Dirichlet phi_bc; the symmetry
// mirrors), then Guo's Poisson collisions of g and phi, the ion
// collisions with the electro-migration source and the fluid BGK with the
// electric body force.
//
// 45 planes do not fit a thread's registers next to the collision's
// temporaries, so a collision node takes two passes over the groups, each
// holding one group of nine: the first reads each group (after its
// boundary case) for its moments (rho, n0, n1, psi, the external
// potential, both gradients), the second reads each again, collides it and
// stores it.  The second reads hit L1 or L2.  A node without a collision
// stores its boundary-cased groups in one pass.  Written against the
// template's node context (see d2q9_heat_physics.cuh for the list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

#include "d2q9_common.cuh"

namespace model {

// storage planes: five groups of the d2q9 velocity set, in the order phi,
// g, f, h_0, h_1
constexpr int N_STORAGE = 45;
constexpr int PHI = 0, GP = 9, F = 18, H0 = 27, H1 = 36;
__host__ __device__ constexpr int ex(int k) { return d2q9::vx(k % 9); }
__host__ __device__ constexpr int ey(int k) { return d2q9::vy(k % 9); }

// the Iteration action: one stage (Run) that writes every plane
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned long long all_planes() {
  return (1ull << N_STORAGE) - 1;
}
__host__ __device__ constexpr unsigned long long stage_writes(int) {
  return all_planes();
}
__host__ __device__ constexpr int stage_ext(int) { return 0; }
// the rows of input the plan reads beyond the output (action_plan's
// reach: the pulls), which the tiled form stages
constexpr int REACH = 1;

enum Setting {
  S_n_inf_0, S_n_inf_1, S_el, S_el_kbT, S_epsilon, S_dt, S_psi0, S_phi0,
  S_ez, S_Ex, S_D, S_nu, S_rho_bc, S_phi_bc, S_psi_bc, S_t_to_s,
  S_TotalMomentumInObj, N_SETTINGS
};
enum NodeType {
  T_Wall, T_Solid, T_WPressure, T_EPressure, T_BottomSymmetry,
  T_TopSymmetry, N_TYPES
};
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_rho_bc, Z_phi_bc, Z_psi_bc, N_ZONAL };
enum Global { GL_TotalMomentum, N_GLOBALS };

// Guo's Poisson weights (models/guo_poisson.py: WP, WPS)
__host__ __device__ constexpr double wp(int k) {
  return k == 0 ? 1.0 / 9.0 - 1.0 : 1.0 / 9.0;
}
constexpr double WPS = 1.0 / 8.0;     // the source weight of k > 0

// the node's boundary case (the dict order of models/d2q9_npe_guo.py:run)
enum Case { C_NONE, C_WALL, C_WPRESSURE, C_EPRESSURE, C_BOTTOM, C_TOP };

template <class Ctx>
__device__ __forceinline__ Case case_of(const Ctx& c) {
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) return C_WALL;
  if (c.nt_is(T_WPressure)) return C_WPRESSURE;
  if (c.nt_is(T_EPressure)) return C_EPRESSURE;
  if (c.nt_is(T_BottomSymmetry)) return C_BOTTOM;
  if (c.nt_is(T_TopSymmetry)) return C_TOP;
  return C_NONE;
}

// q <- w_k v (lbm.wstack)
template <class Wt>
__device__ __forceinline__ void wstack(float* q, Wt wt, float v) {
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = (float)wt(k) * v;
}

// the group whose first plane is B, streamed to the node, after the
// node's boundary case
template <int B, class Ctx>
__device__ __forceinline__ void cased(const Ctx& c, Case cs, float* q) {
  d2q9::pull<B>(c, q);
  const auto w = [](int k) { return d2q9::wd(k); };
  if (cs == C_WALL) {
    if (B == PHI || B == F) {
      d2q9::bounce(q);
    } else if (B == GP) {
      wstack(q, wp, c.zonal(Z_psi_bc));
    } else {
      const float psi_bc = c.zonal(Z_psi_bc);
      const float ez = c.setting(S_ez), kbt = c.setting(S_el_kbT);
      if (B == H0)
        wstack(q, w, c.setting(S_n_inf_0) * expf(-ez * psi_bc * kbt));
      else
        wstack(q, w, c.setting(S_n_inf_1) * expf(ez * psi_bc * kbt));
    }
  } else if (cs == C_WPRESSURE || cs == C_EPRESSURE) {
    if (B == PHI) {
      wstack(q, wp, c.zonal(Z_phi_bc));
    } else if (B == GP) {
      d2q9::bounce(q);
    } else if (B == F) {
      if (cs == C_WPRESSURE)
        d2q9::zou_he_x<true, false>(q, c.zonal(Z_rho_bc));
      else
        d2q9::zou_he_x<false, false>(q, 1.f);
    } else {
      wstack(q, w, c.setting(B == H0 ? S_n_inf_0 : S_n_inf_1));
    }
  } else if (cs == C_BOTTOM) {
    q[2] = q[4];
    q[6] = q[7];
    q[5] = q[8];
  } else if (cs == C_TOP) {
    q[4] = q[2];
    q[7] = q[6];
    q[8] = q[5];
  }
}

// psi of the solver populations (guo_poisson.psi_of: / (1 - 1/9) as a
// multiply by 1.125)
__device__ __forceinline__ float psi_of(const float* g) {
  float s = g[1];
#pragma unroll
  for (int k = 2; k < 9; ++k) s = s + g[k];
  return s * 1.125f;
}

// -(3/2) sum_i (g_i - wp_i pot) e_i (models/d2q9_npe_guo.py:_grad_of)
__device__ __forceinline__ void grad_of(const float* g, float pot,
                                        float& gx, float& gy) {
  gx = gy = 0.f;
  bool fx = true, fy = true;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float d = g[k] - (float)wp(k) * pot;
    if (d2q9::vx(k)) {
      const float t = d2q9::vx(k) > 0 ? d : -d;
      gx = fx ? t : gx + t;
      fx = false;
    }
    if (d2q9::vy(k)) {
      const float t = d2q9::vy(k) > 0 ? d : -d;
      gy = fy ? t : gy + t;
      fy = false;
    }
  }
  gx = -1.5f * gx;
  gy = -1.5f * gy;
}

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Case cs = case_of(c);
  float q[9];
  if (!c.nt_in_group(G_COLLISION)) {
    cased<PHI>(c, cs, q);
    d2q9::store<PHI>(c, q);
    cased<GP>(c, cs, q);
    d2q9::store<GP>(c, q);
    cased<F>(c, cs, q);
    d2q9::store<F>(c, q);
    cased<H0>(c, cs, q);
    d2q9::store<H0>(c, q);
    cased<H1>(c, cs, q);
    d2q9::store<H1>(c, q);
    return;
  }
  // pass 1: the moments (models/d2q9_npe_guo.py:_macro)
  float gphix, gphiy, gpsix, gpsiy;
  cased<PHI>(c, cs, q);
  const float pot = psi_of(q);
  grad_of(q, pot, gphix, gphiy);
  cased<GP>(c, cs, q);
  const float psi = psi_of(q);
  grad_of(q, psi, gpsix, gpsiy);
  cased<F>(c, cs, q);
  const float rho = d2q9::sum9(q);
  const float jx = d2q9::jx(q), jy = d2q9::jy(q);
  cased<H0>(c, cs, q);
  const float n0 = d2q9::sum9(q);
  cased<H1>(c, cs, q);
  const float n1 = d2q9::sum9(q);
  const float rho_e = c.setting(S_el) * c.setting(S_ez) * (n0 - n1);
  const float ts = c.setting(S_t_to_s);
  const float fx = -gphix * rho_e / rho * ts * ts;
  const float fy = -gphiy * rho_e / rho * ts * ts;
  const float ux = jx / rho, uy = jy / rho;
  // the measured velocity (half the force) enters the ion equilibria
  const float umx = ux + fx * 0.5f, umy = uy + fy * 0.5f;
  const float d_ion = c.setting(S_D);
  const float tau_d = 3.f * d_ion + 0.5f;
  const float bk = 3.f * d_ion / tau_d * c.setting(S_el_kbT);
  const float ez = c.setting(S_ez);

  // pass 2: collide each group and store it
  cased<PHI>(c, cs, q);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    q[k] = q[k] - (q[k] - (float)wp(k) * pot) * 1.f;
  d2q9::store<PHI>(c, q);

  cased<GP>(c, cs, q);
  const float dt = c.setting(S_dt);
  const float rd = (float)(-2.0 / 3.0 * (0.5 - 1.0)) * dt * rho_e
                   / c.setting(S_epsilon);
  q[0] = q[0] - (q[0] - (float)wp(0) * psi) * 1.f;
#pragma unroll
  for (int k = 1; k < 9; ++k)
    q[k] = q[k] - (q[k] - (float)wp(k) * psi) * 1.f
           + (dt * (float)WPS) * rd;
  d2q9::store<GP>(c, q);

  cased<F>(c, cs, q);
  {
    const float omega = 1.f / (3.f * c.setting(S_nu) + 0.5f);
    float feq[9], feq2[9];
    d2q9::equilibrium(rho, ux, uy, feq);
    d2q9::equilibrium(rho, ux + fx, uy + fy, feq2);
#pragma unroll
    for (int k = 0; k < 9; ++k)
      q[k] = q[k] - omega * (q[k] - feq[k]) + (feq2[k] - feq[k]);
  }
  d2q9::store<F>(c, q);

  // the ions: w_i n (1 - e.u / cs2) and -+ w_i ez (e.gradPsi) n B
  cased<H0>(c, cs, q);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float ex_ = (float)d2q9::vx(k), ey_ = (float)d2q9::vy(k);
    const float cu = ex_ * umx + ey_ * umy;
    const float S = ex_ * gpsix + ey_ * gpsiy;
    const float heq = (float)d2q9::wd(k) * n0 * (1.f - cu * 3.f);
    q[k] = q[k] - (q[k] - heq) / tau_d
           - (float)d2q9::wd(k) * ez * S * n0 * bk;
  }
  d2q9::store<H0>(c, q);
  cased<H1>(c, cs, q);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float ex_ = (float)d2q9::vx(k), ey_ = (float)d2q9::vy(k);
    const float cu = ex_ * umx + ey_ * umy;
    const float S = ex_ * gpsix + ey_ * gpsiy;
    const float heq = (float)d2q9::wd(k) * n1 * (1.f - cu * 3.f);
    q[k] = q[k] - (q[k] - heq) / tau_d
           + (float)d2q9::wd(k) * ez * S * n1 * bk;
  }
  d2q9::store<H1>(c, q);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  static_assert(S == 0, "d2q9_npe_guo's Iteration is one stage");
  run(c);
}

}  // namespace model
