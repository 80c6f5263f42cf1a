// d2q9_kuper_adj device physics for the generic 2D kernels
// (csrc/generic2d.cu, csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_kuper_adj.py: the
// forward is csrc/models/d2q9_kuper.cuh built with KUPER_DESIGN (the
// design density wd, a plane no stage writes, scales the phi CalcPhi
// writes), and the hand-written reverses of its two stages are here:
// stage_b<0> (Run: the boundary cases, the MRT collision with the
// Kupershtokh force from phi over the psi stencil, the wall-force globals)
// and stage_b<1> (CalcPhi: phi = FAcc sqrt(max(rho/3 - p(rho), 0)) wd).
// Each is the exact derivative of its forward's arithmetic in another
// order.  Where rho/3 - p <= 0 the clamp engages and stage_b<1> gives phi
// no cotangent (0), as the port's eager model does (torch.clamp); the
// JAX package's derivative is NaN there, so a gradient is defined only
// where rho/3 - p > 0.  Density is zonal: no settings cotangent flows to
// it (nor from the boundary nodes that take it for rho).
//
// Run reads phi through c.load at its node and its eight neighbours; the
// node's own read is a pull of phi (offset 0), the eight others are the
// reads b_loads(0) lists, whose cotangents stage_b<0> returns through
// c.set_load(j, v) (generic2d_adjoint.cuh gathers them).
//
// The enums are d2q9_kuper.cuh's (the registry entries are the same);
// tclb_tpu_torch/ops/generic_kernels.py lists them in DEVICE_MODELS, and a
// CPU test checks this build's tables against that list and the model.

#pragma once

// generic2d.cu builds generic2d_step_b's two-stage reverse for this model
#define TCLB_MODEL_ADJOINT 1
#define KUPER_DESIGN 1

#include "d2q9_kuper.cuh"

namespace model {

// Run's Field reads the reverse returns: phi at -e_i for i = 1..8, read j
// at direction i = j + 1 (CalcPhi reads none)
__host__ __device__ constexpr int b_loads(int s) { return s == 0 ? 8 : 0; }
__host__ __device__ constexpr int load_k(int, int) { return PHI; }
__host__ __device__ constexpr int load_dx(int, int j) { return -ex(j + 1); }
__host__ __device__ constexpr int load_dy(int, int j) { return -ey(j + 1); }

// transposes of the two bases (models/d2q9_kuper.py: mneq = M d, out =
// Minv mneq + feq2): a_k = sum_r M[r][k] am_r, am_r = sum_k Minv[k][r] a_k
__device__ __forceinline__ void from_moments_b(const float* a, float* am) {
#pragma unroll
  for (int r = 0; r < 9; ++r)
    am[r] = combo([r](int k) { return (float)(basis(r, k) / norm(r)); }, a);
}

__device__ __forceinline__ void moments_b(const float* am, float* a) {
#pragma unroll
  for (int k = 0; k < 9; ++k)
    a[k] = combo([k](int r) { return (float)basis(r, k); }, am);
}

// reverse of equilibrium: adds the cotangents of rho, ux and uy given
// those of the nine outputs
__device__ __forceinline__ void equilibrium_b(float rho, float ux, float uy,
                                              const float* a, float& arho,
                                              float& aux, float& auy) {
  const float usq = ux * ux + uy * uy;
  float ausq = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float w = (float)wd(k);
    if (k == 0) {
      arho += a[k] * w * (1.f - 1.5f * usq);
      ausq -= 1.5f * a[k] * w * rho;
      continue;
    }
    float eu;
    if (ex(k) == 0) eu = ey(k) > 0 ? uy : -uy;
    else if (ey(k) == 0) eu = ex(k) > 0 ? ux : -ux;
    else eu = (ex(k) > 0 ? ux : -ux) + (ey(k) > 0 ? uy : -uy);
    const float ac = a[k] * w * rho;
    arho += a[k] * w * (1.f + 3.f * eu + 4.5f * eu * eu - 1.5f * usq);
    ausq -= 1.5f * ac;
    const float aeu = ac * (3.f + 9.f * eu);
    if (ex(k)) aux += ex(k) > 0 ? aeu : -aeu;
    if (ey(k)) auy += ey(k) > 0 ? aeu : -aeu;
  }
  aux += 2.f * ux * ausq;
  auy += 2.f * uy * ausq;
}

// reverse of stage 0, Run: the cotangents of the pulled f, of phi at the
// node (a pull) and at its eight neighbours (the reads), and of the
// settings, given those of f's outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  float f[9], g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  const bool wall = c.nt_is(T_Wall);
  const bool bounce = wall || c.nt_is(T_Solid);
  const bool moving = !bounce && c.nt_is(T_MovingWall);
  const bool mirror = !bounce && !moving
                      && (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry));
  const float mwv = c.setting(S_MovingWallVelocity);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    g[k] = bounce ? f[opp(k)]
           : moving ? (ex(k) ? f[opp(k)] + (float)(6.0 * wd(k) * ex(k)) * mwv
                             : f[opp(k)])
           : mirror ? f[mirror_y(k)] : f[k];
  float ag[9];
  float aphi0 = 0.f;
  float aload[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) aload[j] = 0.f;
  const float lwx = c.lam_global(GL_WallForceX);
  const float lwy = c.lam_global(GL_WallForceY);
  if (!c.nt_in_group(G_COLLISION)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      ag[k] = c.lam(k);
      if (wall) {
        if (ex(k)) ag[k] += ex(k) > 0 ? lwx : -lwx;
        if (ey(k)) ag[k] += ey(k) > 0 ? lwy : -lwy;
      }
    }
  } else {
    // the forward up to the force
    const float rho = rho_of(g);
    const float jx = combo([](int k) { return (float)ex(k); }, g);
    const float jy = combo([](int k) { return (float)ey(k); }, g);
    const float ux = jx / rho, uy = jy / rho;
    float feq[9], d[9], mraw[9];
    equilibrium(rho, ux, uy, feq);
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k] = g[k] - feq[k];
    moments(d, mraw);
    const float ma = c.setting(S_MagicA);
    const float mb = 1.f - 2.f * ma;
    const float phi0 = c.load(PHI, 0, 0);
    float phis[9];
    float fxr = 0.f, fyr = 0.f;
    bool fx0 = true, fy0 = true;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      phis[i] = c.load(PHI, -ex(i), -ey(i));
      const float r = ma * phis[i] * phis[i] + mb * phis[i] * phi0;
      const float gr = gs(i) * r;
      if (ex(i)) {
        const float t = ex(i) > 0 ? gr : -gr;
        fxr = fx0 ? 0.f + t : fxr + t;
        fx0 = false;
      }
      if (ey(i)) {
        const float t = ey(i) > 0 ? gr : -gr;
        fyr = fy0 ? 0.f + t : fyr + t;
        fy0 = false;
      }
    }
    const float scale = c.setting(S_MagicF);
    float fx = scale * fxr, fy = scale * fyr;
    if (wall) {
      fx = fx + 2.f * jx;
      fy = fy + 2.f * jy;
    }
    const float ux2 = ux + fx / rho + c.setting(S_GravitationX);
    const float uy2 = uy + fy / rho + c.setting(S_GravitationY);
    // out = Minv (S . mraw) + feq2(rho, ux2, uy2)
    float a[9], am[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) a[k] = c.lam(k);
    from_moments_b(a, am);
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      c.add_setting(S_S0 + r, am[r] * mraw[r]);
      am[r] = am[r] * c.setting(S_S0 + r);
    }
    float ad[9];
    moments_b(am, ad);
    float arho = 0.f, aux = 0.f, auy = 0.f, aux2 = 0.f, auy2 = 0.f;
    equilibrium_b(rho, ux2, uy2, a, arho, aux2, auy2);
    float afeq[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) afeq[k] = -ad[k];
    equilibrium_b(rho, ux, uy, afeq, arho, aux, auy);
    // ux2 = ux + fx / rho + gx
    aux += aux2;
    auy += auy2;
    c.add_setting(S_GravitationX, aux2);
    c.add_setting(S_GravitationY, auy2);
    const float afx = aux2 / rho, afy = auy2 / rho;
    arho -= (aux2 * fx + auy2 * fy) / (rho * rho);
    // fx = MagicF fxr (+ 2 jx on a Wall node, whose globals add jx, jy)
    float ajx = 0.f, ajy = 0.f;
    if (wall) {
      ajx = 2.f * afx + lwx;
      ajy = 2.f * afy + lwy;
    }
    c.add_setting(S_MagicF, afx * fxr + afy * fyr);
    const float afxr = afx * scale, afyr = afy * scale;
    // fxr = sum_i ex_i gs_i r_i, r_i = a phi_i^2 + (1 - 2 a) phi_i phi0
    float ama = 0.f;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      float ar = 0.f;
      if (ex(i)) ar += ex(i) > 0 ? afxr : -afxr;
      if (ey(i)) ar += ey(i) > 0 ? afyr : -afyr;
      ar = ar * gs(i);
      aload[i - 1] = ar * (2.f * ma * phis[i] + mb * phi0);
      aphi0 += ar * mb * phis[i];
      ama += ar * (phis[i] * phis[i] - 2.f * phis[i] * phi0);
    }
    c.add_setting(S_MagicA, ama);
    // u = j / rho, rho = sum g
    ajx += aux / rho;
    ajy += auy / rho;
    arho -= (aux * ux + auy * uy) / rho;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float t = ad[k] + arho;
      if (ex(k)) t += ex(k) > 0 ? ajx : -ajx;
      if (ey(k)) t += ey(k) > 0 ? ajy : -ajy;
      ag[k] = t;
    }
  }
  // the boundary cases (each an involution of the planes)
  if (moving) {
    float amwv = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (ex(k)) amwv += (float)(6.0 * wd(k) * ex(k)) * ag[k];
    c.add_setting(S_MovingWallVelocity, amwv);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    c.set_q(k, (bounce || moving) ? ag[opp(k)]
               : mirror ? ag[mirror_y(k)] : ag[k]);
  c.set_q(WD, 0.f);
  c.set_q(PHI, aphi0);
#pragma unroll
  for (int j = 0; j < 8; ++j) c.set_load(j, aload[j]);
}

// reverse of stage 1, CalcPhi: the cotangents of the pulled f (stage 0's
// output), of wd and of the settings, given phi's
template <class Ctx>
__device__ __forceinline__ void calc_phi_b(Ctx& c) {
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  const bool fixed = c.nt_in_group(G_BOUNDARY)
                     && !(c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry));
  const float rho = fixed ? c.zonal(Z_Density) : rho_of(f);
  const float t = c.setting(S_Temperature), magic = c.setting(S_Magic);
  const float facc = c.setting(S_FAcc);
  const float br = (float)B2 * rho * 0.25f;
  const float om = 1.f - br;
  const float poly = -(br * br * br) + br * br + br + 1.f;
  const float num = rho * poly * t * (float)C2;
  const float den = om * om * om;
  const float eos = num / den - (float)A2 * rho * rho;
  const float x = rho * (1.f / 3.f) - magic * eos;
  const float root = sqrtf(x > 0.f ? x : 0.f);
  const float wd_ = c.pulled(WD);
  const float aphi = c.lam(PHI);
  // phi = (FAcc root) wd
  c.set_q(WD, aphi * (facc * root));
  c.add_setting(S_FAcc, aphi * wd_ * root);
  // d root / dx = 1 / (2 root) where x > 0, else 0 (the clamp)
  const float ax = x > 0.f ? aphi * wd_ * facc * 0.5f / root : 0.f;
  // x = rho / 3 - Magic eos
  c.add_setting(S_Magic, -ax * eos);
  const float aeos = -ax * magic;
  // eos = num / den - A2 rho^2, num = rho poly T C2, den = (1 - br)^3
  const float anum = aeos / den;
  const float aden = -aeos * num / (den * den);
  c.add_setting(S_Temperature, anum * rho * poly * (float)C2);
  const float apoly = anum * rho * t * (float)C2;
  const float abr = apoly * (-3.f * br * br + 2.f * br + 1.f)
                    - aden * 3.f * om * om;
  const float arho = ax * (1.f / 3.f) - aeos * 2.f * (float)A2 * rho
                     + anum * poly * t * (float)C2
                     + abr * (float)B2 * 0.25f;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.set_q(k, fixed ? 0.f : arho);
  c.set_q(PHI, 0.f);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage_b(Ctx& c) {
  if constexpr (S == 0) run_b(c);
  else calc_phi_b(c);
}

}  // namespace model
