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

namespace model {

// storage planes: f[0..18] over the d3q19 velocity set (models/d3q19.py,
// shell-ordered), then the design density w, which does not stream
constexpr int Q = 19;
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

// lattice weights, bounce-back pairs and the y mirror of the symmetry
// faces (models/d3q19.py, models/family.py:mirror_perm)
__host__ __device__ constexpr double wd(int k) {
  constexpr double t[Q] = {1.0 / 3, 1.0 / 18, 1.0 / 18, 1.0 / 18, 1.0 / 18,
                           1.0 / 18, 1.0 / 18, 1.0 / 36, 1.0 / 36, 1.0 / 36,
                           1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36,
                           1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36};
  return t[k];
}
__host__ __device__ constexpr int opp(int k) {
  constexpr int t[Q] = {0, 2, 1, 4, 3, 6, 5, 10, 9, 8,
                        7, 14, 13, 12, 11, 18, 17, 16, 15};
  return t[k];
}
__host__ __device__ constexpr int mirror_y(int k) {
  constexpr int t[Q] = {0, 1, 2, 4, 3, 5, 6, 8, 7, 10,
                        9, 11, 12, 13, 14, 17, 18, 15, 16};
  return t[k];
}

// the stress rows 4..9 of the Gram-Schmidt basis (lbm.gram_schmidt_basis)
// and their squared norms, as numpy computes them
constexpr int NSTRESS = 6;
__host__ __device__ constexpr double basis(int j, int k) {
  constexpr double t[NSTRESS][Q] = {
      {-0.5263157894736842, -0.5263157894736842, -0.5263157894736842,
       -0.5263157894736842, -0.5263157894736842, 0.4736842105263158,
       0.4736842105263158, -0.5263157894736842, -0.5263157894736842,
       -0.5263157894736842, -0.5263157894736842, 0.4736842105263158,
       0.4736842105263158, 0.4736842105263158, 0.4736842105263158,
       0.4736842105263158, 0.4736842105263158, 0.4736842105263158,
       0.4736842105263158},
      {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
       0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -1.0, -1.0, 1.0},
      {-0.6666666666666665, -0.6666666666666665, -0.6666666666666665,
       0.3333333333333335, 0.3333333333333335, -0.4, -0.4,
       0.3333333333333335, 0.3333333333333335, 0.3333333333333335,
       0.3333333333333335, -0.4, -0.4, -0.4, -0.4, 0.6, 0.6, 0.6, 0.6},
      {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
       0.0, 1.0, -1.0, -1.0, 1.0, 0.0, 0.0, 0.0, 0.0},
      {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -1.0, -1.0,
       1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0},
      {-0.909090909090909, 0.09090909090909102, 0.09090909090909102,
       -0.5454545454545454, -0.5454545454545454, -0.5454545454545455,
       -0.5454545454545455, 0.45454545454545464, 0.45454545454545464,
       0.45454545454545464, 0.45454545454545464, 0.4545454545454545,
       0.4545454545454545, 0.4545454545454545, 0.4545454545454545,
       -0.18181818181818188, -0.18181818181818188, -0.18181818181818188,
       -0.18181818181818188}};
  return t[j][k];
}
__host__ __device__ constexpr double norm(int j) {
  constexpr double t[NSTRESS] = {4.736842105263158, 4.0, 4.4, 4.0, 4.0,
                                 3.818181818181818};
  return t[j];
}

// c x with a coefficient c of ops/lbm.py's unrolled products: +-1 is the
// value or its negation, anything else a multiply by (float)c
__device__ __forceinline__ float term(double c, float x) {
  return c == 1.0 ? x : (c == -1.0 ? -x : (float)c * x);
}

// sum_k c_k x[k] over the nonzero c_k in order, the first term alone
// (ops/lbm.py:edot, unrolled_matvec)
template <int N, class Coef>
__device__ __forceinline__ float combo(Coef coef, const float* x) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double c = coef(k);
    if (c == 0.0) continue;
    const float t = term(c, x[k]);
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

__device__ __forceinline__ float sum19(const float* x) {
  return combo<Q>([](int) { return 1.0; }, x);
}

// e_k . u with the zero components skipped (ops/lbm.py:equilibrium)
__device__ __forceinline__ float edot(int k, const float* u) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (e(a, k) == 0) continue;
    const float t = e(a, k) > 0 ? u[a] : -u[a];
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

// ops/lbm.py:equilibrium, with PyTorch's divisions by the constants 1/3,
// 2/9 and 2/3 as multiplies by 3, 4.5 and 1.5
__device__ __forceinline__ void equilibrium(float rho, const float* u,
                                            float* feq) {
  const float usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float wr = (float)wd(k) * rho;
    if (k == 0) {
      feq[k] = wr * (1.f - usq * 1.5f);
      continue;
    }
    const float eu = edot(k, u);
    feq[k] = wr * (1.f + eu * 3.f + eu * eu * 4.5f - usq * 1.5f);
  }
}

// reverse of equilibrium: adds the cotangents of rho and u given those of
// the 19 outputs
__device__ __forceinline__ void equilibrium_b(float rho, const float* u,
                                              const float* a, float& arho,
                                              float* au) {
  const float usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  float ausq = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float w = (float)wd(k);
    if (k == 0) {
      arho += a[k] * w * (1.f - 1.5f * usq);
      ausq -= 1.5f * a[k] * w * rho;
      continue;
    }
    const float eu = edot(k, u);
    const float ac = a[k] * w * rho;
    arho += a[k] * w * (1.f + 3.f * eu + 4.5f * eu * eu - 1.5f * usq);
    ausq -= 1.5f * ac;
    const float aeu = ac * (3.f + 9.f * eu);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (e(d, k)) au[d] += e(d, k) > 0 ? aeu : -aeu;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) au[d] += 2.f * u[d] * ausq;
}

// ops/lbm.py:nebb_boundary on face (AXIS, SIDE): SIDE +1 where the fluid
// lies toward +AXIS (a W face), -1 on the high face; VELOCITY imposes the
// normal velocity `value`, else the density `value`
template <int AXIS, int SIDE, bool VELOCITY>
__device__ __forceinline__ void nebb(const float* f, float value,
                                     float* out) {
  float s_t = 0.f, s_o = 0.f;
  bool first_t = true, first_o = true;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (e(AXIS, k) == 0) {
      s_t = first_t ? f[k] : s_t + f[k];
      first_t = false;
    } else if (e(AXIS, k) == -SIDE) {
      s_o = first_o ? f[k] : s_o + f[k];
      first_o = false;
    }
  }
  float rho, un;
  if (VELOCITY) {
    un = value;
    rho = (s_t + s_o * 2.f) / (1.f - (SIDE > 0 ? un : -un));
  } else {
    rho = value;
    const float r = 1.f - (s_t + s_o * 2.f) / rho;
    un = SIDE > 0 ? r : -r;
  }
  float corr[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k)
    if (e(AXIS, k) == SIDE)
      corr[k] = (float)(6.0 * wd(k) * e(AXIS, k)) * rho * un;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AXIS) continue;
    float qt = 0.f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (e(AXIS, k) != 0 || e(t, k) == 0) continue;
      const float v = e(t, k) > 0 ? f[k] : -f[k];
      qt = first ? v : qt + v;
      first = false;
    }
    const float jt = qt * -3.f;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (e(AXIS, k) == SIDE && e(t, k) != 0)
        corr[k] = corr[k] + (float)(6.0 * wd(k) * e(t, k)) * jt;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k)
    out[k] = e(AXIS, k) == SIDE ? f[opp(k)] + corr[k] : f[k];
}

// reverse of nebb: q (the pulled populations' cotangents) from a (the
// closure's outputs'); the closure is linear in f at a fixed `value`
template <int AXIS, int SIDE, bool VELOCITY>
__device__ __forceinline__ void nebb_b(float value, const float* a,
                                       float* q) {
#pragma unroll
  for (int k = 0; k < Q; ++k) q[k] = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (e(AXIS, k) == SIDE) q[opp(k)] += a[k];
    else q[k] += a[k];
  }
  // the tangential momenta: corr_k += 6 w_k e_tk j_t, j_t = -3 q_t
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AXIS) continue;
    float aj = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (e(AXIS, k) == SIDE && e(t, k) != 0)
        aj += (float)(6.0 * wd(k) * e(t, k)) * a[k];
    const float aq = -3.f * aj;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (e(AXIS, k) == 0 && e(t, k) != 0) q[k] += e(t, k) > 0 ? aq : -aq;
  }
  // the normal term: corr_k = 6 w_k e_k rho un, with S = s_t + 2 s_o
  float acn = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k)
    if (e(AXIS, k) == SIDE) acn += (float)(6.0 * wd(k) * e(AXIS, k)) * a[k];
  float as;
  if (VELOCITY) {     // rho = S / (1 - SIDE un)
    const float un = value;
    as = acn * un / (1.f - (SIDE > 0 ? un : -un));
  } else {            // un = SIDE (1 - S / rho)
    const float aun = acn * value;
    as = (SIDE > 0 ? -aun : aun) / value;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (e(AXIS, k) == 0) q[k] += as;
    else if (e(AXIS, k) == -SIDE) q[k] += 2.f * as;
  }
}

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
    switch (bc) {
      case 1:
#pragma unroll
        for (int k = 0; k < Q; ++k) fb[k] = f[opp(k)];
        break;
      case 2: nebb<0, 1, true>(f, c.zonal(Z_Velocity), fb); break;
      case 3: nebb<0, 1, false>(f, c.zonal(Z_Density), fb); break;
      case 4: nebb<0, -1, true>(f, c.zonal(Z_Velocity), fb); break;
      case 5: nebb<0, -1, false>(f, c.zonal(Z_Density), fb); break;
      case 6:
#pragma unroll
        for (int k = 0; k < Q; ++k) fb[k] = f[mirror_y(k)];
        break;
      default:
#pragma unroll
        for (int k = 0; k < Q; ++k) fb[k] = f[k];
    }
    rho = sum19(fb);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      u[d] = combo<Q>([d](int k) { return (double)e(d, k); }, fb) / rho;
    float feq[Q];
    equilibrium(rho, u, feq);
#pragma unroll
    for (int k = 0; k < Q; ++k) fneq[k] = fb[k] - feq[k];
    // lbm.two_rate_relax: mn = M[4:10] fneq, back = (M[4:10] / |row|^2)^T mn
    float mn[NSTRESS];
#pragma unroll
    for (int j = 0; j < NSTRESS; ++j)
      mn[j] = combo<Q>([j](int k) { return basis(j, k); }, fneq);
#pragma unroll
    for (int k = 0; k < Q; ++k)
      back[k] = combo<NSTRESS>(
          [k](int j) { return basis(j, k) / norm(j); }, mn);
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
