// d2q9_heat_adj device physics for the generic 2D kernels
// (csrc/generic2d.cu, csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_heat_adj.py: the
// forward stage<0> (Run) and its hand-written reverse stage_b<0>, which
// plays the role of the reference's Tapenade-generated Run_b.  The
// forward is written against the template's node context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.setting(i)         setting i (enum Setting, registry order)
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
// (population sums in plane order, PyTorch's divisions by constants as
// multiplies by their reciprocals, 1 / x as a reciprocal) and generic2d.cu
// is built with --fmad=false, so the forward kernels agree with the plain
// versions to a few ulps.  The reverse is the exact derivative of that
// arithmetic in another order; the derivative of |ux| at 0 is +1, as in
// the PyTorch model and the JAX package.
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

// storage planes: f[0..8], T[0..8] over the d2q9 velocity set, then w
constexpr int N_STORAGE = 19;
constexpr int T0 = 9;          // first T plane
constexpr int WP = 18;         // the design density w
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1,
                                0, 1, 0, -1, 0, 1, -1, -1, 1, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1,
                                0, 0, 1, 0, -1, 1, 1, -1, -1, 0};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f and T
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x3ffffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_InletVelocity, S_InletTemperature, S_InitTemperature,
  S_InletDensity, S_FluidAlfa, S_SolidAlfa, S_HeatSource, S_Porocity,
  S_HeatFluxInObj, S_HeatSourceTotalInObj, S_MaterialInObj, S_DragInObj,
  N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_EPressure, T_Outlet,
                N_TYPES };
enum Group { G_COLLISION, G_DESIGNSPACE, N_GROUPS };
enum Zonal { Z_Porocity, N_ZONAL };
enum Global { GL_HeatFlux, GL_HeatSourceTotal, GL_Material, GL_Drag,
              N_GLOBALS };

// the d2q9 pieces of csrc/models/d2q9_common.cuh (the first nine planes
// of both groups run over the same velocity set)
using d2q9::combo;
using d2q9::edot;
using d2q9::equilibrium;
using d2q9::equilibrium_b;
using d2q9::opp;
using d2q9::sum9;
using d2q9::wd;

// temperature equilibrium (models/d2q9_heat.py:_t_eq): w_0 T at rest,
// w_k T (1 + 3 e_k.u) else
__device__ __forceinline__ void t_equilibrium(float T, float ux, float uy,
                                              float* teq) {
  teq[0] = (float)wd(0) * T;
#pragma unroll
  for (int k = 1; k < 9; ++k)
    teq[k] = (float)wd(k) * T * (1.f + 3.f * edot(k, ux, uy));
}

// The forward of one node up to the collision, shared by stage<0> and its
// reverse: the boundary cases on f and T, the macroscopic values and the
// two equilibria
struct Forward {
  float f[9], t[9];        // pulled populations
  float fb[9], tb[9];      // after the boundary cases
  float w, omw;            // design density, 1 - w
  float rho, ux, uy, ux2, uy2, temp, omt, src;
  float feq[9], feq2[9], teq[9];
  bool wall, wvel, epres, coll;

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      f[k] = fb[k] = c.pulled(k);
      t[k] = tb[k] = c.pulled(T0 + k);
    }
    w = c.pulled(WP);
    wall = c.nt_is(T_Wall) || c.nt_is(T_Solid);
    wvel = c.nt_is(T_WVelocity);
    epres = c.nt_is(T_EPressure);
    coll = c.nt_in_group(G_COLLISION);
    if (wall) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        fb[k] = f[opp(k)];
        tb[k] = t[opp(k)];
      }
    } else if (wvel) {
      d2q9::zou_he_x<true, true>(fb, c.setting(S_InletVelocity));
      const float tin = c.setting(S_InletTemperature);
#pragma unroll
      for (int k = 0; k < 9; ++k) tb[k] = (float)wd(k) * tin;
    } else if (epres) {
      d2q9::zou_he_x<false, false>(fb, c.setting(S_InletDensity));
    }
    rho = sum9(fb);
    ux = combo([](int k) { return (float)ex(k); }, fb) / rho;
    uy = combo([](int k) { return (float)ey(k); }, fb) / rho;
    equilibrium(rho, ux, uy, feq);
    omw = 1.f - w;
    ux2 = ux * w;
    uy2 = uy * w;
    equilibrium(rho, ux2, uy2, feq2);
    temp = sum9(tb);
    const float alfa = c.setting(S_FluidAlfa) * w
                       + c.setting(S_SolidAlfa) * omw;
    omt = 1.f / (3.f * alfa + 0.5f);
    src = c.setting(S_HeatSource) * omw;
    t_equilibrium(temp, ux2, uy2, teq);
  }
};

// stage 0, Run: the boundary cases, the BGK collision with the Brinkman
// velocity, the temperature collision, the four globals
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  if (s.coll)
    c.add_global(GL_Drag, s.omw * (s.ux >= 0.f ? s.ux : -s.ux));
  const float om = c.setting(S_omega);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (s.coll) {
      c.store(k, s.fb[k] + om * (s.feq[k] - s.fb[k])
                     + (s.feq2[k] - s.feq[k]));
      c.store(T0 + k, s.tb[k] + s.omt * (s.teq[k] - s.tb[k])
                          + (float)wd(k) * s.src);
    } else {
      c.store(k, s.fb[k]);
      c.store(T0 + k, s.tb[k]);
    }
  }
  if (c.nt_is(T_Outlet)) c.add_global(GL_HeatFlux, s.temp * s.ux2);
  if (s.coll) c.add_global(GL_HeatSourceTotal, s.src);
  if (c.nt_in_group(G_DESIGNSPACE)) c.add_global(GL_Material, s.omw);
}

// reverse of stage 0: the cotangents of the 19 pulled inputs and of the
// settings, given those of the outputs and of the globals
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  float afb[9], atb[9];
  float arho = 0.f, aux = 0.f, auy = 0.f, aux2 = 0.f, auy2 = 0.f;
  float atemp = 0.f, aw = 0.f, asrc = 0.f, aomt = 0.f;
  // the globals
  if (c.nt_is(T_Outlet)) {
    const float l = c.lam_global(GL_HeatFlux);
    atemp += l * s.ux2;
    aux2 += l * s.temp;
  }
  if (s.coll) {
    asrc += c.lam_global(GL_HeatSourceTotal);
    const float l = c.lam_global(GL_Drag);
    aw -= l * (s.ux >= 0.f ? s.ux : -s.ux);
    aux += l * s.omw * (s.ux >= 0.f ? 1.f : -1.f);
  }
  if (c.nt_in_group(G_DESIGNSPACE)) aw -= c.lam_global(GL_Material);
  // the collisions: fc = fb + om (feq - fb) + (feq2 - feq),
  // tc = tb + omt (teq - tb) + w_k src
  if (s.coll) {
    const float om = c.setting(S_omega);
    float aeq[9], aeq2[9], aomega = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float lf = c.lam(k), lt = c.lam(T0 + k);
      afb[k] = lf * (1.f - om);
      aeq[k] = lf * (om - 1.f);
      aeq2[k] = lf;
      aomega += lf * (s.feq[k] - s.fb[k]);
      atb[k] = lt * (1.f - s.omt);
      aomt += lt * (s.teq[k] - s.tb[k]);
      asrc += lt * (float)wd(k);
      // teq_k = w_k temp (1 + 3 e_k.u2)
      const float ateq = lt * s.omt * (float)wd(k);
      if (k == 0) {
        atemp += ateq;
      } else {
        atemp += ateq * (1.f + 3.f * edot(k, s.ux2, s.uy2));
        const float aeu = ateq * s.temp * 3.f;
        aux2 += ex(k) * aeu;
        auy2 += ey(k) * aeu;
      }
    }
    c.add_setting(S_omega, aomega);
    equilibrium_b(s.rho, s.ux, s.uy, aeq, arho, aux, auy);
    equilibrium_b(s.rho, s.ux2, s.uy2, aeq2, arho, aux2, auy2);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      afb[k] = c.lam(k);
      atb[k] = c.lam(T0 + k);
    }
  }
  // omt = 1 / (3 alfa + 0.5), alfa = FluidAlfa w + SolidAlfa (1 - w)
  const float aalfa = -3.f * s.omt * s.omt * aomt;
  c.add_setting(S_FluidAlfa, aalfa * s.w);
  c.add_setting(S_SolidAlfa, aalfa * s.omw);
  aw += aalfa * (c.setting(S_FluidAlfa) - c.setting(S_SolidAlfa));
  // src = HeatSource (1 - w)
  c.add_setting(S_HeatSource, asrc * s.omw);
  aw -= asrc * c.setting(S_HeatSource);
  // u2 = u w
  aux += aux2 * s.w;
  auy += auy2 * s.w;
  aw += aux2 * s.ux + auy2 * s.uy;
  // temp = sum tb; u = j / rho; rho = sum fb
  const float ajx = aux / s.rho, ajy = auy / s.rho;
  arho -= (aux * s.ux + auy * s.uy) / s.rho;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    atb[k] += atemp;
    afb[k] += arho + ex(k) * ajx + ey(k) * ajy;
  }
  // the boundary cases
  float qf[9], qt[9];
  if (s.wall) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      qf[k] = afb[opp(k)];
      qt[k] = atb[opp(k)];
    }
  } else if (s.wvel) {
    // tb = w_k InletTemperature: no cotangent to the pulled T
    float atin = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      atin += (float)wd(k) * atb[k];
      qt[k] = 0.f;
    }
    c.add_setting(S_InletTemperature, atin);
    float av;
    d2q9::zou_he_x_b<true, true>(s.f, c.setting(S_InletVelocity), afb, qf,
                                 av);
    c.add_setting(S_InletVelocity, av);
  } else if (s.epres) {
#pragma unroll
    for (int k = 0; k < 9; ++k) qt[k] = atb[k];
    float av;
    d2q9::zou_he_x_b<false, false>(s.f, c.setting(S_InletDensity), afb, qf,
                                   av);
    c.add_setting(S_InletDensity, av);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      qf[k] = afb[k];
      qt[k] = atb[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    c.set_q(k, qf[k]);
    c.set_q(T0 + k, qt[k]);
  }
  c.set_q(WP, aw);
}

// the template names stage<1> where it runs two-stage actions
template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage_b(Ctx& c) {
  if constexpr (S == 0) run_b(c);
}

}  // namespace model
