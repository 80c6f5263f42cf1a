// d3q19_kuper device physics for the generic 3D kernels (csrc/generic3d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/d3q19_kuper.py: the two
// stages of the Iteration action, written against the template's node
// context `c`:
//
//   c.pulled(k)            plane k streamed to the node (from x - e_k)
//   c.load(k, dz, dy, dx)  plane k of the un-streamed storage at an offset
//                          (a stage's input: the step's, or the planes an
//                          earlier stage of the step wrote)
//   c.setting(i)           setting i (enum Setting, registry order)
//   c.zonal(j)             zonal setting j (enum Zonal) in the node's zone
//   c.nt_is(t)             the node's group field equals node type t
//   c.nt_in_group(g)       any bit of group g is set
//   c.store(k, v)          plane k of the stage's output
//
// stage<0> (Run): the family's boundary cases, the Kupershtokh
// exact-difference force over the 18 moving directions from the
// pseudopotential phi of the step's input (sampled at -e_i, weighted with
// +e_i and the shell weight 18 w_i), then BGK with the force as an
// equilibrium difference; stage<1> (CalcPhi): phi = FAcc sqrt(rho/3 -
// Magic p_vdW(rho, T)) from the density Run's output streams to the node,
// the zonal Density on boundary nodes.  generic3d.cu runs them as two
// passes.  The arithmetic repeats the PyTorch model op for op in the same
// order and generic3d.cu is built with --fmad=false, so the kernels agree
// with the plain versions to a few ulps.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file's enums and tables against that list and the model.

#pragma once

#include "d3q19_common.cuh"

namespace model {

// storage planes: f[0..18] over the d3q19 velocity set, then the Field phi
constexpr int N_STORAGE = 20;
constexpr int PHI = 19;
__host__ __device__ constexpr int ex(int k) { return k < Q ? c19(0, k) : 0; }
__host__ __device__ constexpr int ey(int k) { return k < Q ? c19(1, k) : 0; }
__host__ __device__ constexpr int ez(int k) { return k < Q ? c19(2, k) : 0; }

// the Iteration action: stage 0 (Run) writes f, stage 1 (CalcPhi) writes
// phi; stage_ext is generic_kernels.action_plan's ring of each stage
constexpr int N_STAGES = 2;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x7ffffu : 0x80000u;
}
__host__ __device__ constexpr int stage_ext(int s) { return s == 0 ? 1 : 0; }

enum Setting {
  S_omega, S_nu, S_Temperature, S_FAcc, S_Magic, S_MagicA, S_MagicF,
  S_GravitationX, S_GravitationY, S_GravitationZ, S_Density, S_Wetting,
  N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
                T_EVelocity, N_TYPES };
enum Group { G_BOUNDARY, G_COLLISION, N_GROUPS };
enum Zonal { Z_Density, N_ZONAL };
enum Global { N_GLOBALS };

// the van der Waals EOS constants (models/d2q9_kuper.py)
constexpr double A2 = 3.852462271644162;
constexpr double B2 = 0.1304438860971524 * 4.0;
constexpr double C2 = 2.785855170470555;

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[Q], fb[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
  // the model has no Velocity setting: its velocity faces impose 0
  const int bc = (c.nt_is(T_Wall) || c.nt_is(T_Solid)) ? BC_BOUNCE
                 : c.nt_is(T_WVelocity) ? BC_WVELOCITY
                 : c.nt_is(T_WPressure) ? BC_WPRESSURE
                 : c.nt_is(T_EVelocity) ? BC_EVELOCITY
                 : c.nt_is(T_EPressure) ? BC_EPRESSURE : BC_NONE;
  boundary19(bc, f, [] { return 0.f; },
             [&] { return c.zonal(Z_Density); }, fb);
  if (!c.nt_in_group(G_COLLISION)) {
#pragma unroll
    for (int k = 0; k < Q; ++k) c.store(k, fb[k]);
    return;
  }
  // the force: phi at -e_i, a phi_i^2 + (1 - 2a) phi_i phi_0 weighted with
  // the shell weight and +e_i
  const float a = c.setting(S_MagicA);
  const float b = 1.f - 2.f * a;
  const float phi0 = c.load(PHI, 0, 0, 0);
  float frc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const float phii = c.load(PHI, -c19(2, i), -c19(1, i), -c19(0, i));
    const float r = a * phii * phii + b * phii * phi0;
    const float gr = (float)(18.0 * wd(i)) * r;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (c19(d, i)) frc[d] = frc[d] + (c19(d, i) > 0 ? gr : -gr);
  }
  const float s = c.setting(S_MagicF);
  const float rho = sum19(fb);
  float u[3], u2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    u[d] = combo<Q>([d](int k) { return (double)c19(d, k); }, fb) / rho;
  u2[0] = u[0] + (s * frc[0] / rho + c.setting(S_GravitationX));
  u2[1] = u[1] + (s * frc[1] / rho + c.setting(S_GravitationY));
  u2[2] = u[2] + (s * frc[2] / rho + c.setting(S_GravitationZ));
  float feq[Q], feq2[Q];
  equilibrium(rho, u, feq);
  equilibrium(rho, u2, feq2);
  const float omega = c.setting(S_omega);
#pragma unroll
  for (int k = 0; k < Q; ++k)
    c.store(k, fb[k] + omega * (feq[k] - fb[k]) + (feq2[k] - feq[k]));
}

// stage 1, CalcPhi: the pseudopotential from the streamed density;
// boundary nodes take the zonal Density
template <class Ctx>
__device__ __forceinline__ void calc_phi(Ctx& c) {
  float f[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = c.pulled(k);
  float rho = sum19(f);
  if (c.nt_in_group(G_BOUNDARY)) rho = c.zonal(Z_Density);
  // models/d2q9_kuper.py:_eos_pressure
  const float br = (float)B2 * rho * 0.25f;
  const float om = 1.f - br;
  const float eos = rho * (-(br * br * br) + br * br + br + 1.f)
                    * c.setting(S_Temperature) * (float)C2
                    / (om * om * om) - (float)A2 * rho * rho;
  const float p = c.setting(S_Magic) * eos;
  const float x = rho * (1.f / 3.f) - p;
  c.store(PHI, c.setting(S_FAcc) * sqrtf(x > 0.f ? x : 0.f));
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
  else calc_phi(c);
}

}  // namespace model
