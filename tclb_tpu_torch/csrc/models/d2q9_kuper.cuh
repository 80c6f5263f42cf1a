// d2q9_kuper device physics for the generic 2D kernels (csrc/generic2d.cu),
// also the forward of d2q9_kuper_adj (csrc/models/d2q9_kuper_adj.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/d2q9_kuper.py: one
// __device__ function per stage of the Iteration action, written against
// the template's node context `c`:
//
//   c.pulled(k)          plane k streamed to the node (from x - e_k)
//   c.load(k, dx, dy)    plane k of the un-streamed storage at x + (dx, dy)
//   c.setting(i)         setting i (enum Setting, registry order)
//   c.zonal(j)           zonal setting j at the node's zone (enum Zonal)
//   c.nt_is(t)           the node's group field equals node type t
//   c.nt_in_group(g)     any bit of group g is set
//   c.add_global(g, v)   a node's contribution to SUM global g
//   c.store(k, v)        plane k of the stage's output
//
// The arithmetic repeats the PyTorch model op for op in the same order
// (population sums in plane order, powers as products, a division by a
// constant as PyTorch's CUDA kernels do it: a multiply by its reciprocal),
// and generic2d.cu is built with --fmad=false, so the kernels agree with
// the plain versions to a few ulps.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

namespace model {

// Tables are accessor functions over local constant arrays: device code may
// not index a namespace-scope constexpr array, and after unrolling every
// index here is a constant, so each call folds to a literal.

// storage planes: f[0..8] over the d2q9 velocity set, then the Field phi;
// d2q9_kuper_adj.cuh defines KUPER_DESIGN for its design density wd, a
// plane between them that does not stream (its table entries, and phi's,
// are the zeros the tables end with)
#ifdef KUPER_DESIGN
constexpr int N_STORAGE = 11;
constexpr int WD = 9, PHI = 10;
#else
constexpr int N_STORAGE = 10;
constexpr int PHI = 9;
#endif
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1, 0};
  return t[k];
}

// the Iteration action: stage 0 (Run) writes f, stage 1 (CalcPhi) writes
// phi; stage_ext is generic_kernels.action_plan's ring of each stage
constexpr int N_STAGES = 2;
__host__ __device__ constexpr unsigned stage_writes(int s) {
  return s == 0 ? 0x1ffu : 1u << PHI;
}
__host__ __device__ constexpr int stage_ext(int s) { return s == 0 ? 1 : 0; }

enum Setting {
  S_omega, S_nu, S_InletVelocity, S_Temperature, S_FAcc, S_Magic, S_MagicA,
  S_MagicF, S_GravitationX, S_GravitationY, S_MovingWallVelocity, S_Density,
  S_Wetting, S_S0, S_S1, S_S2, S_S3, S_S4, S_S5, S_S6, S_S7, S_S8,
  S_WallForceXInObj, S_WallForceYInObj, N_SETTINGS
};
enum NodeType { T_Wall, T_Solid, T_MovingWall, T_NSymmetry, T_SSymmetry,
                N_TYPES };
enum Group { G_BOUNDARY, G_COLLISION, N_GROUPS };
enum Zonal { Z_Density, N_ZONAL };
enum Global { GL_WallForceX, GL_WallForceY, N_GLOBALS };

// lattice weights, bounce-back pairs, the y mirror and the shell force
// weights (models/d2q9_kuper.py)
__host__ __device__ constexpr double wd(int k) {
  constexpr double t[9] = {4.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9,
                           1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36};
  return t[k];
}
__host__ __device__ constexpr int opp(int k) {
  constexpr int t[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  return t[k];
}
__host__ __device__ constexpr int mirror_y(int k) {
  constexpr int t[9] = {0, 1, 4, 3, 2, 8, 7, 6, 5};
  return t[k];
}
__host__ __device__ constexpr float gs(int k) {
  constexpr float t[9] = {0.f, 1.f, 1.f, 1.f, 1.f, .25f, .25f, .25f, .25f};
  return t[k];
}
// the van der Waals EOS constants
constexpr double A2 = 3.852462271644162;
constexpr double B2 = 0.1304438860971524 * 4.0;
constexpr double C2 = 2.785855170470555;

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

// sum_k coef[k] x[k] over the nonzero coefficients, in order (ops/lbm.py:
// edot and unrolled_matvec); a coefficient of +-1 is an add or a subtract
template <class Coef>
__device__ __forceinline__ float combo(Coef coef, const float* x) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float c = coef(k);
    if (c == 0.f) continue;
    const float t = (c == 1.f) ? x[k] : (c == -1.f ? -x[k] : c * x[k]);
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

__device__ __forceinline__ float rho_of(const float* f) {
  return combo([](int) { return 1.f; }, f);
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

__device__ __forceinline__ void moments(const float* f, float* m) {
#pragma unroll
  for (int r = 0; r < 9; ++r)
    m[r] = combo([r](int k) { return (float)basis(r, k); }, f);
}

__device__ __forceinline__ void from_moments(const float* m, float* f) {
#pragma unroll
  for (int k = 0; k < 9; ++k)
    f[k] = combo([k](int r) { return (float)(basis(r, k) / norm(r)); }, m);
}

// Kupershtokh exact-difference force (models/d2q9_kuper.py:_force): phi
// sampled at -e_i, weighted with +e_i; the wall momentum term and the
// wall-force globals on Wall nodes
template <class Ctx>
__device__ __forceinline__ void force(Ctx& c, const float* f, float& fx,
                                      float& fy) {
  const float a = c.setting(S_MagicA);
  const float b = 1.f - 2.f * a;
  const float phi0 = c.load(PHI, 0, 0);
  bool fx0 = true, fy0 = true;
  fx = 0.f;
  fy = 0.f;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const float phii = c.load(PHI, -ex(i), -ey(i));
    const float r = a * phii * phii + b * phii * phi0;
    const float gr = gs(i) * r;
    if (ex(i)) {
      const float t = ex(i) > 0 ? gr : -gr;
      fx = fx0 ? 0.f + t : fx + t;
      fx0 = false;
    }
    if (ey(i)) {
      const float t = ey(i) > 0 ? gr : -gr;
      fy = fy0 ? 0.f + t : fy + t;
      fy0 = false;
    }
  }
  const float scale = c.setting(S_MagicF);
  fx = scale * fx;
  fy = scale * fy;
  if (c.nt_is(T_Wall)) {
    const float jx = combo([](int k) { return (float)ex(k); }, f);
    const float jy = combo([](int k) { return (float)ey(k); }, f);
    fx = fx + 2.f * jx;
    fy = fy + 2.f * jy;
    c.add_global(GL_WallForceX, jx);
    c.add_global(GL_WallForceY, jy);
  }
}

// stage 0, Run: boundary cases, then the MRT collision with the force
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  float f[9], g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  if (c.nt_is(T_Wall) || c.nt_is(T_Solid)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = f[opp(k)];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
  } else if (c.nt_is(T_MovingWall)) {
    const float mwv = c.setting(S_MovingWallVelocity);
#pragma unroll
    for (int k = 0; k < 9; ++k)
      g[k] = ex(k) ? f[opp(k)] + (float)(6.0 * wd(k) * ex(k)) * mwv
                    : f[opp(k)];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
  } else if (c.nt_is(T_NSymmetry) || c.nt_is(T_SSymmetry)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = f[mirror_y(k)];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
  }

  if (!c.nt_in_group(G_COLLISION)) {
    // no collision: the force is not needed, its wall-force globals are
    if (c.nt_is(T_Wall)) {
      c.add_global(GL_WallForceX, combo([](int k) { return (float)ex(k); }, f));
      c.add_global(GL_WallForceY, combo([](int k) { return (float)ey(k); }, f));
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) c.store(k, f[k]);
    return;
  }
  float fx, fy;
  const float rho = rho_of(f);
  const float ux = combo([](int k) { return (float)ex(k); }, f) / rho;
  const float uy = combo([](int k) { return (float)ey(k); }, f) / rho;
  float feq[9], d[9], mneq[9];
  equilibrium(rho, ux, uy, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = f[k] - feq[k];
  moments(d, mneq);
#pragma unroll
  for (int r = 0; r < 9; ++r) mneq[r] = mneq[r] * c.setting(S_S0 + r);
  force(c, f, fx, fy);
  const float ux2 = ux + fx / rho + c.setting(S_GravitationX);
  const float uy2 = uy + fy / rho + c.setting(S_GravitationY);
  // Minv m_neq + feq2 (== Minv (m_neq + M feq2))
  from_moments(mneq, f);
  equilibrium(rho, ux2, uy2, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) c.store(k, f[k] + feq[k]);
}

// stage 1, CalcPhi: the pseudopotential from the streamed density; boundary
// nodes other than the symmetry mirrors take the zonal Density
template <class Ctx>
__device__ __forceinline__ void calc_phi(Ctx& c) {
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = c.pulled(k);
  float rho = rho_of(f);
  if (c.nt_in_group(G_BOUNDARY) && !(c.nt_is(T_NSymmetry) ||
                                     c.nt_is(T_SSymmetry)))
    rho = c.zonal(Z_Density);
  // models/d2q9_kuper.py:_eos_pressure
  const float br = (float)B2 * rho * 0.25f;
  const float om = 1.f - br;
  const float eos = rho * (-(br * br * br) + br * br + br + 1.f)
                    * c.setting(S_Temperature) * (float)C2
                    / (om * om * om) - (float)A2 * rho * rho;
  const float p = c.setting(S_Magic) * eos;
  const float x = rho * (1.f / 3.f) - p;
  const float phi = c.setting(S_FAcc) * sqrtf(x > 0.f ? x : 0.f);
#ifdef KUPER_DESIGN
  c.store(PHI, phi * c.pulled(WD));
#else
  c.store(PHI, phi);
#endif
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
  else calc_phi(c);
}

}  // namespace model
