// d2q9-family collide-stream kernels for Hopper (sm_90a).
//
// One node update (pull, boundary dispatch on the node's flag, collision)
// shared by three kernels:
//
//   d2q9_step       one thread per node, one step, periodic pulls straight
//                   from global memory into a second buffer
//                   (replaces tclb_tpu/ops/pallas_d2q9.py:make_pallas_iterate,
//                   the single-step `call`);
//   d2q9_step2      two fused steps per 32x8 tile: the tile plus a two-node
//                   ring of all 9 populations and the statics of the one-node
//                   ring are staged in shared memory; step 1 runs on the tile
//                   extended by one node, step 2 on the tile
//                   (replaces make_pallas_iterate's fused `call2`);
//   d2q9_resident8  a persistent cooperative kernel running 8 steps with a
//                   grid-wide barrier between them; two global buffers
//                   ping-pong and, for lattices the size of karman.xml, stay
//                   in the 50 MB L2 (replaces make_resident_iterate).
//
// The model is chosen at compile time: D2Q9_MODEL (0, the default, is d2q9;
// 1..5 the family d2q9_SRT, d2q9_les, d2q9_inc, d2q9_cumulant, d2q9_new, the
// reference's _FAMILY_2D, pallas_d2q9.py:136) builds one library per model,
// each holding only its own branch, so d2q9's code is what it was without
// the family.
//
// d2q9: MRT collision with body force and the BC coupling planes, Zou/He
// faces written for d2q9's population order, the symmetry closures; the
// kernels read the BC planes and copy every plane past the 9 populations
// through.  Streaming vectors, weights, bounce-back pairs, node-type masks,
// the MRT basis rows and the inverse-basis columns arrive in D2q9Args.
//
// The family (pallas_d2q9.py:_lbm_step_family): 9 storage planes, no BC
// planes read or copied.  Each model's velocity order is compiled in (the
// wrapper checks it against the registry through d2q9_velocity_set):
// d2q9's order but for d2q9_cumulant, whose index 3i + j holds (i-1, j-1),
// so weights, bounce-back pairs, mirrors and face populations all derive
// from that order and no index is a d2q9 constant.  Boundaries are
// family.boundary_cases (non-equilibrium bounce-back faces after
// lbm.nebb_boundary, Top/BottomSymmetry mirrors) but for d2q9_new, which
// keeps d2q9's Zou/He list; collisions are BGK (d2q9_SRT), BGK at the
// Smagorinsky rate (d2q9_les), He-Luo (d2q9_inc), the 2D cumulant
// (ops/cumulant.py:collide_d2q9) and the raw-moment MRT with its
// Smagorinsky and Stab modes (models/d2q9_new.py:collision_core), each
// written op for op in the plain version's order and built with
// --fmad=false, so the kernels round where the plain PyTorch versions do.
//
// Every kernel computes no globals (the NoGlobals flavour: the engine's
// trailing eager step computes them).
//
// What bounds them on this card: d2q9_step and d2q9_step2 are bound by
// bytes for every model (a family node reads 9 planes, its flag and two
// zonal planes and writes 9: 84 B against 118 (cumulant) to 243 (d2q9_new
// with both modes) flops, far below the card's 20 flops a byte); the
// design keeps the populations in registers, reads each plane with
// neighbouring threads on neighbouring addresses, and in d2q9_step2 halves
// the device-memory traffic a step.  d2q9_resident8's bound is set by one
// read and one write of the state for the family (8 steps of 118 to 243
// flops against 84 B sit just under the card's 20 flops a byte) and by
// operations for d2q9 (8 x 267 against 100 B, just over it); its time shows
// the grid barriers and the L2 bandwidth, far above either bound.
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifndef D2Q9_MODEL
#define D2Q9_MODEL 0
#endif
enum { MODEL_D2Q9 = 0, MODEL_SRT, MODEL_LES, MODEL_INC, MODEL_CUMULANT,
       MODEL_NEW };
constexpr int kModel = D2Q9_MODEL;
constexpr bool kFamily = kModel != MODEL_D2Q9;
static_assert(kModel >= MODEL_D2Q9 && kModel <= MODEL_NEW, "D2Q9_MODEL");

// node-type cases, in the order the model applies them
enum {
  CASE_WALL = 0, CASE_SOLID, CASE_EVELOCITY, CASE_WPRESSURE, CASE_WVELOCITY,
  CASE_EPRESSURE, CASE_TOPSYM, CASE_BOTTOMSYM, N_CASES
};

struct D2q9Args {
  int ny, nx;
  int n_storage;           // planes in the field stack
  int bc[2];               // planes of BC[0], BC[1]
  int ex[9], ey[9];        // streaming vectors
  int opp[9];              // bounce-back pairs
  float w[9];              // lattice weights
  float m[6][9];           // MRT basis rows 3..8
  float minv[9][6];        // inverse-basis columns 3..8
  float rate[6];           // S3, S4, S56, S56, S78, S78
  float gx, gy;            // GravitationX, GravitationY
  int case_mask[N_CASES], case_val[N_CASES];
  int mrt_mask, mrt_val;
  // the family's constants (unused by d2q9)
  float omega, smag, omega_bulk;
  int coll_mask;                   // COLLISION group
  int smag_mask, smag_val;         // d2q9_new: Smagorinsky (LES)
  int stab_mask, stab_val;         // d2q9_new: Stab (ENTROPIC)
  float minv_new[9][9];            // d2q9_new: inverse monomial basis
  float p_sh[3][3], p_hh[3][3];    // d2q9_new: H-norm blocks (2 x >2, >2 x >2)
};

// the compiled model's velocity set: d2q9's order, or the tensor order
// (index 3i + j holds (i - 1, j - 1)) for d2q9_cumulant
__host__ __device__ constexpr int cx(int k) {
  return kModel == MODEL_CUMULANT ? k / 3 - 1
         : (k == 1 || k == 5 || k == 8) ? 1
         : (k == 3 || k == 6 || k == 7) ? -1 : 0;
}

__host__ __device__ constexpr int cy(int k) {
  return kModel == MODEL_CUMULANT ? k % 3 - 1
         : (k == 2 || k == 5 || k == 6) ? 1
         : (k == 4 || k == 7 || k == 8) ? -1 : 0;
}

__host__ __device__ constexpr int comp(int k, int axis) {
  return axis == 0 ? cx(k) : cy(k);
}

// the index of velocity (x, y)
__host__ __device__ constexpr int index_of(int x, int y) {
  int found = -1;
  for (int j = 0; j < 9; ++j)
    if (cx(j) == x && cy(j) == y) found = j;
  return found;
}

// bounce-back partner and y mirror (lbm.opposite, family.mirror_perm)
__host__ __device__ constexpr int opp(int k) {
  return index_of(-cx(k), -cy(k));
}

__host__ __device__ constexpr int mirror_y(int k) {
  return index_of(cx(k), -cy(k));
}

// lattice weight by speed shell (lbm.weights), in double as the plain
// version's coefficients are formed before they meet a float32 plane
__host__ __device__ constexpr double weight(int k) {
  return cx(k) * cx(k) + cy(k) * cy(k) == 0 ? 4.0 / 9.0
         : cx(k) * cx(k) + cy(k) * cy(k) == 1 ? 1.0 / 9.0 : 1.0 / 36.0;
}

// the streaming vector of population k the pulls use
__device__ __forceinline__ int ex_of(const D2q9Args& a, int k) {
  if constexpr (kFamily) return cx(k);
  else return a.ex[k];
}

__device__ __forceinline__ int ey_of(const D2q9Args& a, int k) {
  if constexpr (kFamily) return cy(k);
  else return a.ey[k];
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ bool is_type(const D2q9Args& a, int flag, int c) {
  return (flag & a.case_mask[c]) == a.case_val[c];
}

__device__ __forceinline__ void equilibrium(const D2q9Args& a, float rho,
                                            float ux, float uy, float* feq) {
  const float usq = ux * ux + uy * uy;
  const float base = 1.f - 1.5f * usq;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eu = a.ex[k] * ux + a.ey[k] * uy;
    feq[k] = a.w[k] * rho * (base + eu * (3.f + 4.5f * eu));
  }
}

// Zou/He on an x-normal face; `west` selects the face, `velocity` whether
// `value` is the imposed ux (else the imposed density).
__device__ __forceinline__ void zou_he_x(float* f, float value, bool west,
                                         bool velocity) {
  const float tang = f[0] + f[2] + f[4];
  if (west) {
    const float known = f[3] + f[7] + f[6];
    float rho, ux;
    if (velocity) { ux = value; rho = (tang + 2.f * known) / (1.f - ux); }
    else { rho = value; ux = 1.f - (tang + 2.f * known) / rho; }
    const float ru = rho * ux;
    f[1] = f[3] + (2.f / 3.f) * ru;
    f[5] = f[7] + (1.f / 6.f) * ru + 0.5f * (f[4] - f[2]);
    f[8] = f[6] + (1.f / 6.f) * ru + 0.5f * (f[2] - f[4]);
  } else {
    const float known = f[1] + f[5] + f[8];
    float rho, ux;
    if (velocity) { ux = value; rho = (tang + 2.f * known) / (1.f + ux); }
    else { rho = value; ux = -1.f + (tang + 2.f * known) / rho; }
    const float ru = rho * ux;
    const float f7 = f[5] - (1.f / 6.f) * ru + 0.5f * (f[2] - f[4]);
    const float f6 = f[8] - (1.f / 6.f) * ru + 0.5f * (f[4] - f[2]);
    f[3] = f[1] - (2.f / 3.f) * ru;
    f[7] = f7;
    f[6] = f6;
  }
}

// d2q9's node: `f` holds the pulled populations on entry and the updated
// ones on exit.  Boundary cases apply in the model's order, each to the
// result of the previous one (a node matches at most one), then MRT where
// its bit is set.
__device__ __forceinline__ void mrt_update(const D2q9Args& a, float* f,
                                           int flag, float vel, float den,
                                           float bc0, float bc1) {
  if (is_type(a, flag, CASE_WALL) || is_type(a, flag, CASE_SOLID)) {
    // g[k] = f[opp[k]] as selects: a runtime index into f would move the
    // populations out of registers into local memory
    float g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float v = f[0];
#pragma unroll
      for (int j = 1; j < 9; ++j) v = (a.opp[k] == j) ? f[j] : v;
      g[k] = v;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = g[k];
  }
  if (is_type(a, flag, CASE_EVELOCITY)) zou_he_x(f, vel, false, true);
  if (is_type(a, flag, CASE_WPRESSURE)) zou_he_x(f, den, true, false);
  if (is_type(a, flag, CASE_WVELOCITY)) zou_he_x(f, vel, true, true);
  if (is_type(a, flag, CASE_EPRESSURE)) zou_he_x(f, den, false, false);
  if (is_type(a, flag, CASE_TOPSYM)) {
    f[4] = f[2]; f[7] = f[6]; f[8] = f[5];
  }
  if (is_type(a, flag, CASE_BOTTOMSYM)) {
    f[2] = f[4]; f[5] = f[8]; f[6] = f[7];
  }
  if ((flag & a.mrt_mask) != a.mrt_val) return;

  float rho = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += f[k];
  float jx = 0.f, jy = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) { jx += a.ex[k] * f[k]; jy += a.ey[k] * f[k]; }
  const float ux = jx / rho, uy = jy / rho;
  float feq[9];
  equilibrium(a, rho, ux, uy, feq);
  float mneq[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc += a.m[i][k] * (f[k] - feq[k]);
    mneq[i] = acc * a.rate[i];
  }
  // the post-force equilibrium: Minv @ (m_neq + M @ feq2) == Minv @ m_neq
  // + feq2, and the conserved moments drop out of Minv @ m_neq
  equilibrium(a, rho, ux + a.gx + bc0, uy + a.gy + bc1, feq);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float acc = feq[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc += a.minv[k][i] * mneq[i];
    f[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// The family (D2Q9_MODEL 1..5).  Each function follows its plain PyTorch
// version's order of operations; a division by a Python number there is a
// multiplication by its float reciprocal here, as PyTorch computes it on
// the card (x / 3.0 is x * (1.f / 3.f)).
// ---------------------------------------------------------------------------

// f[idx] as selects: the index folds to a constant where the compiler sees
// it, and a runtime index into f would move the populations to local memory
__device__ __forceinline__ float pick(const float* f, int idx) {
  float v = f[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) v = (idx == j) ? f[j] : v;
  return v;
}

// f <- f[perm] for the bounce-back pairing or the y mirror (lbm.perm)
template <bool kMirror>
__device__ __forceinline__ void permute(float* f) {
  float g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = pick(f, kMirror ? mirror_y(k) : opp(k));
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = g[k];
}

// sum_k c_k f[k] over the nonzero unit coefficients, in index order
// (lbm.edot); kAxis 0 or 1 takes the velocity component as c
template <int kAxis>
__device__ __forceinline__ float edot(const float* f) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int c = comp(k, kAxis);
    if (c == 0) continue;
    if (first) acc = c > 0 ? f[k] : -f[k];
    else acc = c > 0 ? acc + f[k] : acc - f[k];
    first = false;
  }
  return acc;
}

__device__ __forceinline__ float rho_of(const float* f) {
  float rho = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += f[k];
  return rho;
}

// e.u of a moving population as lbm.equilibrium forms it
__device__ __forceinline__ float e_dot(int k, float ux, float uy) {
  const float tx = cx(k) > 0 ? ux : -ux;
  const float ty = cy(k) > 0 ? uy : -uy;
  return cx(k) == 0 ? ty : (cy(k) == 0 ? tx : tx + ty);
}

// lbm.equilibrium: w rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 |u|^2)
__device__ __forceinline__ void equilibrium_f(float rho, float ux, float uy,
                                              float* feq) {
  const float usq = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float common;
    if (cx(k) == 0 && cy(k) == 0) {
      common = 1.f - usq * 1.5f;
    } else {
      const float eu = e_dot(k, ux, uy);
      common = ((1.f + eu * 3.f) + (eu * eu) * 4.5f) - usq * 1.5f;
    }
    feq[k] = ((float)weight(k) * rho) * common;
  }
}

// d2q9_inc.inc_equilibrium: w (rho + rho0 (3 e.u + 4.5 (e.u)^2 - 1.5 |u|^2))
// with rho0 = 1
__device__ __forceinline__ void inc_equilibrium(float rho, float ux,
                                                float uy, float* feq) {
  const float usq = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eu = (float)cx(k) * ux + (float)cy(k) * uy;
    feq[k] = (float)weight(k)
             * (rho + ((3.f * eu + (4.5f * eu) * eu) - 1.5f * usq));
  }
}

// Non-equilibrium bounce-back on the x or y face (lbm.nebb_boundary): the
// fluid lies toward kSide * +kAxis; `value` is the imposed +kAxis velocity
// (velocity) or the density (pressure).
template <int kAxis, int kSide>
__device__ __forceinline__ void nebb(float* f, bool velocity, float value) {
  constexpr int kT = 1 - kAxis;
  float s_t = 0.f, s_o = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (comp(k, kAxis) == 0) s_t += f[k];
    else if (comp(k, kAxis) == -kSide) s_o += f[k];
  }
  float rho, un;
  if (velocity) {
    un = value;
    rho = (s_t + 2.f * s_o) / (1.f - (kSide > 0 ? un : -un));
  } else {
    rho = value;
    const float r = 1.f - (s_t + 2.f * s_o) / rho;
    un = kSide > 0 ? r : -r;
  }
  float q_t = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (comp(k, kAxis) == 0 && comp(k, kT) != 0)
      q_t += comp(k, kT) > 0 ? f[k] : -f[k];
  const float j_t = -3.f * q_t;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (comp(k, kAxis) != kSide) continue;
    float corr = ((float)(6.0 * weight(k) * comp(k, kAxis)) * rho) * un;
    if (comp(k, kT) != 0)
      corr = corr + (float)(6.0 * weight(k) * comp(k, kT)) * j_t;
    f[k] = pick(f, opp(k)) + corr;   // the partner of an unknown is a known
  }
}

// lbm.bgk_collide (d2q9_SRT) and d2q9_les.collide: BGK at omega, or at
// the Smagorinsky rate, with the velocity-shift body force
template <bool kLes>
__device__ __forceinline__ void bgk_collide(const D2q9Args& a, float* f) {
  const float rho = rho_of(f);
  const float ux = edot<0>(f) / rho, uy = edot<1>(f) / rho;
  float feq[9];
  equilibrium_f(rho, ux, uy, feq);
  float om = a.omega;
  if constexpr (kLes) {
    // lbm.smagorinsky_omega_unrolled: |Pi|^2 over (xx, xy, yy)
    float pxx = 0.f, pxy = 0.f, pyy = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float d = f[k] - feq[k];
      if (cx(k) != 0) pxx += d;
      if (cx(k) * cy(k) != 0) pxy += cx(k) * cy(k) > 0 ? d : -d;
      if (cy(k) != 0) pyy += d;
    }
    const float pi2 = (pxx * pxx + (pxy * pxy) * 2.f) + pyy * pyy;
    const float tau0 = 1.f / a.omega;
    const float c = ((float)(18.0 * 1.4142135623730951) * a.smag) * a.smag;
    const float tau_eff =
        0.5f * (tau0 + sqrtf(tau0 * tau0 + (c * sqrtf(pi2)) / rho));
    om = 1.f / tau_eff;
  }
  float feq2[9];
  equilibrium_f(rho, ux + a.gx, uy + a.gy, feq2);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    f[k] = (f[k] + om * (feq[k] - f[k])) + (feq2[k] - feq[k]);
}

// d2q9_inc.collide: He-Luo BGK, u = j / rho0 with rho0 = 1
__device__ __forceinline__ void inc_collide(const D2q9Args& a, float* f) {
  const float rho = rho_of(f);
  const float ux = edot<0>(f), uy = edot<1>(f);
  float feq[9], feq2[9];
  inc_equilibrium(rho, ux, uy, feq);
  inc_equilibrium(rho, ux + a.gx, uy + a.gy, feq2);
#pragma unroll
  for (int k = 0; k < 9; ++k)
    f[k] = (f[k] + a.omega * (feq[k] - f[k])) + (feq2[k] - feq[k]);
}

// cumulant.collide_d2q9 (correlated) on F[i][j] = f[3i + j]: raw moments
// along x then y, central moments, the relaxed covariance and its Isserlis
// k22, the back-shift by u + g along x then y, the inverse Vandermonde
__device__ __forceinline__ void cumulant_collide(const D2q9Args& a,
                                                 float* f) {
  float s[3][3], m[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s[0][j] = (f[j] + f[3 + j]) + f[6 + j];
    s[1][j] = -f[j] + f[6 + j];
    s[2][j] = f[j] + f[6 + j];
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    m[p][0] = (s[p][0] + s[p][1]) + s[p][2];
    m[p][1] = -s[p][0] + s[p][2];
    m[p][2] = s[p][0] + s[p][2];
  }
  const float rho = m[0][0];
  const float inv = 1.f / rho;
  const float ux = m[1][0] * inv, uy = m[0][1] * inv;
  // centralize along x, then along y
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float m0 = m[0][q], m1 = m[1][q], m2 = m[2][q];
    m[1][q] = m1 - ux * m0;
    m[2][q] = (m2 - (2.f * ux) * m1) + (ux * ux) * m0;
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float k0 = m[p][0], k1 = m[p][1], k2 = m[p][2];
    m[p][1] = k1 - uy * k0;
    m[p][2] = (k2 - (2.f * uy) * k1) + (uy * uy) * k0;
  }
  const float kxx = m[2][0], kyy = m[0][2], kxy = m[1][1];
  const float tr = kxx + kyy;
  const float tr_p = tr + a.omega_bulk * ((2.f * rho) * (1.f / 3.f) - tr);
  const float om1 = 1.f - a.omega;
  const float d = (om1 * (kxx - kyy)) * 0.5f;
  const float kxx_p = tr_p * 0.5f + d;
  const float kyy_p = tr_p * 0.5f - d;
  const float kxy_p = om1 * kxy;
  const float g22 = (kxx_p * kyy_p + (2.f * kxy_p) * kxy_p) * inv;
  float k[3][3] = {{rho, 0.f, kyy_p}, {0.f, kxy_p, 0.f}, {kxx_p, 0.f, g22}};
  // decentralize along x by ux + gx, then along y by uy + gy
  const float u = ux + a.gx, v = uy + a.gy;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float k0 = k[0][q], k1 = k[1][q], k2 = k[2][q];
    k[1][q] = k1 + u * k0;
    k[2][q] = (k2 + (2.f * u) * k1) + (u * u) * k0;
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float k0 = k[p][0], k1 = k[p][1], k2 = k[p][2];
    k[p][1] = k1 + v * k0;
    k[p][2] = (k2 + (2.f * v) * k1) + (v * v) * k0;
  }
  // the inverse Vandermonde (rows (0, -1/2, 1/2), (1, 0, -1), (0, 1/2, 1/2))
  // along x, then along y
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float m0 = k[0][q], m1 = k[1][q], m2 = k[2][q];
    k[0][q] = -0.5f * m1 + 0.5f * m2;
    k[1][q] = m0 - m2;
    k[2][q] = 0.5f * m1 + 0.5f * m2;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[3 * i] = -0.5f * k[i][1] + 0.5f * k[i][2];
    f[3 * i + 1] = k[i][0] - k[i][2];
    f[3 * i + 2] = 0.5f * k[i][1] + 0.5f * k[i][2];
  }
}

// d2q9_new's monomial basis M[r][i] = cx_i^p cy_i^q, (p, q) = POLYS[r]
__host__ __device__ constexpr int ipow(int b, int e) {
  return e == 0 ? 1 : b * ipow(b, e - 1);
}

__host__ __device__ constexpr int poly_p(int r) {
  constexpr int p[9] = {0, 1, 0, 2, 1, 0, 2, 1, 2};
  return p[r];
}

__host__ __device__ constexpr int poly_q(int r) {
  constexpr int q[9] = {0, 0, 1, 0, 1, 2, 1, 2, 2};
  return q[r];
}

// moment r of f over the nonzero coefficients, in index order
__device__ __forceinline__ float moment_new(int r, const float* f) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int c = ipow(cx(i), poly_p(r)) * ipow(cy(i), poly_q(r));
    if (c == 0) continue;
    if (first) acc = c > 0 ? f[i] : -f[i];
    else acc = c > 0 ? acc + f[i] : acc - f[i];
    first = false;
  }
  return acc;
}

// d2q9_new.collision_core: the raw-moment MRT, moments of order <= 2 at
// 1 - omega (or 1 - 1/tau at a Smagorinsky node), higher ones at gamma2
// (-gamma a/b at a Stab node, with -1 for a/b where |b| <= 1e-30)
__device__ __forceinline__ void new_collide(const D2q9Args& a, float* f,
                                            bool smag_node, bool stab_node) {
  float m[9], feq[9], meq[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) m[r] = moment_new(r, f);
  const float rho = m[0];
  equilibrium_f(rho, m[1] / rho, m[2] / rho, feq);
#pragma unroll
  for (int r = 0; r < 9; ++r) meq[r] = moment_new(r, feq);
  float neq[9];
#pragma unroll
  for (int r = 3; r < 9; ++r) neq[r] = m[r] - meq[r];
  const float gamma = 1.f - a.omega;
  const float q2 = (neq[3] * neq[3] + neq[4] * neq[4]) + neq[5] * neq[5];
  const float qs = (18.f * sqrtf(fmaxf(q2, 0.f))) * a.smag;
  const float tau0 = 1.f / (1.f - gamma);
  const float tau = 0.5f * (sqrtf(tau0 * tau0 + qs) + tau0);
  const float gamma_eff = smag_node ? 1.f - 1.f / tau : gamma;
  float ea = 0.f, eb = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) ea = ea + (a.p_sh[r][c] * neq[3 + r]) * neq[6 + c];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) eb = eb + (a.p_hh[r][c] * neq[6 + r]) * neq[6 + c];
  const float ratio = fabsf(eb) > 1e-30f ? ea / eb : -1.f;
  const float gamma2 = stab_node ? -gamma_eff * ratio : gamma_eff;
  float out[9];
#pragma unroll
  for (int r = 0; r < 9; ++r)
    out[r] = r < 3 ? meq[r]
             : meq[r] + (r < 6 ? gamma_eff : gamma2) * neq[r];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < 9; ++r) acc = acc + a.minv_new[i][r] * out[r];
    f[i] = acc;
  }
}

// A family node: the model's boundary case (exclusive: all are values of the
// BOUNDARY group), then its collision where it collides.
__device__ __forceinline__ void family_update(const D2q9Args& a, float* f,
                                              int flag, float vel,
                                              float den) {
  if (is_type(a, flag, CASE_WALL) || is_type(a, flag, CASE_SOLID)) {
    permute<false>(f);
  } else if constexpr (kModel == MODEL_NEW) {
    // d2q9's Zou/He list (d2q9_new keeps d2q9's population order)
    if (is_type(a, flag, CASE_EVELOCITY)) zou_he_x(f, vel, false, true);
    else if (is_type(a, flag, CASE_WPRESSURE)) zou_he_x(f, den, true, false);
    else if (is_type(a, flag, CASE_WVELOCITY)) zou_he_x(f, vel, true, true);
    else if (is_type(a, flag, CASE_EPRESSURE)) zou_he_x(f, den, false, false);
  } else {
    if (is_type(a, flag, CASE_WVELOCITY)) nebb<0, 1>(f, true, vel);
    else if (is_type(a, flag, CASE_WPRESSURE)) nebb<0, 1>(f, false, den);
    else if (is_type(a, flag, CASE_EVELOCITY)) nebb<0, -1>(f, true, vel);
    else if (is_type(a, flag, CASE_EPRESSURE)) nebb<0, -1>(f, false, den);
    else if (is_type(a, flag, CASE_TOPSYM) || is_type(a, flag, CASE_BOTTOMSYM))
      permute<true>(f);
  }
  if constexpr (kModel == MODEL_NEW) {
    if ((flag & a.mrt_mask) == a.mrt_val)
      new_collide(a, f, (flag & a.smag_mask) == a.smag_val,
                  (flag & a.stab_mask) == a.stab_val);
  } else {
    if ((flag & a.coll_mask) == 0) return;
    if constexpr (kModel == MODEL_SRT) bgk_collide<false>(a, f);
    else if constexpr (kModel == MODEL_LES) bgk_collide<true>(a, f);
    else if constexpr (kModel == MODEL_INC) inc_collide(a, f);
    else cumulant_collide(a, f);
  }
}

// One node of the compiled model; bc0/bc1 are d2q9's coupling planes.
__device__ __forceinline__ void node_update(const D2q9Args& a, float* f,
                                            int flag, float vel, float den,
                                            float bc0, float bc1) {
  if constexpr (kFamily) family_update(a, f, flag, vel, den);
  else mrt_update(a, f, flag, vel, den, bc0, bc1);
}

// One node of one step from global memory (periodic pulls).  `src` is
// written by other blocks between the steps of the resident kernel, so there
// (kCoherent) it is read through L2 only (__ldcg), never through the
// read-only path that assumes the data cannot change during the kernel.
template <bool kCoherent>
__device__ __forceinline__ void step_node(const D2q9Args& a, int y, int x,
                                          const float* src, float* dst,
                                          const float* __restrict__ fin,
                                          const int* __restrict__ flags,
                                          const float* __restrict__ vel,
                                          const float* __restrict__ den) {
  const size_t n = (size_t)a.ny * a.nx;
  const size_t idx = (size_t)y * a.nx + x;
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float* p = src + k * n + (size_t)wrap(y - ey_of(a, k), a.ny) * a.nx
                     + wrap(x - ex_of(a, k), a.nx);
    f[k] = kCoherent ? __ldcg(p) : __ldg(p);
  }
  if constexpr (kFamily)
    node_update(a, f, __ldg(flags + idx), __ldg(vel + idx), __ldg(den + idx),
                0.f, 0.f);
  else
    node_update(a, f, __ldg(flags + idx), __ldg(vel + idx), __ldg(den + idx),
                __ldg(fin + a.bc[0] * n + idx),
                __ldg(fin + a.bc[1] * n + idx));
#pragma unroll
  for (int k = 0; k < 9; ++k) dst[k * n + idx] = f[k];
}

// d2q9's planes past the populations (its BC planes) pass through; the
// family has none
__device__ __forceinline__ void copy_static_planes(const D2q9Args& a,
                                                   size_t idx,
                                                   const float* __restrict__ fin,
                                                   float* __restrict__ fout) {
  if constexpr (kFamily) return;
  const size_t n = (size_t)a.ny * a.nx;
  for (int p = 9; p < a.n_storage; ++p) fout[p * n + idx] = fin[p * n + idx];
}

__global__ void __launch_bounds__(256)
d2q9_step_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                 const int* __restrict__ flags, const float* __restrict__ vel,
                 const float* __restrict__ den, const D2q9Args a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.nx || y >= a.ny) return;
  step_node<false>(a, y, x, fin, fout, fin, flags, vel, den);
  copy_static_planes(a, (size_t)y * a.nx + x, fin, fout);
}

#define TX 32
#define TY 8
#define RX (TX + 4)   // tile + two-node ring (step-1 pulls)
#define RY (TY + 4)
#define EX (TX + 2)   // tile + one-node ring (step-1 nodes)
#define EY (TY + 2)
#define BX (kFamily ? 1 : EX)   // d2q9's BC planes over the ring (the
#define BY (kFamily ? 1 : EY)   // family stages none)

__global__ void __launch_bounds__(TX * TY)
d2q9_step2_kernel(const float* __restrict__ fin, float* __restrict__ fout,
                  const int* __restrict__ flags, const float* __restrict__ vel,
                  const float* __restrict__ den, const D2q9Args a) {
  __shared__ float sf[9][RY][RX];     // input populations, ring 2
  __shared__ float s1[9][EY][EX];     // step-1 populations, ring 1
  __shared__ int sflag[EY][EX];
  __shared__ float svel[EY][EX], sden[EY][EX], sbc0[BY][BX], sbc1[BY][BX];
  const size_t n = (size_t)a.ny * a.nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.x;

  for (int i = tid; i < RY * RX; i += TX * TY) {
    const int ly = i / RX, lx = i - ly * RX;
    const size_t g = (size_t)wrap(y0 - 2 + ly, a.ny) * a.nx
                     + wrap(x0 - 2 + lx, a.nx);
#pragma unroll
    for (int k = 0; k < 9; ++k) sf[k][ly][lx] = fin[k * n + g];
  }
  for (int i = tid; i < EY * EX; i += TX * TY) {
    const int ly = i / EX, lx = i - ly * EX;
    const size_t g = (size_t)wrap(y0 - 1 + ly, a.ny) * a.nx
                     + wrap(x0 - 1 + lx, a.nx);
    sflag[ly][lx] = flags[g];
    svel[ly][lx] = vel[g];
    sden[ly][lx] = den[g];
    if constexpr (!kFamily) {
      sbc0[ly][lx] = fin[a.bc[0] * n + g];
      sbc1[ly][lx] = fin[a.bc[1] * n + g];
    }
  }
  __syncthreads();

  // step 1 on the tile extended by one node
  for (int i = tid; i < EY * EX; i += TX * TY) {
    const int ly = i / EX, lx = i - ly * EX;
    float f[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      f[k] = sf[k][ly + 1 - ey_of(a, k)][lx + 1 - ex_of(a, k)];
    if constexpr (kFamily)
      node_update(a, f, sflag[ly][lx], svel[ly][lx], sden[ly][lx], 0.f, 0.f);
    else
      node_update(a, f, sflag[ly][lx], svel[ly][lx], sden[ly][lx],
                  sbc0[ly][lx], sbc1[ly][lx]);
#pragma unroll
    for (int k = 0; k < 9; ++k) s1[k][ly][lx] = f[k];
  }
  __syncthreads();

  // step 2 on the tile, one node per thread; the ragged edge is masked
  const int ty = tid / TX, tx = tid - ty * TX;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= a.ny || x >= a.nx) return;
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    f[k] = s1[k][ty + 1 - ey_of(a, k)][tx + 1 - ex_of(a, k)];
  if constexpr (kFamily)
    node_update(a, f, sflag[ty + 1][tx + 1], svel[ty + 1][tx + 1],
                sden[ty + 1][tx + 1], 0.f, 0.f);
  else
    node_update(a, f, sflag[ty + 1][tx + 1], svel[ty + 1][tx + 1],
                sden[ty + 1][tx + 1], sbc0[ty + 1][tx + 1],
                sbc1[ty + 1][tx + 1]);
  const size_t idx = (size_t)y * a.nx + x;
#pragma unroll
  for (int k = 0; k < 9; ++k) fout[k * n + idx] = f[k];
  copy_static_planes(a, idx, fin, fout);
}

#define RESIDENT_STEPS 8   // even: the ping-pong ends in fout

__global__ void __launch_bounds__(256)
d2q9_resident8_kernel(const float* __restrict__ fin, float* fout,
                      float* scratch, const int* __restrict__ flags,
                      const float* __restrict__ vel,
                      const float* __restrict__ den, const D2q9Args a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.ny * a.nx;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int idx = first; idx < n; idx += stride)
    copy_static_planes(a, idx, fin, fout);
  const float* src = fin;
  float* dst = scratch;
  for (int s = 0; s < RESIDENT_STEPS; ++s) {
    for (int idx = first; idx < n; idx += stride) {
      const int y = idx / a.nx, x = idx - y * a.nx;
      step_node<true>(a, y, x, src, dst, fin, flags, vel, den);
    }
    grid.sync();
    src = dst;
    dst = (dst == scratch) ? fout : scratch;
  }
}

extern "C" {

const char* d2q9_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The model this library was built for and its compiled velocity set (d2q9
// takes its velocities from D2q9Args and reports its own order).
void d2q9_velocity_set(int* ex, int* ey, int* model) {
  for (int k = 0; k < 9; ++k) {
    ex[k] = cx(k);
    ey[k] = cy(k);
  }
  *model = kModel;
}

// Whether the device can launch cooperative kernels, and how many blocks of
// d2q9_resident8 can be resident at once (the largest cooperative grid).
int d2q9_resident8_capacity(int device, int* cooperative, int* max_blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, d2q9_resident8_kernel, 256, 0);
  if (e != cudaSuccess) return (int)e;
  *max_blocks = per_sm * sms;
  return 0;
}

int d2q9_step(const float* fin, float* fout, const int* flags,
              const float* vel, const float* den, const D2q9Args* a,
              int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(32, 8);
  const dim3 grid((a->nx + 31) / 32, (a->ny + 7) / 8);
  d2q9_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      fin, fout, flags, vel, den, *a);
  return (int)cudaGetLastError();
}

int d2q9_step2(const float* fin, float* fout, const int* flags,
               const float* vel, const float* den, const D2q9Args* a,
               int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + TX - 1) / TX, (a->ny + TY - 1) / TY);
  d2q9_step2_kernel<<<grid, TX * TY, 0, (cudaStream_t)stream>>>(
      fin, fout, flags, vel, den, *a);
  return (int)cudaGetLastError();
}

int d2q9_resident8(const float* fin, float* fout, float* scratch,
                   const int* flags, const float* vel, const float* den,
                   const D2q9Args* a, int blocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  D2q9Args args = *a;
  void* params[] = {(void*)&fin, (void*)&fout, (void*)&scratch,
                    (void*)&flags, (void*)&vel, (void*)&den, (void*)&args};
  e = cudaLaunchCooperativeKernel((const void*)d2q9_resident8_kernel,
                                  dim3(blocks), dim3(256), params, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
