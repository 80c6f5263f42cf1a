// z-slab collide-stream kernels for Hopper (sm_90a): the d3q27_cumulant,
// d3q27_BGK, d3q27_BGK_galcor, d3q19 and d3q19_les models.
//
// One node update (pull, the boundary dispatch on the node's flag, the
// model's collision where the COLLISION group is set, and for the cumulant
// the running averages) shared by two kernels:
//
//   d3q27_step   one thread per node, one step: the pulled populations are
//                read straight from global memory with periodic indices,
//                neighbouring threads on neighbouring x
//                (replaces tclb_tpu/ops/pallas_d3q.py:make_pallas_iterate's
//                single-step ring and block kernels);
//   d3q27_step2  two steps per launch (replaces make_pallas_iterate's fused
//                kernel at K=2).  A block owns a 32x8 (x, y) column of the
//                lattice over a run of z planes and marches up z: for each
//                plane it computes step 1 on the column extended by one node
//                in x and y (one thread per extended node, pulls from global
//                memory) into a ring of step-1 planes in shared memory, then
//                step 2 of the plane below from that ring.  The ring keeps of
//                each plane only the populations step 2 still reads: those
//                moving down in z for one iteration, at rest in z for two,
//                moving up for three (54 population planes of the extended
//                column for the 27-velocity models, 5 + 2 x 9 + 3 x 5 = 38
//                for d3q19).  The one-node ring of step 1 is recomputed by
//                each block with the ring nodes' true flags, zonal values
//                and SynthT planes.
//
// The model is chosen at compile time: D3Q_MODEL (0, the default, is
// d3q27_cumulant; 1..4 d3q27_BGK, d3q27_BGK_galcor, d3q19, d3q19_les, the
// reference's _SUPPORTED, pallas_d3q.py:58) builds one library per model,
// each holding only its own branch, so the cumulant's code is what it was
// without the others.  Each build compiles in its model's velocity set:
// the tensor-product order of tclb_tpu_torch/ops/cumulant.py:
// velocity_set(3) for the 27-velocity models (k = 9i + 3j + l holds the
// velocity (i-1, j-1, l-1), so the bounce-back partner of k is 26 - k and
// the populations reshape to the (x, y, z) moment axes of the cumulant),
// lbm.d3q19_velocities()'s shell order for d3q19 and d3q19_les.  Weights,
// the NEBB face populations and the ring's z groups derive from that set
// in constexpr functions; bounce-back partners, mirrors and ring ranks are
// closed forms held against it by a static_assert; the wrapper reads the
// set back (d3q27_model_info) and checks it, the storage stack and the
// case count against the registry.
//
// The storage stack is f[0..26], SynthTX/Y/Z, avgP, avgUX/Y/Z (34 planes)
// for the cumulant, the Q populations alone for the others.  The cumulant's
// boundary cases are its W/E/S/N velocity and pressure faces, the N/S
// symmetries and the turbulent inlet; the others' (family.base_def with
// faces "WE", symmetries "NS") Wall/Solid, the W/E velocity and pressure
// faces and the N/S symmetries.  Collisions follow pallas_d3q.py's _step
// (:361-436): the cumulant (ops/cumulant.py:collide_d3q27, with force and
// Galilean correction); BGK with the body-force equilibrium difference,
// galcor with the equilibrium's third-order terms (models/d3q27_bgk.py);
// d3q19's two-rate MRT (lbm.two_rate_relax on the stress rows M19[4:10],
// which arrive in D3q27Args with their normalised transposes); d3q19_les's
// BGK at the Smagorinsky rate.  The four other models are built with
// --fmad=false and written in their plain versions' order of operations,
// so they round where the plain PyTorch versions do, but for the
// populations' sum rho (torch.sum's order there).
//
// Both kernels are bound by device-memory bytes on this card: a cumulant
// node reads 34 planes and its flag and writes 34 planes (276 B) for about
// 540 flops, a BGK node 220 B, a d3q19 node 156 B.  Zonal Velocity/Density
// (and the cumulant's Turbulence) are not read as planes: the kernels look
// them up through the flag's zone bits in a (rows, zone_max) table, which
// stays in cache.  Node-type masks and values and the settings arrive in
// D3q27Args.  No globals are computed (the engine's trailing eager step
// does); the cumulant's SynthT planes are copied through.
//
// The storage ladder: both kernels also take a bf16 stack at rest
// (d3q27_step_bf16, d3q27_step2_bf16: the same templates with
// S = __nv_bfloat16).  Each population plane is widened where it is pulled
// from device memory and narrowed where it is stored, through
// csrc/storage.cuh (load_plane, store_plane), with the plane's DDF shift
// from core/shift.py, a __grid_constant__ launch argument as K4's: the
// lattice weight under the shifted representation, 0 under the raw one
// and for the cumulant's SynthT and average planes, which pass through as
// plain casts.  The ring of step-1 planes in shared memory stays f32, so
// d3q27_step2 narrows once per two steps (as pallas_d3q.py's fused kernel
// does, :797-840) and its averages take both steps' increments before they
// narrow.  A bf16 node moves a little over half the bytes of an f32 one
// (the cumulant: 140 B against 276 B).  f32 storage ignores the shifts:
// its outputs are those of plain f32 loads and stores, and every plane it
// reads takes the read-only path (fin is never written in a launch).
//
// Plain C interface (loaded with ctypes); every entry returns the CUDA error
// code of its launch.

#include <cuda_runtime.h>

#include "models/d3q27_moments.cuh"
#include "storage.cuh"

#ifndef D3Q_MODEL
#define D3Q_MODEL 0
#endif
enum { MODEL_CUMULANT = 0, MODEL_BGK, MODEL_GALCOR, MODEL_D3Q19,
       MODEL_D3Q19_LES };
constexpr int kModel = D3Q_MODEL;
static_assert(kModel >= MODEL_CUMULANT && kModel <= MODEL_D3Q19_LES,
              "D3Q_MODEL");
constexpr bool kCumulant = kModel == MODEL_CUMULANT;
constexpr bool kQ19 = kModel == MODEL_D3Q19 || kModel == MODEL_D3Q19_LES;

constexpr int Q = kQ19 ? 19 : 27;
constexpr int N_STORAGE = kCumulant ? 34 : Q;
#define P_SYNTH 27      // SynthTX, SynthTY, SynthTZ (the cumulant's)
#define P_AVGP 30       // avgP, then avgUX, avgUY, avgUZ (the cumulant's)

// boundary cases, in the order family.boundary_cases lists them
#if D3Q_MODEL == 0
enum {
  CASE_WALL = 0, CASE_SOLID, CASE_WVELOCITY, CASE_WPRESSURE, CASE_EVELOCITY,
  CASE_EPRESSURE, CASE_SVELOCITY, CASE_SPRESSURE, CASE_SSYMMETRY,
  CASE_NVELOCITY, CASE_NPRESSURE, CASE_NSYMMETRY, CASE_WTURBULENT, N_CASES
};
#else
enum {
  CASE_WALL = 0, CASE_SOLID, CASE_WVELOCITY, CASE_WPRESSURE, CASE_EVELOCITY,
  CASE_EPRESSURE, CASE_SSYMMETRY, CASE_NSYMMETRY, N_CASES
};
#endif
#define MAX_CASES 13    // the case arrays' length in every build
static_assert(N_CASES <= MAX_CASES, "MAX_CASES");

struct D3q27Args {
  int nz, ny, nx;
  int zc;                      // z planes per d3q27_step2 block
  int case_mask[MAX_CASES], case_val[MAX_CASES];
  int coll_mask;               // COLLISION group mask
  int buffer_mask, buffer_val;
  int zone_shift, zone_max;
  float omega, omega_buffer, omega_bulk, galilean;
  float force[3];              // Force + Gravitation, per axis
  // d3q19: S_high and the stress rows M19[4:10] with their normalised
  // transposes (M19[4:10] / |row|^2)^T; d3q19_les: Smag
  float s_high, smag;
  float m_stress[6][19];
  float m_back[19][6];
};

// lbm.d3q19_velocities(): rest; the six axis vectors (+x, -x, +y, ...);
// the twelve edges, for the axis pairs (x, y), (x, z), (y, z) in turn,
// signs (+, +), (+, -), (-, +), (-, -).  Arithmetic, not a table: it folds
// to a constant in every unrolled loop, where a table could stay in local
// memory.
__host__ __device__ constexpr int comp19(int k, int axis) {
  if (k == 0) return 0;
  if (k <= 6) return axis == (k - 1) / 2 ? ((k - 1) % 2 ? -1 : 1) : 0;
  const int pair = (k - 7) / 4, s = (k - 7) % 4;
  const int lo = pair == 2 ? 1 : 0, hi = pair == 0 ? 1 : 2;
  return axis == lo ? (s < 2 ? 1 : -1) : axis == hi ? (s % 2 ? -1 : 1) : 0;
}

// the compiled model's velocity set
__host__ __device__ constexpr int comp(int k, int axis) {
  if constexpr (kQ19) return comp19(k, axis);
  return axis == 0 ? k / 9 - 1 : (axis == 1 ? (k / 3) % 3 - 1 : k % 3 - 1);
}

// The bounce-back partner, the y mirror and the rank among the populations
// that move as k does in z, in closed form: a search over the set does not
// fold to a constant inside the kernels' unrolled loops, and the select
// chains and loops it leaves cost d3q27_step2 several times its bytes.
// tables_match() holds each against the velocity set at compile time.
__host__ __device__ constexpr int opp(int k) {
  if constexpr (kQ19) {
    if (k == 0) return 0;
    if (k <= 6) return ((k - 1) ^ 1) + 1;
    return 7 + 4 * ((k - 7) / 4) + 3 - (k - 7) % 4;
  }
  return Q - 1 - k;
}

__host__ __device__ constexpr int mirror(int k) {
  if constexpr (kQ19) {
    if (k == 3 || k == 4) return 7 - k;
    if (k < 7) return k;
    const int pair = (k - 7) / 4, s = (k - 7) % 4;
    return pair == 1 ? k : 7 + 4 * pair + (s ^ (pair == 0 ? 1 : 2));
  }
  return k + 6 - 6 * ((k / 3) % 3);
}

__host__ __device__ constexpr int zrank(int k) {
  // d3q19: ez = -1 holds 6, 12, 14, 16, 18; ez = 0 holds 0-4, 7-10;
  // ez = +1 holds 5, 11, 13, 15, 17
  if constexpr (kQ19)
    return k <= 4 ? k : k <= 6 ? 0 : k <= 10 ? k - 2 : (k - 11) / 2 + 1;
  return k / 3;
}

// populations that move by ez in z
__host__ __device__ constexpr int zcount(int ez) {
  int n = 0;
  for (int j = 0; j < Q; ++j) n += comp(j, 2) == ez;
  return n;
}

constexpr bool tables_match() {
  for (int k = 0; k < Q; ++k) {
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += comp(j, 2) == comp(k, 2);
    for (int d = 0; d < 3; ++d)
      if (comp(opp(k), d) != -comp(k, d)
          || comp(mirror(k), d) != (d == 1 ? -comp(k, d) : comp(k, d)))
        return false;
    if (zrank(k) != rank) return false;
  }
  return true;
}
static_assert(tables_match(), "opp, mirror or zrank disagree with the set");

constexpr int NZ_DOWN = zcount(-1), NZ_REST = zcount(0), NZ_UP = zcount(1);

__host__ __device__ constexpr int speed2(int k) {
  return comp(k, 0) * comp(k, 0) + comp(k, 1) * comp(k, 1)
         + comp(k, 2) * comp(k, 2);
}

// lattice weight by speed shell (lbm.weights)
__host__ __device__ constexpr float weight(int k) {
  if constexpr (kQ19)
    return speed2(k) == 0 ? 1.f / 3.f : speed2(k) == 1 ? 1.f / 18.f
                                                        : 1.f / 36.f;
  return speed2(k) == 0 ? 8.f / 27.f
         : speed2(k) == 1 ? 2.f / 27.f
         : speed2(k) == 2 ? 1.f / 54.f : 1.f / 216.f;
}

// the same in double, as the plain versions form their coefficients
// before they meet a float32 plane
__host__ __device__ constexpr double weight_d(int k) {
  if constexpr (kQ19)
    return speed2(k) == 0 ? 1.0 / 3.0 : speed2(k) == 1 ? 1.0 / 18.0
                                                        : 1.0 / 36.0;
  return speed2(k) == 0 ? 8.0 / 27.0
         : speed2(k) == 1 ? 2.0 / 27.0
         : speed2(k) == 2 ? 1.0 / 54.0 : 1.0 / 216.0;
}

// the stack's per-plane shifts (csrc/storage.cuh)
using Shift = PlaneShift<N_STORAGE>;

// f[idx] as selects: the index folds to a constant where the compiler sees
// it, and a runtime index into f would move the populations to local memory
__device__ __forceinline__ float pick(const float* f, int idx) {
  float v = f[0];
#pragma unroll
  for (int j = 1; j < Q; ++j) v = (idx == j) ? f[j] : v;
  return v;
}

// f <- f[perm] for the bounce-back pairing or the y mirror (lbm.perm)
template <bool kMirror>
__device__ __forceinline__ void permute(float* f) {
  float g[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) g[k] = pick(f, kMirror ? mirror(k) : opp(k));
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = g[k];
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// the three periodic pull sources i - c for c = -1, 0, +1 (i in [0, n))
__device__ __forceinline__ void sources(int i, int n, int* s) {
  s[0] = i + 1 == n ? 0 : i + 1;
  s[1] = i;
  s[2] = i == 0 ? n - 1 : i - 1;
}

__device__ __forceinline__ bool is_type(const D3q27Args& a, int flag, int c) {
  return (flag & a.case_mask[c]) == a.case_val[c];
}

// Non-equilibrium bounce-back on the face normal to AXIS, fluid toward
// SIDE * +axis (lbm.nebb_boundary): `value` is the imposed +axis velocity
// (velocity) or density (pressure); vt_lo/vt_hi the imposed tangential
// velocities on the two other axes in increasing order.
template <int AXIS, int SIDE>
__device__ __forceinline__ void nebb(float* f, bool velocity, float value,
                                     float vt_lo, float vt_hi, bool has_vt) {
  float s_t = 0.f, s_o = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (comp(k, AXIS) == 0) s_t += f[k];
    else if (comp(k, AXIS) == -SIDE) s_o += f[k];
  }
  float rho, un;
  if (velocity) {
    un = value;
    rho = (s_t + 2.f * s_o) / (1.f - SIDE * un);
  } else {
    rho = value;
    un = SIDE * (1.f - (s_t + 2.f * s_o) / rho);
  }
  float jt[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AXIS) continue;
    float qt = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (comp(k, AXIS) == 0 && comp(k, t) != 0) qt += comp(k, t) * f[k];
    jt[t] = -3.f * qt;
  }
  if (has_vt) {
    const int lo = AXIS == 0 ? 1 : 0, hi = AXIS == 2 ? 1 : 2;
    jt[lo] += 3.f * rho * vt_lo;
    jt[hi] += 3.f * rho * vt_hi;
  }
  if constexpr (kCumulant) {
    const float run = rho * un;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (comp(k, AXIS) != SIDE) continue;
      float corr = 6.f * weight(k) * comp(k, AXIS) * run;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (t != AXIS && comp(k, t) != 0)
          corr += 6.f * weight(k) * comp(k, t) * jt[t];
      f[k] = f[Q - 1 - k] + corr;   // the partner of an unknown is a known
    }
  } else {
    // the plain version's order: (6 w e_n rho) un, then each tangential
    // 6 w e_t J_t, the coefficients formed in double
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (comp(k, AXIS) != SIDE) continue;
      float corr = ((float)(6.0 * weight_d(k) * comp(k, AXIS)) * rho) * un;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (t != AXIS && comp(k, t) != 0)
          corr = corr + (float)(6.0 * weight_d(k) * comp(k, t)) * jt[t];
      f[k] = pick(f, opp(k)) + corr;
    }
  }
}

// f[k] <- f[mirror(k)] with the y component mirrored
__device__ __forceinline__ void mirror_y(float* f) {
  if constexpr (kQ19) {
    permute<true>(f);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const float t = f[9 * i + l];
        f[9 * i + l] = f[9 * i + 6 + l];
        f[9 * i + 6 + l] = t;
      }
  }
}

__device__ __forceinline__ void bounce_back(float* f) {
  if constexpr (kQ19) {
    permute<false>(f);
  } else {
#pragma unroll
    for (int k = 0; k < Q / 2; ++k) {
      const float t = f[k];
      f[k] = f[Q - 1 - k];
      f[Q - 1 - k] = t;
    }
  }
}

// The boundary case the node's flag selects (the cases are exclusive: all
// are values of the BOUNDARY group).  `ztab` holds the zonal Velocity and
// Density rows (and the cumulant's Turbulence); SynthT is read only at
// turbulent-inlet nodes (`w`: the stack's per-plane shifts).
template <class S>
__device__ __forceinline__ void boundary(const D3q27Args& a, float* f,
                                         int flag,
                                         const float* __restrict__ ztab,
                                         const S* __restrict__ fin,
                                         const float* w, size_t n,
                                         size_t idx) {
  const int zone = flag >> a.zone_shift;
  const float* vel = ztab + zone;
  const float* den = ztab + a.zone_max + zone;
#if D3Q_MODEL != 0
  if (is_type(a, flag, CASE_WALL) || is_type(a, flag, CASE_SOLID))
    bounce_back(f);
  else if (is_type(a, flag, CASE_WVELOCITY))
    nebb<0, 1>(f, true, __ldg(vel), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_WPRESSURE))
    nebb<0, 1>(f, false, __ldg(den), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_EVELOCITY))
    nebb<0, -1>(f, true, __ldg(vel), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_EPRESSURE))
    nebb<0, -1>(f, false, __ldg(den), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_SSYMMETRY) || is_type(a, flag, CASE_NSYMMETRY))
    mirror_y(f);
#else
  if (is_type(a, flag, CASE_WALL) || is_type(a, flag, CASE_SOLID))
    bounce_back(f);
  else if (is_type(a, flag, CASE_WVELOCITY))
    nebb<0, 1>(f, true, __ldg(vel), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_WPRESSURE))
    nebb<0, 1>(f, false, __ldg(den), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_EVELOCITY))
    nebb<0, -1>(f, true, __ldg(vel), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_EPRESSURE))
    nebb<0, -1>(f, false, __ldg(den), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_SVELOCITY))
    nebb<1, 1>(f, true, __ldg(vel), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_SPRESSURE))
    nebb<1, 1>(f, false, __ldg(den), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_SSYMMETRY) || is_type(a, flag, CASE_NSYMMETRY))
    mirror_y(f);
  else if (is_type(a, flag, CASE_NVELOCITY))
    nebb<1, -1>(f, true, __ldg(vel), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_NPRESSURE))
    nebb<1, -1>(f, false, __ldg(den), 0.f, 0.f, false);
  else if (is_type(a, flag, CASE_WTURBULENT)) {
    const float turb = __ldg(ztab + 2 * a.zone_max + zone);
    nebb<0, 1>(f, true,
               __ldg(vel) + turb * load_plane<false>(
                                       fin + P_SYNTH * n + idx, w, P_SYNTH),
               turb * load_plane<false>(fin + (P_SYNTH + 1) * n + idx, w,
                                        P_SYNTH + 1),
               turb * load_plane<false>(fin + (P_SYNTH + 2) * n + idx, w,
                                        P_SYNTH + 2), true);
  }
#endif
}

// Cumulant collision (csrc/models/d3q27_moments.cuh: ops/cumulant.py:
// collide_d3q27, correlated, with force and Galilean correction) where
// `collide`; rho and u (before the force shift) for the averages
// everywhere.
__device__ __forceinline__ void collide(const D3q27Args& a, float* f,
                                        float omega, bool collide,
                                        float& rho_o, float& ux_o,
                                        float& uy_o, float& uz_o) {
  d3q27_moments::collide<true, true>(f, omega, a.omega_bulk, a.force,
                                     a.galilean, collide, rho_o, ux_o, uy_o,
                                     uz_o);
}
// ---------------------------------------------------------------------------
// The other models (D3Q_MODEL 1..4).  Each function follows its plain
// PyTorch version's order of operations; a division by a Python number
// there is a multiplication by its float reciprocal here, as PyTorch
// computes it on the card (x / CS2 is x * 3.f).
// ---------------------------------------------------------------------------

// sum_k c_k f[k] over the nonzero unit coefficients, in index order
// (lbm.edot); kAxis takes the velocity component as c
template <int kAxis>
__device__ __forceinline__ float edot(const float* f) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int c = comp(k, kAxis);
    if (c == 0) continue;
    if (first) acc = c > 0 ? f[k] : -f[k];
    else acc = c > 0 ? acc + f[k] : acc - f[k];
    first = false;
  }
  return acc;
}

// the populations' sum in index order (torch.sum's order differs by ulps;
// models/d3q19.py's plane_sum is this order)
__device__ __forceinline__ float rho_of(const float* f) {
  float rho = f[0];
#pragma unroll
  for (int k = 1; k < Q; ++k) rho = rho + f[k];
  return rho;
}

// e.u of a moving population as lbm.equilibrium forms it: the signed
// components over the nonzero axes, added in axis order
__device__ __forceinline__ float e_dot(int k, const float* u) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int c = comp(k, d);
    if (c == 0) continue;
    const float t = c > 0 ? u[d] : -u[d];
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

// lbm.equilibrium (w rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 |u|^2)), with
// models/d3q27_bgk.py's third-order terms ((e.u)^3 - (e.u)|u|^2) 4.5 where
// kGalcor
template <bool kGalcor>
__device__ __forceinline__ void equilibrium(float rho, const float* u,
                                            float* feq) {
  const float usq = (u[0] * u[0] + u[1] * u[1]) + u[2] * u[2];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float common;
    if (speed2(k) == 0) {
      common = 1.f - usq * 1.5f;
    } else {
      const float eu = e_dot(k, u);
      common = ((1.f + eu * 3.f) + (eu * eu) * 4.5f) - usq * 1.5f;
      if constexpr (kGalcor)
        common = common + (((eu * eu) * eu) * 4.5f - (eu * usq) * 4.5f);
    }
    feq[k] = ((float)weight_d(k) * rho) * common;
  }
}

// rho, u = j / rho and feq; the body-force equilibrium difference
// f + (feq(u + g) - feq(u)) closes every model's collision
template <bool kGalcor>
__device__ __forceinline__ float moments(const float* f, float* u,
                                         float* feq) {
  const float rho = rho_of(f);
  u[0] = edot<0>(f) / rho;
  u[1] = edot<1>(f) / rho;
  u[2] = edot<2>(f) / rho;
  equilibrium<kGalcor>(rho, u, feq);
  return rho;
}

template <bool kGalcor>
__device__ __forceinline__ void add_force(const D3q27Args& a, float rho,
                                          const float* u, const float* feq,
                                          float* f) {
  const float u2[3] = {u[0] + a.force[0], u[1] + a.force[1],
                       u[2] + a.force[2]};
  float feq2[Q];
  equilibrium<kGalcor>(rho, u2, feq2);
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = f[k] + (feq2[k] - feq[k]);
}

// models/d3q27_bgk.py:collide (d3q27_BGK, d3q27_BGK_galcor)
template <bool kGalcor>
__device__ __forceinline__ void bgk_collide(const D3q27Args& a, float* f) {
  float u[3], feq[Q];
  const float rho = moments<kGalcor>(f, u, feq);
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = f[k] + a.omega * (feq[k] - f[k]);
  add_force<kGalcor>(a, rho, u, feq, f);
}

// models/d3q19.py:relax: lbm.two_rate_relax on the stress rows, then the
// equilibrium at the forced velocity.  The rows and their normalised
// transposes come from D3q27Args; a zero coefficient adds an exact zero
// and a unit one an exact product, so the dot products in index order
// round as lbm.unrolled_matvec's
__device__ __forceinline__ void mrt_collide(const D3q27Args& a, float* f) {
  float u[3], feq[Q];
  const float rho = moments<false>(f, u, feq);
  float fneq[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) fneq[k] = f[k] - feq[k];
  float mn[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k) acc = acc + a.m_stress[r][k] * fneq[k];
    mn[r] = acc;
  }
  const float keep_stress = 1.f - a.omega, keep_high = 1.f - a.s_high;
  const float d = keep_stress - keep_high;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    float back = 0.f;
#pragma unroll
    for (int r = 0; r < 6; ++r) back = back + a.m_back[k][r] * mn[r];
    f[k] = keep_high * fneq[k] + d * back;
  }
  const float u2[3] = {u[0] + a.force[0], u[1] + a.force[1],
                       u[2] + a.force[2]};
  float feq2[Q];
  equilibrium<false>(rho, u2, feq2);
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = f[k] + feq2[k];
}

// models/d3q19_les.py:collide: lbm.smagorinsky_omega_unrolled (|Pi|^2 over
// xx, xy, xz, yy, yz, zz), then BGK at that rate
__device__ __forceinline__ void les_collide(const D3q27Args& a, float* f) {
  float u[3], feq[Q];
  const float rho = moments<false>(f, u, feq);
  float pi2 = 0.f;
  bool first = true;
#pragma unroll
  for (int d0 = 0; d0 < 3; ++d0)
#pragma unroll
    for (int d1 = d0; d1 < 3; ++d1) {
      float p = 0.f;
      bool first_k = true;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const int c = comp(k, d0) * comp(k, d1);
        if (c == 0) continue;
        const float t = c > 0 ? f[k] - feq[k] : -(f[k] - feq[k]);
        p = first_k ? t : p + t;
        first_k = false;
      }
      const float term = d0 == d1 ? p * p : (p * p) * 2.f;
      pi2 = first ? term : pi2 + term;
      first = false;
    }
  const float tau0 = 1.f / a.omega;
  const float c = ((float)(18.0 * 1.4142135623730951) * a.smag) * a.smag;
  const float tau_eff =
      0.5f * (tau0 + sqrtf(tau0 * tau0 + (c * sqrtf(pi2)) / rho));
  const float om = 1.f / tau_eff;
#pragma unroll
  for (int k = 0; k < Q; ++k) f[k] = f[k] + om * (feq[k] - f[k]);
  add_force<false>(a, rho, u, feq, f);
}

// One node after its pull: boundary, then collision where the COLLISION
// group is set.  The cumulant takes omega from the Buffer layer select and
// returns the averages' increments (rho - 1) / 3 and u in `inc`; the other
// models leave `inc` alone.
template <class S>
__device__ __forceinline__ void node_update(const D3q27Args& a, float* f,
                                            int flag,
                                            const float* __restrict__ ztab,
                                            const S* __restrict__ fin,
                                            const float* w, size_t n,
                                            size_t idx, float* inc) {
  boundary(a, f, flag, ztab, fin, w, n, idx);
  if constexpr (kCumulant) {
    const float omega = (flag & a.buffer_mask) == a.buffer_val
                            ? a.omega_buffer : a.omega;
    float rho;
    collide(a, f, omega, (flag & a.coll_mask) != 0, rho, inc[1], inc[2],
            inc[3]);
    inc[0] = (rho - 1.f) / 3.f;
  } else {
    if ((flag & a.coll_mask) == 0) return;
    if constexpr (kModel == MODEL_BGK) bgk_collide<false>(a, f);
    else if constexpr (kModel == MODEL_GALCOR) bgk_collide<true>(a, f);
    else if constexpr (kModel == MODEL_D3Q19) mrt_collide(a, f);
    else les_collide(a, f);
  }
}

// f_k(z, y, x) <- fin_k(z - ez, y - ey, x - ex), periodic
template <class S>
__device__ __forceinline__ void pull(const D3q27Args& a,
                                     const S* __restrict__ fin,
                                     const float* w, int z, int y, int x,
                                     float* f) {
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  int sz[3], sy[3], sx[3];
  sources(z, a.nz, sz);
  sources(y, a.ny, sy);
  sources(x, a.nx, sx);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const size_t g = ((size_t)sz[comp(k, 2) + 1] * a.ny + sy[comp(k, 1) + 1])
                     * a.nx + sx[comp(k, 0) + 1];
    f[k] = load_plane<false>(fin + k * n + g, w, k);
  }
}

// Write a node's populations; the cumulant also copies its SynthT planes
// and adds the averages' increments (inc1 then inc2, as consecutive steps
// would).
template <class S>
__device__ __forceinline__ void store(const S* __restrict__ fin,
                                      S* __restrict__ fout, size_t n,
                                      size_t idx, const float* f,
                                      const float* inc1, const float* inc2,
                                      const float* w) {
#pragma unroll
  for (int k = 0; k < Q; ++k) store_plane(fout + k * n + idx, f[k], w, k);
  if constexpr (kCumulant) {
#pragma unroll
    for (int p = P_SYNTH; p < P_AVGP; ++p)
      store_plane(fout + p * n + idx,
                  load_plane<false>(fin + p * n + idx, w, p), w, p);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = P_AVGP + c;
      float v = load_plane<false>(fin + p * n + idx, w, p) + inc1[c];
      if (inc2) v = v + inc2[c];
      store_plane(fout + p * n + idx, v, w, p);
    }
  }
}

#define STEP_TX 32
#define STEP_TY 4

// `sh`: the stack's per-plane shifts (read by S = bf16 only)
template <class S>
__global__ void __launch_bounds__(STEP_TX * STEP_TY)
d3q27_step_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                  const int* __restrict__ flags,
                  const float* __restrict__ ztab, const D3q27Args a,
                  const __grid_constant__ Shift sh) {
  const int x = blockIdx.x * STEP_TX + threadIdx.x;
  const int y = blockIdx.y * STEP_TY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= a.nx || y >= a.ny) return;
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  const size_t idx = ((size_t)z * a.ny + y) * a.nx + x;
  float f[Q], inc[4];
  pull(a, fin, sh.w, z, y, x, f);
  node_update(a, f, __ldg(flags + idx), ztab, fin, sh.w, n, idx, inc);
  store(fin, fout, n, idx, f, inc, nullptr, sh.w);
}

// d3q27_step2 tiling: a TX x TY output column, its step-1 extension by one
// node on each side (EXT_N nodes, one thread each), a ring of step-1 planes
// in shared memory.  Population k moves by ez = comp(k, 2) in z; those of
// one ez form a group, k's place in it is zrank(k).
#define TX 32
#define TY 8
#define EXT_X (TX + 2)
#define EXT_Y (TY + 2)
#define EXT_N (EXT_X * EXT_Y)
#define STEP2_THREADS (((EXT_N + 31) / 32) * 32)
// the ring's population planes: ez = -1 of the last plane, ez = 0 of the
// last two, ez = +1 of the last three
constexpr int RING_PLANES = NZ_DOWN + 2 * NZ_REST + 3 * NZ_UP;
// the cumulant's averages: step-1 increments of the last two planes
constexpr int SINC_FLOATS = kCumulant ? 2 * 4 * TX * TY : 0;

// dynamic shared memory of one d3q27_step2 block
#define STEP2_SMEM \
  ((size_t)(RING_PLANES * EXT_N + SINC_FLOATS) * sizeof(float))

// where step 1 leaves population k of ring plane r (the 27-velocity
// models' groups are nine planes each: the expression the cumulant's
// build has always had)
__device__ __forceinline__ float* ring_slot(float* smem, int k, int r) {
  if constexpr (Q == 27) {
    const int ez = k % 3 - 1, j = k / 3;
    const int g = ez == -1 ? 0 : (ez == 0 ? 1 + r % 2 : 3 + r % 3);
    return smem + g * (9 * EXT_N) + j * EXT_N;
  }
  const int ez = comp(k, 2);
  const int g = ez == -1 ? 0
                : ez == 0 ? NZ_DOWN + (r % 2) * NZ_REST
                          : NZ_DOWN + 2 * NZ_REST + (r % 3) * NZ_UP;
  return smem + (g + zrank(k)) * EXT_N;
}

template <class S>
__global__ void __launch_bounds__(STEP2_THREADS, 2)
d3q27_step2_kernel(const S* __restrict__ fin, S* __restrict__ fout,
                   const int* __restrict__ flags,
                   const float* __restrict__ ztab, const D3q27Args a,
                   const __grid_constant__ Shift sh) {
  extern __shared__ float smem[];
  float* sinc = smem + RING_PLANES * EXT_N;       // [2][4][TX * TY]
  const size_t n = (size_t)a.nz * a.ny * a.nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int zs = blockIdx.z * a.zc;
  const int ze = min(zs + a.zc, a.nz);
  const int tid = threadIdx.x;
  // this thread's step-1 node (extended column) and step-2 node (column)
  const int ly = tid / EXT_X, lx = tid - ly * EXT_X;
  const int y1 = wrap(y0 - 1 + ly, a.ny), x1 = wrap(x0 - 1 + lx, a.nx);
  const bool central1 = ly >= 1 && ly <= TY && lx >= 1 && lx <= TX;
  const int cy = tid / TX, cx = tid - cy * TX;
  const int y2 = y0 + cy, x2 = x0 + cx;
  const bool active2 = tid < TX * TY && y2 < a.ny && x2 < a.nx;

  // ring index r is z plane zs - 1 + r.  Iteration r computes step 1 of
  // plane r, then (from r = 2 on) step 2 of plane r - 1 from the ez = +1
  // group of plane r - 2, the ez = 0 group of plane r - 1 and the ez = -1
  // group of plane r; each group's slot is free again by the time step 1
  // of a later plane writes it (ring_slot).
  for (int r = 0; r <= ze - zs + 1; ++r) {
    if (tid < EXT_N) {
      const int z1 = wrap(zs - 1 + r, a.nz);
      const size_t idx = ((size_t)z1 * a.ny + y1) * a.nx + x1;
      float f[Q], inc[4];
      pull(a, fin, sh.w, z1, y1, x1, f);
      node_update(a, f, __ldg(flags + idx), ztab, fin, sh.w, n, idx, inc);
#pragma unroll
      for (int k = 0; k < Q; ++k) ring_slot(smem, k, r)[tid] = f[k];
      if (kCumulant && central1) {
        float* si = sinc + (r % 2) * 4 * TX * TY + (ly - 1) * TX
                    + (lx - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) si[c * TX * TY] = inc[c];
      }
    }
    if (r < 2) continue;          // uniform over the block
    __syncthreads();
    const int z = zs + r - 2;     // the output plane, ring index r - 1
    if (active2) {
      float f[Q], inc[4];
#pragma unroll
      for (int k = 0; k < Q; ++k)
        f[k] = ring_slot(smem, k, r - 1 - comp(k, 2))[
            (cy + 1 - comp(k, 1)) * EXT_X + (cx + 1 - comp(k, 0))];
      const size_t idx = ((size_t)z * a.ny + y2) * a.nx + x2;
      node_update(a, f, __ldg(flags + idx), ztab, fin, sh.w, n, idx, inc);
      float inc1[4];
      if constexpr (kCumulant) {
        const float* si = sinc + ((r - 1) % 2) * 4 * TX * TY + cy * TX + cx;
#pragma unroll
        for (int c = 0; c < 4; ++c) inc1[c] = si[c * TX * TY];
      }
      store(fin, fout, n, idx, f, inc1, inc, sh.w);
    }
    __syncthreads();              // before the next step 1 reuses slots
  }
}

extern "C" {

const char* d3q27_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The compiled model: its D3Q_MODEL id, its population count, storage
// planes and boundary cases and its velocity set (Q entries each of ex,
// ey, ez); the wrapper checks them against the registry.
void d3q27_model_info(int* model, int* q, int* n_storage, int* n_cases,
                      int* ex, int* ey, int* ez) {
  *model = kModel;
  *q = Q;
  *n_storage = N_STORAGE;
  *n_cases = N_CASES;
  for (int k = 0; k < Q; ++k) {
    ex[k] = comp(k, 0);
    ey[k] = comp(k, 1);
    ez[k] = comp(k, 2);
  }
}

}  // extern "C"

template <class S>
static int step2_config(int device, int* smem, int* threads,
                        int* blocks_per_sm, int* sms) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(d3q27_step2_kernel<S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)STEP2_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, d3q27_step2_kernel<S>, STEP2_THREADS, STEP2_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  *smem = (int)STEP2_SMEM;
  *threads = STEP2_THREADS;
  return 0;
}

template <class S>
static int launch_step(const S* fin, S* fout, const int* flags,
                       const float* ztab, const D3q27Args* a,
                       const float* shift, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(STEP_TX, STEP_TY);
  const dim3 grid((a->nx + STEP_TX - 1) / STEP_TX,
                  (a->ny + STEP_TY - 1) / STEP_TY, a->nz);
  d3q27_step_kernel<S><<<grid, block, 0, (cudaStream_t)stream>>>(
      fin, fout, flags, ztab, *a, shift_arg<N_STORAGE>(shift));
  return (int)cudaGetLastError();
}

template <class S>
static int launch_step2(const S* fin, S* fout, const int* flags,
                        const float* ztab, const D3q27Args* a,
                        const float* shift, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(d3q27_step2_kernel<S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)STEP2_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->nx + TX - 1) / TX, (a->ny + TY - 1) / TY,
                  (a->nz + a->zc - 1) / a->zc);
  d3q27_step2_kernel<S><<<grid, STEP2_THREADS, STEP2_SMEM,
                          (cudaStream_t)stream>>>(
      fin, fout, flags, ztab, *a, shift_arg<N_STORAGE>(shift));
  return (int)cudaGetLastError();
}

extern "C" {

// Shared-memory bytes, threads and co-resident blocks per SM of one
// d3q27_step2 block (`bf16` != 0: d3q27_step2_bf16's; the wrapper sizes
// the z runs from them).
int d3q27_step2_config(int device, int bf16, int* smem, int* threads,
                       int* blocks_per_sm, int* sms) {
  return bf16 ? step2_config<__nv_bfloat16>(device, smem, threads,
                                            blocks_per_sm, sms)
              : step2_config<float>(device, smem, threads, blocks_per_sm,
                                    sms);
}

int d3q27_step(const float* fin, float* fout, const int* flags,
               const float* ztab, const D3q27Args* a, int device,
               void* stream) {
  return launch_step<float>(fin, fout, flags, ztab, a, nullptr, device,
                            stream);
}

int d3q27_step2(const float* fin, float* fout, const int* flags,
                const float* ztab, const D3q27Args* a, int device,
                void* stream) {
  return launch_step2<float>(fin, fout, flags, ztab, a, nullptr, device,
                             stream);
}

// The kernels on a bf16 stack at rest, with the planes' shifts `shift`
// (host, n_storage floats; null: raw).
int d3q27_step_bf16(const __nv_bfloat16* fin, __nv_bfloat16* fout,
                    const int* flags, const float* ztab, const D3q27Args* a,
                    const float* shift, int device, void* stream) {
  return launch_step<__nv_bfloat16>(fin, fout, flags, ztab, a, shift,
                                    device, stream);
}

int d3q27_step2_bf16(const __nv_bfloat16* fin, __nv_bfloat16* fout,
                     const int* flags, const float* ztab,
                     const D3q27Args* a, const float* shift, int device,
                     void* stream) {
  return launch_step2<__nv_bfloat16>(fin, fout, flags, ztab, a, shift,
                                     device, stream);
}

}  // extern "C"
