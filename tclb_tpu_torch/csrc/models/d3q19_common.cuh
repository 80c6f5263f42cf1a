// What the d3q19 device headers share (csrc/models/d3q19_adj.cuh and
// csrc/models/d3q19_heat.cuh, built into csrc/generic3d.cu): the d3q19
// velocity set of models/d3q19.py (shell-ordered) with its weights,
// bounce-back pairs, y mirror and the stress rows of its Gram-Schmidt
// basis; the equilibrium, the population sums and the non-equilibrium
// bounce-back faces of csrc/models/lattice3d.cuh on that set; the family's
// boundary cases (models/family.py:boundary_cases with faces "WE" and
// symmetries "NS"); the stress projection of the two-rate MRT
// (lbm.two_rate_relax); and the reverses of the equilibrium and of a face
// closure that d3q19_adj's stage_b<0> takes.

#pragma once

#include "lattice3d.cuh"

namespace model {

constexpr int Q = 19;

// component a of d3q19 velocity k (lbm.d3q19_velocities)
__host__ __device__ constexpr int c19(int a, int k) {
  constexpr int t[3][Q] = {
      {0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1, 0, 0, 0, 0},
      {0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1},
      {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1}};
  return t[a][k];
}

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

// the set as csrc/models/lattice3d.cuh takes it
struct D3Q19 {
  static constexpr int Q = 19;
  __host__ __device__ static constexpr int c(int a, int k) {
    return c19(a, k);
  }
  __host__ __device__ static constexpr double w(int k) { return wd(k); }
  __host__ __device__ static constexpr int opp(int k) {
    return model::opp(k);
  }
};

using lat3::combo;
using lat3::term;

__device__ __forceinline__ float sum19(const float* f) {
  return lat3::sum<D3Q19>(f);
}

__device__ __forceinline__ float edot(int k, const float* u) {
  return lat3::edot<D3Q19>(k, u);
}

__device__ __forceinline__ void equilibrium(float rho, const float* u,
                                            float* feq) {
  lat3::equilibrium<D3Q19>(rho, u, feq);
}

template <int AXIS, int SIDE, bool VELOCITY>
__device__ __forceinline__ void nebb(const float* f, float value,
                                     float* out) {
  lat3::nebb<D3Q19, AXIS, SIDE, VELOCITY>(f, value, out);
}

// The family's boundary cases on a d3q19 stack, by case: the header picks
// the case from the node's type, `vel()` and `den()` give the zonal
// Velocity and Density where a face reads them
enum BoundaryCase { BC_NONE, BC_BOUNCE, BC_WVELOCITY, BC_WPRESSURE,
                    BC_EVELOCITY, BC_EPRESSURE, BC_MIRROR_Y };

template <class Vel, class Den>
__device__ __forceinline__ void boundary19(int bc, const float* f, Vel vel,
                                           Den den, float* fb) {
  switch (bc) {
    case BC_BOUNCE:
#pragma unroll
      for (int k = 0; k < Q; ++k) fb[k] = f[opp(k)];
      break;
    case BC_WVELOCITY: nebb<0, 1, true>(f, vel(), fb); break;
    case BC_WPRESSURE: nebb<0, 1, false>(f, den(), fb); break;
    case BC_EVELOCITY: nebb<0, -1, true>(f, vel(), fb); break;
    case BC_EPRESSURE: nebb<0, -1, false>(f, den(), fb); break;
    case BC_MIRROR_Y:
#pragma unroll
      for (int k = 0; k < Q; ++k) fb[k] = f[mirror_y(k)];
      break;
    default:
#pragma unroll
      for (int k = 0; k < Q; ++k) fb[k] = f[k];
  }
}

// lbm.two_rate_relax's stress projection of the non-equilibrium part:
// mn = M[4:10] fneq, back = (M[4:10] / |row|^2)^T mn
__device__ __forceinline__ void stress_back(const float* fneq, float* back) {
  float mn[NSTRESS];
#pragma unroll
  for (int j = 0; j < NSTRESS; ++j)
    mn[j] = combo<Q>([j](int k) { return basis(j, k); }, fneq);
#pragma unroll
  for (int k = 0; k < Q; ++k)
    back[k] = combo<NSTRESS>(
        [k](int j) { return basis(j, k) / norm(j); }, mn);
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
      if (c19(d, k)) au[d] += c19(d, k) > 0 ? aeu : -aeu;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) au[d] += 2.f * u[d] * ausq;
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
    if (c19(AXIS, k) == SIDE) q[opp(k)] += a[k];
    else q[k] += a[k];
  }
  // the tangential momenta: corr_k += 6 w_k e_tk j_t, j_t = -3 q_t
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AXIS) continue;
    float aj = 0.f;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (c19(AXIS, k) == SIDE && c19(t, k) != 0)
        aj += (float)(6.0 * wd(k) * c19(t, k)) * a[k];
    const float aq = -3.f * aj;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (c19(AXIS, k) == 0 && c19(t, k) != 0)
        q[k] += c19(t, k) > 0 ? aq : -aq;
  }
  // the normal term: corr_k = 6 w_k e_k rho un, with S = s_t + 2 s_o
  float acn = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k)
    if (c19(AXIS, k) == SIDE)
      acn += (float)(6.0 * wd(k) * c19(AXIS, k)) * a[k];
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
    if (c19(AXIS, k) == 0) q[k] += as;
    else if (c19(AXIS, k) == -SIDE) q[k] += 2.f * as;
  }
}

}  // namespace model
