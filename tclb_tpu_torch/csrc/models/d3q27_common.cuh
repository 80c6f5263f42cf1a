// What the 27-velocity device headers share (csrc/models/d3q27.cuh,
// d3q27_viscoplastic.cuh and d3q27_cumulant_qibb.cuh, built into
// csrc/generic3d.cu): the tensor-product velocity set of
// tclb_tpu_torch/ops/cumulant.py:velocity_set(3) (k = 9i + 3j + l holds the
// velocity (i-1, j-1, l-1); the bounce-back partner of k is 26 - k), its
// weights and mirrors in closed form, csrc/models/lattice3d.cuh's pieces
// on that set, the family's boundary cases (models/family.py:
// boundary_cases: bounce-back, the W/E and S/N velocity and pressure faces,
// the N/S symmetry mirror) and the moment-space collision of
// csrc/models/d3q27_moments.cuh.

#pragma once

#include "d3q27_moments.cuh"
#include "lattice3d.cuh"

namespace model {

constexpr int Q = 27;

__host__ __device__ constexpr int c27(int a, int k) {
  return a == 0 ? k / 9 - 1 : (a == 1 ? (k / 3) % 3 - 1 : k % 3 - 1);
}
__host__ __device__ constexpr int speed2(int k) {
  return c27(0, k) * c27(0, k) + c27(1, k) * c27(1, k)
         + c27(2, k) * c27(2, k);
}
// lbm.weights by speed shell
__host__ __device__ constexpr double wd(int k) {
  return speed2(k) == 0 ? 8.0 / 27 : speed2(k) == 1 ? 2.0 / 27
         : speed2(k) == 2 ? 1.0 / 54 : 1.0 / 216;
}
__host__ __device__ constexpr int opp(int k) { return Q - 1 - k; }
// the velocity with its y (z) component mirrored (family.mirror_perm)
__host__ __device__ constexpr int mirror_y(int k) {
  return k + 6 - 6 * ((k / 3) % 3);
}
__host__ __device__ constexpr int mirror_z(int k) {
  return k + 2 - 2 * (k % 3);
}

// the set as csrc/models/lattice3d.cuh takes it
struct D3Q27 {
  static constexpr int Q = 27;
  __host__ __device__ static constexpr int c(int a, int k) {
    return c27(a, k);
  }
  __host__ __device__ static constexpr double w(int k) { return wd(k); }
  __host__ __device__ static constexpr int opp(int k) {
    return model::opp(k);
  }
};

using lat3::combo;
using lat3::term;

__device__ __forceinline__ float sum27(const float* f) {
  return lat3::sum<D3Q27>(f);
}

__device__ __forceinline__ void equilibrium(float rho, const float* u,
                                            float* feq) {
  lat3::equilibrium<D3Q27>(rho, u, feq);
}

// rho and u = j / rho in plane order
__device__ __forceinline__ float macroscopic(const float* f, float* u) {
  const float rho = sum27(f);
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = lat3::moment<D3Q27>(a, f) / rho;
  return rho;
}

// The family's boundary cases on the 27 populations, by case: the header
// picks the case from the node's type, `vel()` and `den()` give the zonal
// Velocity and Density where a face reads them
enum BoundaryCase { BC_NONE, BC_BOUNCE, BC_WVELOCITY, BC_WPRESSURE,
                    BC_EVELOCITY, BC_EPRESSURE, BC_SVELOCITY, BC_SPRESSURE,
                    BC_NVELOCITY, BC_NPRESSURE, BC_MIRROR_Y };

template <class Vel, class Den>
__device__ __forceinline__ void boundary27(int bc, const float* f, Vel vel,
                                           Den den, float* fb) {
  switch (bc) {
    case BC_BOUNCE:
#pragma unroll
      for (int k = 0; k < Q; ++k) fb[k] = f[opp(k)];
      break;
    case BC_WVELOCITY: lat3::nebb<D3Q27, 0, 1, true>(f, vel(), fb); break;
    case BC_WPRESSURE: lat3::nebb<D3Q27, 0, 1, false>(f, den(), fb); break;
    case BC_EVELOCITY: lat3::nebb<D3Q27, 0, -1, true>(f, vel(), fb); break;
    case BC_EPRESSURE: lat3::nebb<D3Q27, 0, -1, false>(f, den(), fb); break;
    case BC_SVELOCITY: lat3::nebb<D3Q27, 1, 1, true>(f, vel(), fb); break;
    case BC_SPRESSURE: lat3::nebb<D3Q27, 1, 1, false>(f, den(), fb); break;
    case BC_NVELOCITY: lat3::nebb<D3Q27, 1, -1, true>(f, vel(), fb); break;
    case BC_NPRESSURE: lat3::nebb<D3Q27, 1, -1, false>(f, den(), fb); break;
    case BC_MIRROR_Y:
#pragma unroll
      for (int k = 0; k < Q; ++k) fb[k] = f[mirror_y(k)];
      break;
    default:
#pragma unroll
      for (int k = 0; k < Q; ++k) fb[k] = f[k];
  }
}

}  // namespace model
