// What the 3D device headers share whatever their velocity set
// (csrc/models/d3q19_common.cuh for d3q19_adj and d3q19_heat,
// csrc/models/d3q27_common.cuh for d3q27, d3q27_viscoplastic and
// d3q27_cumulant_qibb_small): population sums, e.u, the second-order
// equilibrium and the non-equilibrium bounce-back faces, each written in
// the order of operations of the port's PyTorch ops (ops/lbm.py: edot,
// unrolled_matvec, equilibrium, nebb_boundary), with PyTorch's divisions
// by constants as multiplies by their reciprocals, so that a kernel built
// with --fmad=false rounds where the plain version does.
//
// A velocity set is a struct with
//
//   static constexpr int Q;               its populations
//   static constexpr int c(int a, int k)  component a of velocity k
//   static constexpr double w(int k)      its lattice weight
//   static constexpr int opp(int k)       the bounce-back partner
//
// as __host__ __device__ constexpr functions over local tables: after
// unrolling every index is a constant and each call folds to a literal.

#pragma once

namespace lat3 {

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

// the populations' sum in plane order
template <class S>
__device__ __forceinline__ float sum(const float* f) {
  return combo<S::Q>([](int) { return 1.0; }, f);
}

// component a of the momentum, sum_k c_ak f_k in plane order
template <class S>
__device__ __forceinline__ float moment(int a, const float* f) {
  return combo<S::Q>([a](int k) { return (double)S::c(a, k); }, f);
}

// e_k . u with the zero components skipped
template <class S>
__device__ __forceinline__ float edot(int k, const float* u) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (S::c(a, k) == 0) continue;
    const float t = S::c(a, k) > 0 ? u[a] : -u[a];
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

// ops/lbm.py:equilibrium, with PyTorch's divisions by the constants 1/3,
// 2/9 and 2/3 as multiplies by 3, 4.5 and 1.5
template <class S>
__device__ __forceinline__ void equilibrium(float rho, const float* u,
                                            float* feq) {
  const float usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
#pragma unroll
  for (int k = 0; k < S::Q; ++k) {
    const float wr = (float)S::w(k) * rho;
    if (S::c(0, k) == 0 && S::c(1, k) == 0 && S::c(2, k) == 0) {
      feq[k] = wr * (1.f - usq * 1.5f);
      continue;
    }
    const float eu = edot<S>(k, u);
    feq[k] = wr * (1.f + eu * 3.f + eu * eu * 4.5f - usq * 1.5f);
  }
}

// ops/lbm.py:nebb_boundary on face (AXIS, SIDE): SIDE +1 where the fluid
// lies toward +AXIS (a W face), -1 on the high face; VELOCITY imposes the
// normal velocity `value`, else the density `value`
template <class S, int AXIS, int SIDE, bool VELOCITY>
__device__ __forceinline__ void nebb(const float* f, float value,
                                     float* out) {
  constexpr int Q = S::Q;
  float s_t = 0.f, s_o = 0.f;
  bool first_t = true, first_o = true;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    if (S::c(AXIS, k) == 0) {
      s_t = first_t ? f[k] : s_t + f[k];
      first_t = false;
    } else if (S::c(AXIS, k) == -SIDE) {
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
    if (S::c(AXIS, k) == SIDE)
      corr[k] = (float)(6.0 * S::w(k) * S::c(AXIS, k)) * rho * un;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AXIS) continue;
    float qt = 0.f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (S::c(AXIS, k) != 0 || S::c(t, k) == 0) continue;
      const float v = S::c(t, k) > 0 ? f[k] : -f[k];
      qt = first ? v : qt + v;
      first = false;
    }
    const float jt = qt * -3.f;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (S::c(AXIS, k) == SIDE && S::c(t, k) != 0)
        corr[k] = corr[k] + (float)(6.0 * S::w(k) * S::c(t, k)) * jt;
  }
#pragma unroll
  for (int k = 0; k < Q; ++k)
    out[k] = S::c(AXIS, k) == SIDE ? f[S::opp(k)] + corr[k] : f[k];
}

}  // namespace lat3
