// d2q9 building blocks of the one-stage device headers (d2q9_heat.cuh and
// its conjugate and hb builds, sw.cuh, d2q9_solid.cuh, d2q9_npe_guo.cuh):
// the velocity set, weights, bounce-back pairs and MRT basis of
// tclb_tpu_torch/models/d2q9.py, and the arithmetic the PyTorch models
// share, each written op for op in the order of its PyTorch counterpart.
//
// The conventions of every header built on this file:
//   * a population sum runs in plane order (ops/lbm.py:edot, the models'
//     _sum), skipping zero coefficients, +-1 as an add or a subtract;
//   * a division by a Python constant is what PyTorch's CUDA kernels do
//     with a CPU scalar divisor: a multiply by the float reciprocal
//     (1 / (1/3) -> 3, 1 / (2/9) -> 4.5, 1 / (8/9) -> 1.125); a division
//     by a setting or a plane is a division;
//   * 1 / x of a tensor is PyTorch's reciprocal, a division;
//   * Python constants enter as floats (the double rounded once).
// generic2d.cu is built with --fmad=false, so no multiply and add fuse.

#pragma once

namespace d2q9 {

// the velocity set (models/d2q9.py:E), its weights and bounce-back pairs
__host__ __device__ constexpr int vx(int k) {
  constexpr int t[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  return t[k];
}
__host__ __device__ constexpr int vy(int k) {
  constexpr int t[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  return t[k];
}
__host__ __device__ constexpr double wd(int k) {
  constexpr double t[9] = {4.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9, 1.0 / 9,
                           1.0 / 36, 1.0 / 36, 1.0 / 36, 1.0 / 36};
  return t[k];
}
__host__ __device__ constexpr int opp(int k) {
  constexpr int t[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  return t[k];
}

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

// sum_k coef(k) x[k] over the nonzero coefficients of k in [lo, 9), in
// order (ops/lbm.py:edot and unrolled_matvec)
template <class Coef>
__device__ __forceinline__ float combo(Coef coef, const float* x,
                                       int lo = 0) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = lo; k < 9; ++k) {
    const float c = coef(k);
    if (c == 0.f) continue;
    const float t = (c == 1.f) ? x[k] : (c == -1.f ? -x[k] : c * x[k]);
    acc = first ? t : acc + t;
    first = false;
  }
  return acc;
}

__device__ __forceinline__ float sum9(const float* x) {
  return combo([](int) { return 1.f; }, x);
}
__device__ __forceinline__ float jx(const float* x) {
  return combo([](int k) { return (float)vx(k); }, x);
}
__device__ __forceinline__ float jy(const float* x) {
  return combo([](int k) { return (float)vy(k); }, x);
}

// e_k . (ux, uy) with the zero components skipped (ops/lbm.py:edot)
__device__ __forceinline__ float edot(int k, float ux, float uy) {
  if (vx(k) == 0) return vy(k) > 0 ? uy : -uy;
  if (vy(k) == 0) return vx(k) > 0 ? ux : -ux;
  return (vx(k) > 0 ? ux : -ux) + (vy(k) > 0 ? uy : -uy);
}

// ops/lbm.py:equilibrium, with the divisions by 1/3, 2/9 and 2/3 as
// multiplies by 3, 4.5 and 1.5
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
    const float eu = edot(k, ux, uy);
    feq[k] = wr * (1.f + eu * 3.f + eu * eu * 4.5f - usq * 1.5f);
  }
}

// Zou/He faces on x (models/d2q9.py:_zou_he_x): `west` the face the flow
// enters, `velocity` given ux (`v`), else given rho (`v`)
template <bool west, bool velocity>
__device__ __forceinline__ void zou_he_x(float* f, float v) {
  const float tang = f[0] + f[2] + f[4];
  const float known = west ? f[3] + f[7] + f[6] : f[1] + f[5] + f[8];
  float rho, ux;
  if (velocity) {
    ux = v;
    rho = (tang + 2.f * known) / (west ? 1.f - ux : 1.f + ux);
  } else {
    rho = v;
    ux = west ? 1.f - (tang + 2.f * known) / rho
              : -1.f + (tang + 2.f * known) / rho;
  }
  const float ru = rho * ux;
  if (west) {
    f[1] = f[3] + (float)(2.0 / 3.0) * ru;
    const float f5 = f[7] + (float)(1.0 / 6.0) * ru + 0.5f * (f[4] - f[2]);
    const float f8 = f[6] + (float)(1.0 / 6.0) * ru + 0.5f * (f[2] - f[4]);
    f[5] = f5;
    f[8] = f8;
  } else {
    f[3] = f[1] - (float)(2.0 / 3.0) * ru;
    const float f7 = f[5] - (float)(1.0 / 6.0) * ru + 0.5f * (f[2] - f[4]);
    const float f6 = f[8] - (float)(1.0 / 6.0) * ru + 0.5f * (f[4] - f[2]);
    f[7] = f7;
    f[6] = f6;
  }
}

// q <- q[opp]
__device__ __forceinline__ void bounce(float* q) {
  float b[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) b[k] = q[opp(k)];
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = b[k];
}

// the nine populations of the group whose first plane is `base`, streamed
// to the node
template <int base, class Ctx>
__device__ __forceinline__ void pull(const Ctx& c, float* q) {
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = c.pulled(base + k);
}

template <int base, class Ctx>
__device__ __forceinline__ void store(const Ctx& c, const float* q) {
#pragma unroll
  for (int k = 0; k < 9; ++k) c.store(base + k, q[k]);
}

}  // namespace d2q9
