// d2q9 building blocks of the 2D device headers (d2q9_heat.cuh and its
// conjugate and hb builds, sw.cuh, d2q9_solid.cuh, d2q9_npe_guo.cuh, the
// multi-stage headers and the adjoint ones, d2q9_heat_adj.cuh,
// d2q9_adj.cuh, d2q9_optimal_mixing.cuh and d2q9_plate.cuh): the velocity
// set, weights, bounce-back pairs and MRT basis of
// tclb_tpu_torch/models/d2q9.py, and the arithmetic the PyTorch models
// share, each written op for op in the order of its PyTorch counterpart.
// The reverse of a piece (the adjoint headers' stage_b) is named after it
// with _b: the exact derivative of its arithmetic, in another order.
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

// reverse of equilibrium: adds the cotangents of rho, ux and uy given
// those of the nine outputs
__device__ __forceinline__ void equilibrium_b(float rho, float ux, float uy,
                                              const float* a, float& arho,
                                              float& aux, float& auy) {
  const float usq = ux * ux + uy * uy;
  float ausq = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float w = (float)wd(k);
    if (k == 0) {
      arho += a[k] * w * (1.f - 1.5f * usq);
      ausq -= 1.5f * a[k] * w * rho;
      continue;
    }
    const float eu = edot(k, ux, uy);
    const float ac = a[k] * w * rho;
    arho += a[k] * w * (1.f + 3.f * eu + 4.5f * eu * eu - 1.5f * usq);
    ausq -= 1.5f * ac;
    const float aeu = ac * (3.f + 9.f * eu);
    aux += vx(k) * aeu;
    auy += vy(k) * aeu;
  }
  aux += 2.f * ux * ausq;
  auy += 2.f * uy * ausq;
}

// reverse of zou_he_x: q (the cotangents of the face's input populations
// f) from a (those of its outputs), and the cotangent of the face's value
// v in `av`
template <bool west, bool velocity>
__device__ __forceinline__ void zou_he_x_b(const float* f, float v,
                                           const float* a, float* q,
                                           float& av) {
  const float n = (f[0] + f[2] + f[4])
                  + 2.f * (west ? f[3] + f[7] + f[6] : f[1] + f[5] + f[8]);
  // the rebuilt populations' cotangent by ru = rho ux
  const float aru =
      west ? (float)(2.0 / 3.0) * a[1] + (float)(1.0 / 6.0) * (a[5] + a[8])
           : -(float)(2.0 / 3.0) * a[3] - (float)(1.0 / 6.0) * (a[7] + a[6]);
  float an;                 // the cotangent of n
  if (velocity) {           // rho = n / d, d = 1 -+ v
    const float d = west ? 1.f - v : 1.f + v;
    const float rho = n / d;
    const float arh = aru * v;
    av = west ? aru * rho + arh * n / (d * d)
              : aru * rho - arh * n / (d * d);
    an = arh / d;
  } else {                  // ux = +-(1 - n / v)
    const float ux = west ? 1.f - n / v : -1.f + n / v;
    const float aun = aru * v;
    av = west ? aru * ux + aun * n / (v * v) : aru * ux - aun * n / (v * v);
    an = west ? -aun / v : aun / v;
  }
  if (west) {
    q[0] = a[0] + an;
    q[1] = 0.f;
    q[2] = a[2] + an + 0.5f * (a[8] - a[5]);
    q[3] = a[3] + a[1] + 2.f * an;
    q[4] = a[4] + an + 0.5f * (a[5] - a[8]);
    q[5] = 0.f;
    q[6] = a[6] + a[8] + 2.f * an;
    q[7] = a[7] + a[5] + 2.f * an;
    q[8] = 0.f;
  } else {
    q[0] = a[0] + an;
    q[1] = a[1] + a[3] + 2.f * an;
    q[2] = a[2] + an + 0.5f * (a[7] - a[6]);
    q[3] = 0.f;
    q[4] = a[4] + an + 0.5f * (a[6] - a[7]);
    q[5] = a[5] + a[7] + 2.f * an;
    q[6] = 0.f;
    q[7] = 0.f;
    q[8] = a[8] + a[6] + 2.f * an;
  }
}

// ops/lbm.py:nebb_boundary on an x face: `side` +1 the W face (the fluid
// toward +x), -1 the E face; `velocity` given the normal velocity `v`,
// else given the density `v`
template <int side, bool velocity>
__device__ __forceinline__ void nebb_x(float* f, float v) {
  const float s_t = f[0] + f[2] + f[4];
  const float s_o = side > 0 ? f[3] + f[6] + f[7] : f[1] + f[5] + f[8];
  float rho, un;
  if (velocity) {
    un = v;
    rho = (s_t + 2.f * s_o) / (1.f - (side > 0 ? un : -un));
  } else {
    rho = v;
    const float t = 1.f - (s_t + 2.f * s_o) / rho;
    un = side > 0 ? t : -t;
  }
  const float j_t = -3.f * (f[2] - f[4]);     // the tangential momentum
  float out[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    out[k] = f[k];
    if (vx(k) != side) continue;
    float corr = (float)(6.0 * wd(k) * vx(k)) * rho * un;
    if (vy(k)) corr = corr + (float)(6.0 * wd(k) * vy(k)) * j_t;
    out[k] = f[opp(k)] + corr;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = out[k];
}

// reverse of nebb_x at a fixed `v` (the face is linear in f there): q from
// a, as zou_he_x_b's; the value's cotangent is not formed (every model on
// this face reads it from a zonal setting)
template <int side, bool velocity>
__device__ __forceinline__ void nebb_x_b(float v, const float* a, float* q) {
  float acn = 0.f, ajt = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    q[k] = vx(k) == side ? 0.f : a[k];
    if (vx(k) != side) continue;
    acn += (float)(6.0 * wd(k) * vx(k)) * a[k];
    if (vy(k)) ajt += (float)(6.0 * wd(k) * vy(k)) * a[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k)
    if (vx(k) == side) q[opp(k)] += a[k];
  // j_t = -3 (f2 - f4)
  q[2] += -3.f * ajt;
  q[4] += 3.f * ajt;
  // corr_k = c_k rho un, S = s_t + 2 s_o
  float as;
  if (velocity) {           // rho = S / (1 - side un)
    as = acn * v / (1.f - (side > 0 ? v : -v));
  } else {                  // un = side (1 - S / rho)
    const float aun = acn * v;
    as = (side > 0 ? -aun : aun) / v;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (vx(k) == 0) q[k] += as;
    else if (vx(k) == -side) q[k] += 2.f * as;
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
