// The moment-space collision of the 27-velocity tensor-product models:
// Geier's cumulant collision (ops/cumulant.py:collide_d3q27 with
// correlated=True: every cumulant above second order vanishes, the Isserlis
// closure on the relaxed covariance) or the cascaded central-moment MRT
// (correlated=False: the higher moments of the factorized Gaussian), with a
// body force as a shift of the back-transform's velocity and, where
// kGalilean, Geier's Galilean correction of the diagonal second-order
// relaxation.  Shared by the z-slab kernels (csrc/d3q27.cu, the
// d3q27_cumulant build: <true, true>) and the generic 3D headers
// (csrc/models/d3q27.cuh: <false, false>;
// csrc/models/d3q27_cumulant_qibb.cuh: <true, true>).
//
// f is the 27 populations in the tensor-product order of
// tclb_tpu_torch/ops/cumulant.py:velocity_set(3) (k = 9i + 3j + l holds
// the velocity (i-1, j-1, l-1)), relaxed in place where `collide`; rho and
// u (before the force shift) come back everywhere.  The raw moments are
// 3-wide contractions with the Vandermonde of (-1, 0, 1) along x, y and z
// in turn, as ops/cumulant.py forms them.

#pragma once

namespace d3q27_moments {

template <bool kCorrelated, bool kGalilean>
__device__ __forceinline__ void collide(float* f, float omega,
                                        float omega_bulk, const float* force,
                                        float galilean, bool collide,
                                        float& rho_o, float& ux_o,
                                        float& uy_o, float& uz_o) {
  // forward moments of order <= 2: contract x, then y, then z
  float s0[9], s1[9], s2[9];
#pragma unroll
  for (int jl = 0; jl < 9; ++jl) {
    const float x0 = f[jl], x1 = f[9 + jl], x2 = f[18 + jl];
    s0[jl] = x0 + x1 + x2;
    s1[jl] = x2 - x0;
    s2[jl] = x2 + x0;
  }
  float m000, m001, m002, m010, m011, m020, m100, m101, m110, m200;
  {
    float t0[3], t1[3], t2[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      t0[l] = s0[l] + s0[3 + l] + s0[6 + l];
      t1[l] = s0[6 + l] - s0[l];
      t2[l] = s0[6 + l] + s0[l];
    }
    m000 = t0[0] + t0[1] + t0[2];
    m001 = t0[2] - t0[0];
    m002 = t0[2] + t0[0];
    m010 = t1[0] + t1[1] + t1[2];
    m011 = t1[2] - t1[0];
    m020 = t2[0] + t2[1] + t2[2];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      t0[l] = s1[l] + s1[3 + l] + s1[6 + l];
      t1[l] = s1[6 + l] - s1[l];
    }
    m100 = t0[0] + t0[1] + t0[2];
    m101 = t0[2] - t0[0];
    m110 = t1[0] + t1[1] + t1[2];
#pragma unroll
    for (int l = 0; l < 3; ++l) t0[l] = s2[l] + s2[3 + l] + s2[6 + l];
    m200 = t0[0] + t0[1] + t0[2];
  }
  const float rho = m000;
  const float inv = 1.f / rho;
  const float jx = m100, jy = m010, jz = m001;
  const float ux = jx * inv, uy = jy * inv, uz = jz * inv;
  rho_o = rho; ux_o = ux; uy_o = uy; uz_o = uz;
  if (!collide) return;

  const float kxx = m200 - jx * ux, kyy = m020 - jy * uy,
              kzz = m002 - jz * uz;
  const float kxy = m110 - jx * uy, kxz = m101 - jx * uz,
              kyz = m011 - jy * uz;
  const float ob = omega_bulk;
  const float cxx = kxx * inv, cyy = kyy * inv, czz = kzz * inv;
  float a_c = (1.f - omega) * (cxx - cyy);
  float b_c = (1.f - omega) * (cxx - czz);
  float cc_c = ob + (1.f - ob) * (cxx + cyy + czz);
  if constexpr (kGalilean) {
    const float uxh = ux + 0.5f * force[0];
    const float uyh = uy + 0.5f * force[1];
    const float uzh = uz + 0.5f * force[2];
    const float dxu = -0.5f * omega * (2.f * cxx - cyy - czz)
                      - 0.5f * ob * (cxx + cyy + czz - 1.f);
    const float dyv = dxu + 1.5f * omega * (cxx - cyy);
    const float dzw = dxu + 1.5f * omega * (cxx - czz);
    const float gc1 = 3.f * (1.f - 0.5f * omega)
                      * (uxh * uxh * dxu - uyh * uyh * dyv);
    const float gc2 = 3.f * (1.f - 0.5f * omega)
                      * (uxh * uxh * dxu - uzh * uzh * dzw);
    const float gc3 = 3.f * (1.f - 0.5f * ob)
                      * (uxh * uxh * dxu + uyh * uyh * dyv + uzh * uzh * dzw);
    a_c = a_c - gc1 * galilean;
    b_c = b_c - gc2 * galilean;
    cc_c = cc_c - gc3 * galilean;
  }
  const float kxx_p = rho * (a_c + b_c + cc_c) / 3.f;
  const float kyy_p = rho * (cc_c - 2.f * a_c + b_c) / 3.f;
  const float kzz_p = rho * (cc_c - 2.f * b_c + a_c) / 3.f;
  const float one_m = 1.f - omega;
  const float kxy_p = one_m * kxy, kxz_p = one_m * kxz, kyz_p = one_m * kyz;

  float g220, g202, g022, g211, g121, g112, g222;
  if constexpr (kCorrelated) {
    // Isserlis closure: every cumulant above second order vanishes
    g220 = (kxx_p * kyy_p + 2.f * kxy_p * kxy_p) * inv;
    g202 = (kxx_p * kzz_p + 2.f * kxz_p * kxz_p) * inv;
    g022 = (kyy_p * kzz_p + 2.f * kyz_p * kyz_p) * inv;
    g211 = (kxx_p * kyz_p + 2.f * kxy_p * kxz_p) * inv;
    g121 = (kyy_p * kxz_p + 2.f * kxy_p * kyz_p) * inv;
    g112 = (kzz_p * kxy_p + 2.f * kxz_p * kyz_p) * inv;
    g222 = (kxx_p * kyy_p * kzz_p
            + 2.f * (kxx_p * kyz_p * kyz_p + kyy_p * kxz_p * kxz_p
                     + kzz_p * kxy_p * kxy_p)
            + 8.f * kxy_p * kxz_p * kyz_p) * inv * inv;
  } else {
    // the factorized equilibrium: the higher moments of the uncorrelated
    // Gaussian (the cascaded central-moment MRT)
    g220 = kxx_p * kyy_p * inv;
    g202 = kxx_p * kzz_p * inv;
    g022 = kyy_p * kzz_p * inv;
    g211 = 0.f;
    g121 = 0.f;
    g112 = 0.f;
    g222 = kxx_p * kyy_p * kzz_p * inv * inv;
  }

  // raw moments m[p][q][r]: the sparse x decentralize pass with the forced
  // velocity, then y and z
  const float u = ux + force[0], v = uy + force[1], w = uz + force[2];
  const float uu = u * u;
  float m[27];
#define M(p, q, r) m[9 * (p) + 3 * (q) + (r)]
#pragma unroll
  for (int i = 0; i < 27; ++i) m[i] = 0.f;
  M(0, 0, 0) = rho;            M(1, 0, 0) = u * rho;
  M(2, 0, 0) = kxx_p + uu * rho;
  M(1, 1, 0) = kxy_p;          M(2, 1, 0) = 2.f * u * kxy_p;
  M(1, 0, 1) = kxz_p;          M(2, 0, 1) = 2.f * u * kxz_p;
  M(0, 1, 1) = kyz_p;          M(1, 1, 1) = u * kyz_p;
  M(2, 1, 1) = g211 + uu * kyz_p;
  M(0, 2, 0) = kyy_p;          M(1, 2, 0) = u * kyy_p;
  M(2, 2, 0) = g220 + uu * kyy_p;
  M(0, 0, 2) = kzz_p;          M(1, 0, 2) = u * kzz_p;
  M(2, 0, 2) = g202 + uu * kzz_p;
  M(1, 2, 1) = g121;           M(2, 2, 1) = 2.f * u * g121;
  M(1, 1, 2) = g112;           M(2, 1, 2) = 2.f * u * g112;
  M(0, 2, 2) = g022;           M(1, 2, 2) = u * g022;
  M(2, 2, 2) = g222 + uu * g022;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float k0 = M(p, 0, r), k1 = M(p, 1, r), k2 = M(p, 2, r);
      M(p, 1, r) = k1 + v * k0;
      M(p, 2, r) = k2 + 2.f * v * k1 + v * v * k0;
    }
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float k0 = M(p, q, 0), k1 = M(p, q, 1), k2 = M(p, q, 2);
      M(p, q, 1) = k1 + w * k0;
      M(p, q, 2) = k2 + 2.f * w * k1 + w * w * k0;
    }
  // back to populations: the inverse Vandermonde of (-1, 0, 1) on each axis
  // (f_-1 = (m2 - m1) / 2, f_0 = m0 - m2, f_+1 = (m1 + m2) / 2)
#pragma unroll
  for (int a0 = 0; a0 < 9; ++a0) {      // axis x: lines m[., q, r]
    const float m0 = m[a0], m1 = m[9 + a0], m2 = m[18 + a0];
    m[a0] = -0.5f * m1 + 0.5f * m2;
    m[9 + a0] = m0 - m2;
    m[18 + a0] = 0.5f * m1 + 0.5f * m2;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)           // axis y: lines m[i, ., r]
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float m0 = M(i, 0, r), m1 = M(i, 1, r), m2 = M(i, 2, r);
      M(i, 0, r) = -0.5f * m1 + 0.5f * m2;
      M(i, 1, r) = m0 - m2;
      M(i, 2, r) = 0.5f * m1 + 0.5f * m2;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)           // axis z: lines m[i, j, .]
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float m0 = M(i, j, 0), m1 = M(i, j, 1), m2 = M(i, j, 2);
      f[9 * i + 3 * j] = -0.5f * m1 + 0.5f * m2;
      f[9 * i + 3 * j + 1] = m0 - m2;
      f[9 * i + 3 * j + 2] = 0.5f * m1 + 0.5f * m2;
    }
#undef M
}


}  // namespace d3q27_moments
