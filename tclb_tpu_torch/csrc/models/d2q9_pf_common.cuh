// The phase-field pieces d2q9_pf.cuh and d2q9_pf_curvature.cuh share
// (tclb_tpu_torch/models/d2q9_pf.py: _heq and _normal_of), op for op in
// their PyTorch order (d2q9_common.cuh's conventions).

#pragma once

#include "d2q9_common.cuh"

namespace d2q9pf {

// the h equilibrium: the advected phase field pf at (ux, uy) plus the
// sharpening flux bh w_k e_k.n (none at rest)
__device__ __forceinline__ void heq(float pf, float nx, float ny, float ux,
                                    float uy, float bh, float* out) {
  d2q9::equilibrium(pf, ux, uy, out);
#pragma unroll
  for (int k = 1; k < 9; ++k)
    out[k] = out[k] + bh * (float)d2q9::wd(k) * d2q9::edot(k, nx, ny);
}

// -k / |k| (zero where |k| vanishes)
__device__ __forceinline__ void normal_of(float kx, float ky, float& nx,
                                          float& ny) {
  const float ln = sqrtf(kx * kx + ky * ky);
  nx = ln > 0.f ? -kx / ln : 0.f;
  ny = ln > 0.f ? -ky / ln : 0.f;
}

// bh = 3 M (1 - 4 pf^2) W
__device__ __forceinline__ float sharpening(float pf, float m, float w) {
  return 3.f * m * (1.f - 4.f * pf * pf) * w;
}

}  // namespace d2q9pf
