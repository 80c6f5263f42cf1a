// The seams of the storage ladder: every kernel that takes a narrowed field
// stack loads and stores its planes through widen() and narrow(), and
// nowhere else, so a check of the narrowing has one place to look.
//
// The kernels compute in f32 whatever the stack holds at rest.  A plane is
// widened where it is read from device memory and narrowed where it is
// written back, with the plane's DDF shift w (tclb_tpu_torch/core/shift.py:
// w_i for a streamed plane of a shifted stack, else 0): widen restores
// f = s + w, narrow rounds the deviation f - w, the subtraction done in f32
// before the cast, as shift.narrow_plane does.  A zero shift is a pure cast
// (shift.plane_shifts), so the raw representation never adds 0.0.
//
// S = float (f32 storage) ignores the shift and compiles to a plain load and
// store: the f32 rung's code is what it was.  S = __nv_bfloat16 rounds to
// nearest even (__float2bfloat16_rn), as torch's .to(torch.bfloat16) does.

#pragma once

#include <cuda_bf16.h>

// a narrowed stack's per-plane shifts, a launch argument
template <int N>
struct PlaneShift {
  float w[N];
};

// The shifts as a launch argument: `shift` (host, N floats) for a shifted
// stack, null for a raw one (every shift 0: pure casts).
template <int N>
inline PlaneShift<N> shift_arg(const float* shift) {
  PlaneShift<N> sh{};
  if (shift)
    for (int k = 0; k < N; ++k) sh.w[k] = shift[k];
  return sh;
}

__device__ __forceinline__ float widen(float v, float) { return v; }

__device__ __forceinline__ float widen(__nv_bfloat16 v, float w) {
  const float x = __bfloat162float(v);
  return w != 0.f ? x + w : x;
}

template <class S>
__device__ __forceinline__ S narrow(float v, float w);

template <>
__device__ __forceinline__ float narrow<float>(float v, float) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v,
                                                              float w) {
  return __float2bfloat16_rn(w != 0.f ? v - w : v);
}

// plane k of a stack at rest, at `q`, in f32: through the read-only path,
// or (kCoherent) through L2 only, for buffers written during the launch.
// `w` holds the planes' shifts; an f32 stack never reads it.
template <bool kCoherent>
__device__ __forceinline__ float load_plane(const float* q, const float*,
                                            int) {
  return kCoherent ? __ldcg(q) : __ldg(q);
}

template <bool kCoherent>
__device__ __forceinline__ float load_plane(const __nv_bfloat16* q,
                                            const float* w, int k) {
  return widen(kCoherent ? __ldcg(q) : __ldg(q), w[k]);
}

// store v, plane k's compute value, to its slot `q` of a stack at rest
template <class S>
__device__ __forceinline__ void store_plane(S* q, float v, const float* w,
                                            int k) {
  if constexpr (sizeof(S) == sizeof(float)) *q = v;
  else *q = narrow<S>(v, w[k]);
}
