// wave2d device physics for the generic 2D kernels (csrc/generic2d.cu,
// csrc/generic2d_adjoint.cuh).
//
// The CUDA counterpart of tclb_tpu_torch/models/wave2d.py: the forward
// stage<0> (Run) and its hand-written reverse stage_b<0>, which plays the
// role of the reference's Tapenade-generated Run_b.  h1..h4, each streamed
// along one link, bring the four neighbours' heights; their sum less 4 h
// is the Laplacian du, which advances the rate u (WaveK); h advances by u
// and is masked by the design density w, u is damped by Loss; every copy
// of h leaves with the new h.  Obj1 nodes add du^2 to TotalDiff.  Written
// against the template's node contexts (see d2q9_heat_adj.cuh for both
// lists).
//
// The forward repeats the PyTorch model op for op in its order
// (d2q9_common.cuh's conventions); the reverse is the exact derivative of
// that arithmetic in another order.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

// generic2d.cu builds generic2d_step_b for this model
#define TCLB_MODEL_ADJOINT 1

namespace model {

// storage planes: h, u, the streamed copies h1..h4 and the design density
// w
constexpr int N_STORAGE = 7;
constexpr int H = 0, UP = 1, H1 = 2, WP = 6;
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 0, 0};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 0, 1, 0, -1, 0};
  return t[k];
}

// the Iteration action: one stage (Run) that writes every plane
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x7fu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting { S_WaveK, S_SolidH, S_Loss, S_TotalDiffInObj, N_SETTINGS };
enum NodeType { T_Obj1, N_TYPES };
// (the template's argument block keeps one group mask: the header reads
// Obj1 by its type)
enum Group { G_OBJECTIVE, N_GROUPS };
enum Zonal { N_ZONAL };
enum Global { GL_TotalDiff, N_GLOBALS };

// the forward of one node, shared by stage<0> and its reverse
struct Forward {
  float h, u, w, du, un, hn;

  template <class Ctx>
  __device__ __forceinline__ Forward(Ctx& c) {
    h = c.pulled(H);
    u = c.pulled(UP);
    w = c.pulled(WP);
    du = c.pulled(H1) + c.pulled(H1 + 1) + c.pulled(H1 + 2)
         + c.pulled(H1 + 3) - 4.f * h;
    un = u + du * c.setting(S_WaveK);
    hn = (h + un) * w;
  }
};

// stage 0, Run
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const Forward s(c);
  if (c.nt_is(T_Obj1)) c.add_global(GL_TotalDiff, s.du * s.du);
  c.store(H, s.hn);
  c.store(UP, s.un * c.setting(S_Loss));
#pragma unroll
  for (int k = 0; k < 4; ++k) c.store(H1 + k, s.hn);
  c.store(WP, s.w);
}

// reverse of stage 0: the cotangents of the seven pulled inputs and of
// the settings, given those of the outputs and of TotalDiff
template <class Ctx>
__device__ __forceinline__ void run_b(Ctx& c) {
  const Forward s(c);
  const float ahn = c.lam(H) + c.lam(H1) + c.lam(H1 + 1) + c.lam(H1 + 2)
                    + c.lam(H1 + 3);
  // u' = un Loss
  const float aout = c.lam(UP);
  c.add_setting(S_Loss, aout * s.un);
  // hn = (h + un) w
  const float ahu = ahn * s.w;
  const float aun = aout * c.setting(S_Loss) + ahu;
  const float aw = c.lam(WP) + ahn * (s.h + s.un);
  // un = u + du WaveK
  c.add_setting(S_WaveK, aun * s.du);
  float adu = aun * c.setting(S_WaveK);
  if (c.nt_is(T_Obj1)) adu += 2.f * s.du * c.lam_global(GL_TotalDiff);
  // du = h1 + h2 + h3 + h4 - 4 h
  c.set_q(H, ahu - 4.f * adu);
  c.set_q(UP, aun);
#pragma unroll
  for (int k = 0; k < 4; ++k) c.set_q(H1 + k, adu);
  c.set_q(WP, aw);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage_b(Ctx& c) {
  if constexpr (S == 0) run_b(c);
}

}  // namespace model
