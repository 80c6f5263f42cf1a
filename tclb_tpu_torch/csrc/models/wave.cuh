// wave device physics for the generic 2D kernels (csrc/generic2d.cu).
//
// The CUDA counterpart of tclb_tpu_torch/models/wave.py, op for op in its
// order (d2q9_common.cuh's conventions): the two Fields u and v, read
// over a +-1 stencil of the un-streamed storage, step the wave equation;
// Dirichlet nodes pin u to the zonal Value and v to 0.  Nothing streams,
// so the one stage reads Fields only (c.load): the bf16 pass form serves
// them from its node's three rows and columns (FIELD_REACH).  Written
// against the template's node context (see d2q9_heat_physics.cuh for the
// list).
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

namespace model {

// storage planes: the Fields u and v
constexpr int N_STORAGE = 2;
constexpr int U = 0, V = 1;
__host__ __device__ constexpr int ex(int) { return 0; }
__host__ __device__ constexpr int ey(int) { return 0; }

// the Iteration action: one stage (Run) that writes u and v
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x3u; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }
// the Fields are read one node away at most
constexpr int FIELD_REACH = 1;

enum Setting { S_Speed, S_Value, S_Viscosity, N_SETTINGS };
enum NodeType { T_Dirichlet, N_TYPES };
// (the template's argument block keeps one group mask: the header reads
// none)
enum Group { G_BOUNDARY, N_GROUPS };
enum Zonal { Z_Value, N_ZONAL };
enum Global { N_GLOBALS };

// stage 0, Run: the five-point laplacian of u, v damped and advanced, u
// advanced by v; Dirichlet nodes pinned
template <class Ctx>
__device__ __forceinline__ void run(Ctx& c) {
  const float u = c.load(U, 0, 0);
  const float v = c.load(V, 0, 0);
  const float lap = c.load(U, 1, 0) + c.load(U, -1, 0) + c.load(U, 0, 1)
                    + c.load(U, 0, -1) - 4.f * u;
  float vn = v + c.setting(S_Speed) * lap - c.setting(S_Viscosity) * v;
  float un = u + vn;
  if (c.nt_is(T_Dirichlet)) {
    un = c.zonal(Z_Value);
    vn = 0.f;
  }
  c.store(U, un);
  c.store(V, vn);
}

template <int S, class Ctx>
__device__ __forceinline__ void stage(Ctx& c) {
  if constexpr (S == 0) run(c);
}

}  // namespace model
