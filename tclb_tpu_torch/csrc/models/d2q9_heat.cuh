// d2q9_heat device physics for the generic 2D kernels (csrc/generic2d.cu):
// the layout and enums of tclb_tpu_torch/models/d2q9_heat.py, whose
// Iteration action d2q9_heat_physics.cuh computes.
//
// The enums name the registry entries the kernels index by position;
// tclb_tpu_torch/ops/generic_kernels.py lists the same names in the same
// order (DEVICE_MODELS) and checks them against the model, and a CPU test
// checks this file against that list.

#pragma once

namespace model {

// storage planes: f[0..8], T[0..8] over the d2q9 velocity set
constexpr int N_STORAGE = 18;
constexpr int T0 = 9;          // first T plane
__host__ __device__ constexpr int ex(int k) {
  constexpr int t[N_STORAGE] = {0, 1, 0, -1, 0, 1, -1, -1, 1,
                                0, 1, 0, -1, 0, 1, -1, -1, 1};
  return t[k];
}
__host__ __device__ constexpr int ey(int k) {
  constexpr int t[N_STORAGE] = {0, 0, 1, 0, -1, 1, 1, -1, -1,
                                0, 0, 1, 0, -1, 1, 1, -1, -1};
  return t[k];
}

// the Iteration action: one stage (Run) that writes f and T
constexpr int N_STAGES = 1;
__host__ __device__ constexpr unsigned stage_writes(int) { return 0x3ffffu; }
__host__ __device__ constexpr int stage_ext(int) { return 0; }

enum Setting {
  S_omega, S_nu, S_InletVelocity, S_InletPressure, S_InletDensity,
  S_InletTemperature, S_InitTemperature, S_FluidAlfa, S_HeaterTemperature,
  S_OutFluxInObj, N_SETTINGS
};
enum NodeType {
  T_Heater, T_Wall, T_Solid, T_WVelocity, T_WPressure, T_EPressure,
  T_EVelocity, T_Outlet, N_TYPES
};
enum Group { G_COLLISION, N_GROUPS };
enum Zonal { Z_HeaterTemperature, N_ZONAL };
enum Global { GL_OutFlux, N_GLOBALS };

}  // namespace model

#include "d2q9_heat_physics.cuh"
