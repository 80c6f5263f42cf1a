// d3q19_heat_adj device physics for the generic 3D kernels:
// the base variant, whose
// momentum the design w scales
// (csrc/models/d3q19_heat_adj_common.cuh holds the physics of the three
// variants).

#pragma once

#define HEAT_ADJ_VARIANT 0

#include "d3q19_heat_adj_common.cuh"
