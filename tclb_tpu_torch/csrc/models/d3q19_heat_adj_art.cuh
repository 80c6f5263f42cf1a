// d3q19_heat_adj_art device physics for the generic 3D kernels:
// the _art variant, whose
// momentum 2 w - 1 scales
// (csrc/models/d3q19_heat_adj_common.cuh holds the physics of the three
// variants).

#pragma once

#define HEAT_ADJ_VARIANT 1

#include "d3q19_heat_adj_common.cuh"
