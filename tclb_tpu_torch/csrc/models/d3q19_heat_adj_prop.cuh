// d3q19_heat_adj_prop device physics for the generic 3D kernels:
// the _prop variant, whose
// design propagates along +x through w0 and w1, clipped, with the
// MaterialPenalty global
// (csrc/models/d3q19_heat_adj_common.cuh holds the physics of the three
// variants).

#pragma once

#define HEAT_ADJ_VARIANT 2

#include "d3q19_heat_adj_common.cuh"
