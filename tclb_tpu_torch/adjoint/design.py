"""Design parameterizations: what the optimizer's vector theta means.

The port's counterpart of the JAX package's ``adjoint/design.py`` (the
reference's Design handler family, ``GetParameters``/``SetParameters``,
src/Handlers.cpp.Rt:166-846).  A Design maps ``theta`` (a tensor, or a
tuple of tensors for a :class:`CompositeDesign`) into the (state, params)
pair inside the differentiated function, so ``torch.autograd`` brings the
gradient back in theta-space.

``InternalTopology`` is ported; the Control-series designs
(``OptimalControl``, ``Fourier``, ``BSpline``, ``RepeatControl``,
``ControlSecond``) need Control series and raise until ROADMAP queue 1
item 10 ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from tclb_tpu_torch.core.lattice import LatticeState, SimParams, _roadmap
from tclb_tpu_torch.core.registry import Model


class Design:
    """theta <-> (state, params) mapping.  ``get`` extracts the current
    value; ``put`` injects it (differentiable)."""

    def get(self, state: LatticeState, params: SimParams):
        raise NotImplementedError

    def put(self, theta, state: LatticeState, params: SimParams):
        raise NotImplementedError

    def bounds(self) -> tuple[Optional[float], Optional[float]]:
        return (None, None)


class InternalTopology(Design):
    """Per-node design densities (``parameter=True`` storage planes) masked
    by the DESIGNSPACE node-type group (reference InternalTopology,
    src/Handlers.cpp.Rt:166-200; bounds [0, 1]).  ``theta`` is the whole
    design plane stack; entries off the design space are ignored."""

    def __init__(self, model: Model, names: Optional[Sequence[str]] = None):
        self.model = model
        if names is None:
            names = [x.name for x in list(model.densities) + list(model.fields)
                     if x.parameter]
        if not names:
            raise ValueError(f"model {model.name} declares no parameter=True "
                             "densities/fields (no design space)")
        self.idx = [model.storage_index[n] for n in names]
        self.names = tuple(names)

    def _mask(self, state: LatticeState) -> torch.Tensor:
        return (state.flags & self.model.group_masks["DESIGNSPACE"]) != 0

    def get(self, state, params):
        return state.fields[self.idx].detach().clone()

    def put(self, theta, state, params):
        fields = state.fields.clone()
        fields[self.idx] = torch.where(self._mask(state)[None], theta,
                                       state.fields[self.idx])
        return dataclasses.replace(state, fields=fields), params

    def bounds(self):
        return (0.0, 1.0)


class CompositeDesign(Design):
    """Concatenation of several designs into one theta tuple (reference
    GenericOptimizer::Parameters, src/Handlers.cpp.Rt:1708-1775)."""

    def __init__(self, designs: Sequence[Design]):
        self.designs = tuple(designs)

    def get(self, state, params):
        return tuple(d.get(state, params) for d in self.designs)

    def put(self, theta, state, params):
        for d, th in zip(self.designs, theta):
            state, params = d.put(th, state, params)
        return state, params

    def bounds(self):
        return tuple(d.bounds() for d in self.designs)


class _SeriesDesign(Design):
    """A design over a Control time series (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise _roadmap(f"the {type(self).__name__} design (Control series)",
                       "item 10")


class OptimalControl(_SeriesDesign):
    """A zonal setting's time series (reference OptimalControl,
    src/Handlers.cpp.Rt:201-303)."""


class Fourier(_SeriesDesign):
    """A truncated Fourier basis over a control series (reference Fourier,
    src/Handlers.cpp.Rt:431-574)."""


class BSpline(_SeriesDesign):
    """Cubic B-spline control points (reference BSpline,
    src/Handlers.cpp.Rt:575-726)."""


class RepeatControl(_SeriesDesign):
    """One period tiled over the horizon (reference RepeatControl,
    src/Handlers.cpp.Rt:727-846)."""


class ControlSecond(_SeriesDesign):
    """Half-resolution control (reference OptimalControlSecond,
    src/Handlers.cpp.Rt:304-430)."""


def threshold_topology(model: Model, state: LatticeState,
                       level: float = 0.5) -> LatticeState:
    """Binarize the topology design fields at ``level`` (reference
    acThreshold/acThresholdNow, src/Handlers.cpp.Rt:2100-2190)."""
    topo = InternalTopology(model)
    cur = topo.get(state, None)
    binary = (cur > level).to(cur.dtype)
    with torch.no_grad():
        state, _ = topo.put(binary, state, None)
    return state
