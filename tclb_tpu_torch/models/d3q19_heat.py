"""d3q19_heat — 3D flow + temperature (d3q19 + d3q7 double distribution).

The port's counterpart of the JAX package's ``models/d3q19_heat.py`` on
PyTorch tensors: d3q19's two-rate MRT (``models/d3q19.py:collide``) under
the family's W/E faces and N/S symmetries, coupled to a d3q7 temperature
lattice ``T`` advected at the flow's velocity with diffusivity
``FluidAlfa`` (``om_t = 1 / (4 FluidAlfa + 1/2)``): bounce-back on Wall
and Solid, the inlet equilibrium at ``InletTemperature`` on WVelocity and
EPressure nodes, the ``HeaterTemperature`` target on Heater nodes, and
the temperature flux ``OutFlux`` summed on Outlet nodes.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d3q19_heat.cuh`` repeats, so the generic 3D
kernels agree with this eager step to a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d3q19 import E, OPP, W, collide, macroscopic
from tclb_tpu_torch.ops import lbm

# d3q7 for the scalar: rest + 6 axis vectors
ET = np.array([(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
               (0, 0, 1), (0, 0, -1)], dtype=np.int32)
WT = lbm.weights(ET)
OPPT = lbm.opposite(ET)


def _def():
    d = family.base_def("d3q19_heat", E, "3D flow + temperature",
                        faces="WE", symmetries="NS")
    d.add_densities("T", ET, group="T")
    d.add_setting("S_high", default=1.0)
    d.add_setting("InletTemperature", default=1.0)
    d.add_setting("InitTemperature", default=1.0)
    d.add_setting("FluidAlfa", default=1.0)
    d.add_setting("HeaterTemperature", default=100.0)
    d.add_quantity("T", unit="K")
    d.add_global("OutFlux")
    d.add_node_type("Heater", "ADDITIONALS")
    return d


def _t_eq(T, u) -> torch.Tensor:
    """The d3q7 equilibrium ``w_i T (1 + 4 e_i.u)``."""
    out = []
    for i in range(7):
        eu = lbm.edot(ET[i], u) if ET[i].any() else None
        wt = float(WT[i]) * T
        out.append(wt if eu is None else wt * (1.0 + 4.0 * eu))
    return torch.stack(out)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    fT = ctx.group("T")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    t_in = ctx.setting("InletTemperature")
    fT = ctx.boundary_case(fT, {
        ("Wall", "Solid"): lambda t: lbm.perm(t, OPPT),
        ("WVelocity", "EPressure"): lambda t: torch.stack(
            [torch.broadcast_to(float(w) * t_in, t.shape[1:])
             for w in WT]),
    })
    _, u = macroscopic(f)
    fc = collide(ctx, f)
    temp = lbm.edot(np.ones(7), fT)
    target = torch.where(ctx.nt_is("Heater"),
                         ctx.setting("HeaterTemperature"), temp)
    om_t = 1.0 / (4.0 * ctx.setting("FluidAlfa") + 0.5)
    tc = fT + om_t * (_t_eq(target, torch.stack(u)) - fT)
    coll = ctx.nt_in_group("COLLISION")[None]
    f = torch.where(coll, fc, f)
    fT = torch.where(coll, tc, fT)
    ctx.add_global("OutFlux", temp * u[0], where=ctx.nt_is("Outlet"))
    return ctx.store({"f": f, "T": fT})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    t0 = torch.broadcast_to(torch.as_tensor(ctx.setting("InitTemperature"),
                                            dtype=dt, device=dev), shape)
    fT = torch.stack([float(w) * t0 for w in WT])
    return family.standard_init(ctx, E, W, extra={"T": fT})


def build():
    q = family.make_getters(E, force_of=family.gravity_of)
    q["T"] = lambda c: torch.sum(c.group("T"), dim=0)
    return _def().finalize().bind(run=run, init=init, quantities=q)
