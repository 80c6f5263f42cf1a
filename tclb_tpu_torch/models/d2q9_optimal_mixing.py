"""d2q9_optimalMixing — mixing optimization (flow and a d2q5 scalar,
moving-wall control).

The port's counterpart of the JAX package's
``models/d2q9_optimal_mixing.py`` (the reference's ``d2q9_optimalMixing``):
BGK d2q9 flow with a d2q5 advected scalar (temperature), ``MovingWall``
nodes that bounce back and add ``6 w_i e_ix MovingWallVelocity`` (a zonal
setting: the stirring schedule an optimization controls), the scalar
bouncing back on Wall, Solid and MovingWall, and the mixing objectives
TotalTempSqr and CountCells on collision nodes and NMovingWallForce on
MovingWall nodes.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_optimal_mixing.cuh`` repeats, so the
generic kernels agree with this eager step to a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, OPP, _equilibrium
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum, get_rho, get_u
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
# d2q5 for the scalar
EG = np.array([(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)], dtype=np.int32)
WG = lbm.weights(EG)
OPPG = lbm.opposite(EG)


def _def() -> ModelDef:
    d = ModelDef("d2q9_optimalMixing", ndim=2,
                 description="mixing optimization with moving-wall control")
    d.add_densities("f", E)
    d.add_densities("g", EG, group="g")
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("T", unit="K")
    d.add_setting("omega", default=1.0)
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("omegaT", default=1.0)
    d.add_setting("K", default=1 / 6, comment="thermal diffusivity",
                  derived={"omegaT": lambda k: 1.0 / (3 * k + 0.5)})
    d.add_setting("MovingWallVelocity", default=0.0, zonal=True)
    d.add_setting("Velocity", default=0.0, zonal=True)
    d.add_setting("Pressure", default=0.0, zonal=True)
    d.add_setting("Temperature", default=0.0, zonal=True)
    d.add_global("TotalTempSqr")
    d.add_global("CountCells")
    d.add_global("NMovingWallForce")
    d.add_node_type("MovingWall", "BOUNDARY")
    return d


def _g_eq(T, ux, uy) -> torch.Tensor:
    """The d2q5 equilibrium ``w_i T (1 + 3 e_i.u)``, every term written
    out (zero components included), as the JAX package writes it."""
    out = []
    for i in range(5):
        eu = float(EG[i, 0]) * ux + float(EG[i, 1]) * uy
        out.append(float(WG[i]) * T * (1.0 + 3.0 * eu))
    return torch.stack(out)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    g = ctx.group("g")
    mwv = ctx.setting("MovingWallVelocity")

    def moving_wall(f):
        fb = lbm.perm(f, OPP)
        corr = torch.stack([
            6.0 * float(W[i]) * float(E[i, 0]) * mwv
            * torch.ones_like(f[0]) if E[i, 0] else torch.zeros_like(f[0])
            for i in range(9)])
        return fb + corr

    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "MovingWall": moving_wall,
    })
    g = ctx.boundary_case(g, {
        ("Wall", "Solid", "MovingWall"): lambda g: lbm.perm(g, OPPG),
    })

    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    fc = f + ctx.setting("omega") * (_equilibrium(rho, ux, uy) - f)
    temp = _sum(g)
    gc = g + ctx.setting("omegaT") * (_g_eq(temp, ux, uy) - g)
    coll = ctx.nt_in_group("COLLISION")
    f = torch.where(coll[None], fc, f)
    g = torch.where(coll[None], gc, g)

    # the mixing measure: the mean-free squared temperature
    # (reference TotalTempSqr/CountCells)
    ctx.add_global("TotalTempSqr", temp * temp, where=coll)
    ctx.add_global("CountCells", torch.ones_like(temp), where=coll)
    ex = lbm.edot(E[:, 0], f)
    ctx.add_global("NMovingWallForce", 2.0 * ex * mwv,
                   where=ctx.nt_is("MovingWall"))
    return ctx.store({"f": f, "g": g})


def init(ctx: NodeCtx) -> dict:
    rho = 1.0 + 3.0 * _plane(ctx, ctx.setting("Pressure"))
    ux = _plane(ctx, ctx.setting("Velocity"))
    zero = torch.zeros_like(ux)
    f = _equilibrium(rho, ux, zero)
    g = _g_eq(_plane(ctx, ctx.setting("Temperature")), zero, zero)
    return ctx.store({"f": f, "g": g})


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": get_rho, "U": get_u,
                    "T": lambda c: torch.sum(c.group("g"), dim=0)})
