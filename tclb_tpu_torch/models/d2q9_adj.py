"""d2q9_adj — 2D MRT with a per-node porosity design field for adjoint
topology optimization.

The port's counterpart of the JAX package's ``models/d2q9_adj.py`` (the
reference's ``d2q9_adj``, example/adj_drag.xml): a design density ``w``
(``parameter=True``, not streamed), the hyperbolic porosity transform
``nw = w / (1 - PorocityGamma (1 - w))`` and the Brinkman penalisation
``u *= nw`` inside an MRT collision that keeps only the moment rows 3
(-1/3), 7 and 8 (``omega``, a keep factor: ``1 - 1 / (3 nu + 0.5)``); Drag
and Lift as ``(1 - nw) (u + Force)`` on MRT nodes, Material and
MaterialPenalty on DesignSpace nodes, and the in/outlet flux objectives.
Zou/He faces read the zonal Velocity and ``1 + 3 Pressure``.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_adj.cuh`` repeats, so the generic kernels
agree with this eager step to a few ulps.
"""

from __future__ import annotations

import math

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, M, OPP, _equilibrium, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm


def _def() -> ModelDef:
    d = ModelDef("d2q9_adj", ndim=2,
                 description="2D MRT with porosity design field (adjoint "
                             "topology optimization)")
    d.add_densities("f", E)
    d.add_density("w", group="w", parameter=True)
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("W")
    d.add_quantity("RhoB", adjoint=True)
    d.add_quantity("UB", adjoint=True, vector=True)
    d.add_quantity("WB", adjoint=True)
    d.add_setting("omega", comment="one over relaxation time")
    d.add_setting("nu", default=1 / 6, comment="viscosity",
                  derived={"omega": lambda nu: 1.0 - 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity", default=0.0, zonal=True,
                  comment="inlet velocity")
    d.add_setting("Pressure", default=0.0, zonal=True,
                  comment="inlet pressure")
    d.add_setting("ForceX")
    d.add_setting("ForceY")
    d.add_setting("PorocityGamma",
                  comment="gamma of the hyperbolic porosity transform")
    d.add_setting("PorocityTheta",
                  derived={"PorocityGamma": lambda th: 1.0 - math.exp(th)},
                  comment="theta of the hyperbolic porosity transform")
    d.add_setting("Porocity", zonal=True,
                  comment="initial porosity of design nodes")
    d.add_global("Drag")
    d.add_global("Lift")
    d.add_global("MaterialPenalty")
    d.add_global("Material")
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    return d


def _collision_mrt(ctx: NodeCtx, f: torch.Tensor, w: torch.Tensor):
    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho

    usq = ux * ux + uy * uy
    ploss = ux / rho * ((rho - 1.0) / 3.0 + usq / rho * 0.5)
    ctx.add_global("OutletFlux", ux / rho, where=ctx.nt_is("Outlet"))
    ctx.add_global("InletFlux", ux / rho, where=ctx.nt_is("Inlet"))
    ctx.add_global("PressureLoss",
                   torch.where(ctx.nt_is("Inlet"), ploss, -ploss),
                   where=ctx.nt_is("Inlet") | ctx.nt_is("Outlet"))

    # keep factors: energy -1/3, the stress rows omega (reference OMEGA
    # vector, src/d2q9_adj/Dynamics.c.Rt:137); every other row drops
    om = ctx.setting("omega")
    feq = _equilibrium(rho, ux, uy)
    mn = lbm.moments(M, f - feq)
    keep = [None, None, None, -1.0 / 3.0, None, None, None, om, om]
    m_neq = torch.stack([torch.zeros_like(mn[i]) if r is None else mn[i] * r
                         for i, r in enumerate(keep)])

    ux2 = ux + ctx.setting("ForceX")
    uy2 = uy + ctx.setting("ForceY")
    # hyperbolic porosity transform and Brinkman penalisation
    # (reference src/d2q9_adj/Dynamics.c.Rt:184-189)
    nw = w / (1.0 - ctx.setting("PorocityGamma") * (1.0 - w))
    ctx.add_global("Drag", (1.0 - nw) * ux2, where=ctx.nt_is("MRT"))
    ctx.add_global("Lift", (1.0 - nw) * uy2, where=ctx.nt_is("MRT"))
    ux2, uy2 = ux2 * nw, uy2 * nw
    m_post = m_neq + lbm.moments(M, _equilibrium(rho, ux2, uy2))
    return lbm.from_moments(M, m_post)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    w = ctx.density("w")
    vel = ctx.setting("Velocity")
    den = 1.0 + 3.0 * ctx.setting("Pressure")
    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, den, "pressure", "W"),
        "WVelocity": lambda f: _zou_he_x(f, vel, "velocity", "W"),
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
    })
    f = torch.where(ctx.nt_is("MRT")[None], _collision_mrt(ctx, f, w), f)
    # the material objectives live on DesignSpace nodes
    # (reference src/d2q9_adj/Dynamics.c.Rt:108-111)
    in_design = ctx.nt_in_group("DESIGNSPACE")
    ctx.add_global("MaterialPenalty", w * (1.0 - w), where=in_design)
    ctx.add_global("Material", 1.0 - w, where=in_design)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    den = 1.0 + 3.0 * _plane(ctx, ctx.setting("Pressure"))
    vel = _plane(ctx, ctx.setting("Velocity"))
    f = _equilibrium(den, vel, torch.zeros_like(vel))
    w = 1.0 - _plane(ctx, ctx.setting("Porocity"))
    w = torch.where(ctx.nt_is("Solid"), torch.zeros_like(w), w)
    return ctx.store({"f": f, "w": w[None]})


def get_rho(ctx: NodeCtx) -> torch.Tensor:
    return torch.sum(ctx.group("f"), dim=0)


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_w(ctx: NodeCtx) -> torch.Tensor:
    return ctx.density("w")


def build():
    # the adjoint quantities read the same expressions over the adjoint
    # (cotangent) planes (reference getRhoB/getUB/getWB)
    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": get_rho, "U": get_u, "W": get_w,
                    "RhoB": get_rho, "UB": get_u, "WB": get_w})
