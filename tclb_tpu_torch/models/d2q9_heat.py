"""d2q9_heat — coupled flow + temperature (double-distribution d2q9+d2q9).

The port's counterpart of the JAX package's ``models/d2q9_heat.py`` on
PyTorch tensors: a d2q9 ``f`` lattice for flow and a second d2q9 ``T``
lattice advecting temperature at the fluid velocity with diffusivity
``FluidAlfa``; ``Heater`` nodes (ADDITIONALS group) pin the relaxation
target temperature to the zonal ``HeaterTemperature`` (the reference
hard-codes 100, src/d2q9_heat/Dynamics.c.Rt:257).

Sums over populations run in plane order and every term in the order
the device header ``csrc/models/d2q9_heat.cuh`` repeats, so the generic
kernels agree with this eager step to a few ulps.  ``run`` is shared with
``d2q9_heat_conjugate`` (``solid_adiabatic=False``) and ``d2q9_hb``;
``_t_eq``, ``get_rho`` and ``get_u`` with ``d2q9_heat_adj``.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, OPP, _equilibrium, _zou_he_x
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)


def _def() -> ModelDef:
    d = ModelDef("d2q9_heat", ndim=2,
                 description="2D flow + temperature (double distribution)")
    d.add_densities("f", E)
    d.add_densities("T", E, group="T")
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("T", unit="K")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_setting("omega", default=1.0, comment="one over relaxation time")
    d.add_setting("nu", default=1 / 6, comment="viscosity",
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("InletVelocity", comment="inlet velocity")
    d.add_setting("InletPressure", default=0.0, comment="inlet pressure",
                  derived={"InletDensity": lambda p: 1.0 + p / 3.0})
    d.add_setting("InletDensity", default=1.0)
    d.add_setting("InletTemperature", default=1.0)
    d.add_setting("InitTemperature", default=1.0)
    d.add_setting("FluidAlfa", default=1.0, comment="thermal diffusivity")
    d.add_setting("HeaterTemperature", default=100.0, zonal=True,
                  comment="pinned temperature of Heater nodes")
    d.add_global("OutFlux")
    d.add_node_type("Heater", "ADDITIONALS")
    return d


def _sum(stack: torch.Tensor) -> torch.Tensor:
    """``stack[0] + stack[1] + ...`` in plane order (the device headers
    repeat this order)."""
    return lbm.edot([1.0] * len(stack), stack)


def _t_eq(T, ux, uy) -> torch.Tensor:
    """Temperature equilibrium ``w_i T (1 + 3 e_i.u)``; the rest
    population is ``w_0 T``."""
    out = [float(W[0]) * T]
    for i in range(1, 9):
        eu = lbm.edot(E[i], (ux, uy))
        out.append(float(W[i]) * T * (1.0 + 3.0 * eu))
    return torch.stack(out)


def _plane(ctx: NodeCtx, value) -> torch.Tensor:
    f = ctx._fields
    return torch.broadcast_to(torch.as_tensor(value, dtype=f.dtype,
                                              device=f.device),
                              tuple(ctx.flags.shape))


def run(ctx: NodeCtx, solid_adiabatic: bool = True) -> dict:
    f = ctx.group("f")
    fT = ctx.group("T")
    vel = ctx.setting("InletVelocity")
    den = ctx.setting("InletDensity")
    t_in = ctx.setting("InletTemperature")

    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "WVelocity": lambda f: _zou_he_x(f, vel, "velocity", "W"),
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, den, "pressure", "W"),
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
    })
    # temperature: bounce-back at walls (adiabatic), the inlet temperature's
    # equilibrium at rest on velocity inlets and pressure outlets
    t_wall = ("Wall", "Solid") if solid_adiabatic else ("Wall",)
    fT = ctx.boundary_case(fT, {
        t_wall: lambda t: lbm.perm(t, OPP),
        ("WVelocity", "EPressure"): lambda t: lbm.wstack(
            W, _plane(ctx, t_in)),
    })

    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    om = ctx.setting("omega")
    feq = _equilibrium(rho, ux, uy)
    fc = f + om * (feq - f)

    temp = _sum(fT)
    target = torch.where(ctx.nt_is("Heater"),
                         ctx.setting("HeaterTemperature"), temp)
    om_t = 1.0 / (3.0 * ctx.setting("FluidAlfa") + 0.5)
    tc = fT + om_t * (_t_eq(target, ux, uy) - fT)

    coll = ctx.nt_in_group("COLLISION")[None]
    f = torch.where(coll, fc, f)
    fT = torch.where(coll, tc, fT)
    ctx.add_global("OutFlux", temp * ux, where=ctx.nt_is("Outlet"))
    return ctx.store({"f": f, "T": fT})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    zero = torch.zeros(shape, dtype=dt, device=dev)
    f = _equilibrium(torch.ones(shape, dtype=dt, device=dev),
                     _plane(ctx, ctx.setting("InletVelocity")), zero)
    fT = _t_eq(_plane(ctx, ctx.setting("InitTemperature")), zero, zero)
    return ctx.store({"f": f, "T": fT})


def get_rho(ctx: NodeCtx) -> torch.Tensor:
    return torch.sum(ctx.group("f"), dim=0)


def get_t(ctx: NodeCtx) -> torch.Tensor:
    return torch.sum(ctx.group("T"), dim=0)


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": get_rho, "T": get_t, "U": get_u})
