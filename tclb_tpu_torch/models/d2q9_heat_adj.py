"""d2q9_heat_adj — conjugate heat-transfer topology optimization.

The port's counterpart of the JAX package's ``models/d2q9_heat_adj.py``
(the reference's ``d2q9_heat_adj``, example/heat_adj.xml): flow and
temperature with a design density ``w`` (``parameter=True``): Brinkman
velocity penalization (fluid where w = 1) and a w-interpolated thermal
diffusivity between ``FluidAlfa`` and ``SolidAlfa``; the globals HeatFlux
(Outlet nodes), HeatSourceTotal, Material (DesignSpace nodes) and Drag.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_heat_adj.cuh`` repeats, so the generic
kernels agree with this eager step to a few ulps.  ``|ux|`` in Drag is
written so that its derivative at 0 is +1, the JAX package's convention
(``jax.grad(jnp.abs)(0.0) == 1``; ``torch.abs`` gives 0 there), and the
kernel's reverse uses the same.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, OPP, _equilibrium, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import (_plane, _sum, _t_eq, get_rho,
                                             get_u)
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)


def _def() -> ModelDef:
    d = ModelDef("d2q9_heat_adj", ndim=2,
                 description="conjugate heat topology optimization")
    d.add_densities("f", E)
    d.add_densities("T", E, group="T")
    d.add_density("w", group="w", parameter=True)
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("T", unit="K")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("W")
    d.add_quantity("TB", adjoint=True)
    d.add_quantity("WB", adjoint=True)
    d.add_setting("omega", default=1.0)
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("InletVelocity")
    d.add_setting("InletTemperature", default=1.0)
    d.add_setting("InitTemperature", default=1.0)
    d.add_setting("InletDensity", default=1.0)
    d.add_setting("FluidAlfa", default=0.1)
    d.add_setting("SolidAlfa", default=0.01)
    d.add_setting("HeatSource", default=0.0,
                  comment="volumetric heating of solid (1-w)")
    d.add_setting("Porocity", default=0.0, zonal=True)
    d.add_global("HeatFlux")
    d.add_global("HeatSourceTotal")
    d.add_global("Material")
    d.add_global("Drag")
    return d


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose derivative is +1 at 0 (and at -0), as JAX's is."""
    return torch.where(x >= 0, x, -x)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    fT = ctx.group("T")
    w = ctx.density("w")
    vel = ctx.setting("InletVelocity")
    den = ctx.setting("InletDensity")
    t_in = ctx.setting("InletTemperature")

    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "WVelocity": lambda f: _zou_he_x(f, vel, "velocity", "W"),
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
    })
    fT = ctx.boundary_case(fT, {
        ("Wall", "Solid"): lambda t: lbm.perm(t, OPP),
        "WVelocity": lambda t: lbm.wstack(W, _plane(ctx, t_in)),
    })

    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho

    om = ctx.setting("omega")
    feq = _equilibrium(rho, ux, uy)
    coll = ctx.nt_in_group("COLLISION")
    # Brinkman penalization: velocity scaled by w (solid where w -> 0)
    ctx.add_global("Drag", (1.0 - w) * abs_jax(ux), where=coll)
    ux2, uy2 = ux * w, uy * w
    fc = f + om * (feq - f) + (_equilibrium(rho, ux2, uy2) - feq)

    temp = _sum(fT)
    alfa = ctx.setting("FluidAlfa") * w + ctx.setting("SolidAlfa") * (1.0 - w)
    om_t = 1.0 / (3.0 * alfa + 0.5)
    src = ctx.setting("HeatSource") * (1.0 - w)
    tc = fT + om_t[None] * (_t_eq(temp, ux2, uy2) - fT) + lbm.wstack(W, src)
    f = torch.where(coll[None], fc, f)
    fT = torch.where(coll[None], tc, fT)

    ctx.add_global("HeatFlux", temp * ux2, where=ctx.nt_is("Outlet"))
    ctx.add_global("HeatSourceTotal", src, where=coll)
    ctx.add_global("Material", 1.0 - w,
                   where=ctx.nt_in_group("DESIGNSPACE"))
    return ctx.store({"f": f, "T": fT})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    zero = torch.zeros(shape, dtype=dt, device=dev)
    f = _equilibrium(torch.ones(shape, dtype=dt, device=dev),
                     _plane(ctx, ctx.setting("InletVelocity")), zero)
    fT = _t_eq(_plane(ctx, ctx.setting("InitTemperature")), zero, zero)
    w = 1.0 - _plane(ctx, ctx.setting("Porocity"))
    w = torch.where(ctx.nt_is("Solid"), torch.zeros_like(w), w)
    return ctx.store({"f": f, "T": fT, "w": w[None]})


def build():
    def tq(c):
        return torch.sum(c.group("T"), dim=0)

    def wq(c):
        return c.density("w")

    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": get_rho, "T": tq, "U": get_u, "W": wq,
                    "TB": tq, "WB": wq})
