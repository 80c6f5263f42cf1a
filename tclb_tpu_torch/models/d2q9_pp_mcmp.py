"""d2q9_pp_MCMP — Shan-Chen multi-component multi-phase (two populations).

The port's counterpart of the JAX package's ``models/d2q9_pp_mcmp.py``
(reference src/d2q9_pp_MCMP) on PyTorch tensors.  Two d2q9 populations
``f`` and ``g`` with the pseudopotentials ``psi_f = rho_f`` and ``psi_g =
rho_g`` (walls carry the adhesion potentials ``Gad2/Gc`` and ``Gad1/Gc``),
the cross-component force ``F_f = -Gc psi_f sum_i w_i psi_g(x + e_i)
e_i`` (and its mirror for g), the viscosity-weighted common velocity, and
a BGK collision of each component toward the common velocity shifted by
its own force.  Per-component Zou/He faces (``rho = 3 P + 1``), full
bounce-back walls.  Three stages: ``BaseIteration`` collides, then
``CalcPsi_f`` and ``CalcPsi_g`` refresh the two Fields from the streamed
populations.

Every term is written in the order the device header
``csrc/models/d2q9_pp_mcmp.cuh`` repeats.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
OPP18 = np.concatenate([OPP, OPP + 9])


def _def() -> ModelDef:
    d = ModelDef("d2q9_pp_MCMP", ndim=2,
                 description="Shan-Chen multi-component multi-phase")
    d.add_densities("f", E)
    d.add_densities("g", E)
    d.add_field("psi_f", dx=(-1, 1), dy=(-1, 1))
    d.add_field("psi_g", dx=(-1, 1), dy=(-1, 1))
    d.add_stage("BaseIteration", "Run")
    d.add_stage("CalcPsi_f", "CalcPsi_f")
    d.add_stage("CalcPsi_g", "CalcPsi_g")
    d.add_stage("BaseInit", "Init", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "CalcPsi_f", "CalcPsi_g"))
    d.add_action("Init", ("BaseInit", "CalcPsi_f", "CalcPsi_g"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("Rhof", unit="kg/m3")
    d.add_quantity("Rhog", unit="kg/m3")
    d.add_quantity("P", unit="Pa")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("Ff", unit="N", vector=True)
    d.add_quantity("Fg", unit="N", vector=True)
    d.add_setting("omega", comment="one over relaxation time, f")
    d.add_setting("omega_g", comment="one over relaxation time, g")
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("nu_g", default=1 / 6,
                  derived={"omega_g": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity_f", default=0.0, zonal=True)
    d.add_setting("Pressure_f", default=0.0, zonal=True)
    d.add_setting("Velocity_g", default=0.0, zonal=True)
    d.add_setting("Pressure_g", default=0.0, zonal=True)
    d.add_setting("Density", default=1.0, zonal=True,
                  comment="init density of component f")
    d.add_setting("Density_dry", default=1.0, zonal=True,
                  comment="init density of component g")
    d.add_setting("Gc", comment="fluid-fluid interaction")
    d.add_setting("Gad1", comment="fluid1-wall adhesion")
    d.add_setting("Gad2", comment="fluid2-wall adhesion")
    d.add_setting("R", default=1.0, comment="EoS gas const (unused in the "
                  "live ideal-psi path, kept for config parity)")
    d.add_setting("T", default=1.0)
    d.add_setting("a", default=1.0)
    d.add_setting("b", default=4.0)
    d.add_setting("Smag", comment="Smagorinsky constant (MRT path only)")
    d.add_setting("SL_U", comment="shear layer velocity")
    d.add_setting("SL_lambda", comment="shear layer steepness")
    d.add_setting("SL_delta", comment="shear layer disturbance")
    d.add_setting("SL_L", comment="shear layer length scale (0 = off)")
    d.add_setting("GravitationX")
    d.add_setting("GravitationY")
    d.add_global("TotalDensity1", unit="kg/m3")
    d.add_global("TotalDensity2", unit="kg/m3")
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    d.add_node_type("Smagorinsky", "LES")
    d.add_node_type("Stab", "ENTROPIC")
    return d


def calc_psi_f(ctx: NodeCtx) -> dict:
    """psi_f = rho_f; walls carry Gad2/Gc (reference CalcPsi_f)."""
    rho = _sum(ctx.group("f"))
    return {"psi_f": torch.where(ctx.nt_is("Wall"),
                                 ctx.setting("Gad2") / ctx.setting("Gc"),
                                 rho)}


def calc_psi_g(ctx: NodeCtx) -> dict:
    rho = _sum(ctx.group("g"))
    return {"psi_g": torch.where(ctx.nt_is("Wall"),
                                 ctx.setting("Gad1") / ctx.setting("Gc"),
                                 rho)}


def _sc_force(ctx: NodeCtx, own: str, other: str):
    """Cross-component Shan-Chen force (reference getFf/getFg)."""
    psi0 = ctx.load(own)
    fx = sum(float(W[i] * E[i, 0])
             * ctx.load(other, int(E[i, 0]), int(E[i, 1]))
             for i in range(1, 9) if E[i, 0])
    fy = sum(float(W[i] * E[i, 1])
             * ctx.load(other, int(E[i, 0]), int(E[i, 1]))
             for i in range(1, 9) if E[i, 1])
    gc = ctx.setting("Gc")
    return (-gc * psi0 * fx + ctx.setting("GravitationX"),
            -gc * psi0 * fy + ctx.setting("GravitationY"))


def _common_u(ctx: NodeCtx, f, g):
    """Viscosity-weighted common velocity (reference getU)."""
    om_f, om_g = ctx.setting("omega"), ctx.setting("omega_g")
    jfx = lbm.edot(E[:, 0], f)
    jfy = lbm.edot(E[:, 1], f)
    jgx = lbm.edot(E[:, 0], g)
    jgy = lbm.edot(E[:, 1], g)
    den = _sum(f) / om_f + _sum(g) / om_g
    den = torch.where(torch.abs(den) > 1e-12, den, 1.0)
    return (jfx / om_f + jgx / om_g) / den, (jfy / om_f + jgy / om_g) / den


def _zou_he(ctx: NodeCtx, stack, side, kind):
    """Per-component Zou/He on an x face, ``rho = 3 P + 1``."""
    out = []
    for base, sfx in ((0, "_f"), (9, "_g")):
        vel = ctx.setting("Velocity" + sfx)
        den = 3.0 * ctx.setting("Pressure" + sfx) + 1.0
        out.append(lbm.nebb_boundary(E, W, OPP, stack[base:base + 9], 0,
                                     side, kind,
                                     vel if kind == "velocity" else den))
    return torch.cat(out)


def run(ctx: NodeCtx) -> dict:
    fg = torch.cat([ctx.group("f"), ctx.group("g")])
    fg = ctx.boundary_case(fg, {
        ("Wall", "Solid"): lambda s: lbm.perm(s, OPP18),
        "EVelocity": lambda s: _zou_he(ctx, s, -1, "velocity"),
        "WPressure": lambda s: _zou_he(ctx, s, +1, "pressure"),
        "WVelocity": lambda s: _zou_he(ctx, s, +1, "velocity"),
        "EPressure": lambda s: _zou_he(ctx, s, -1, "pressure"),
    })
    f, g = fg[:9], fg[9:]
    rf = _sum(f)
    rg = _sum(g)
    ux, uy = _common_u(ctx, f, g)
    ffx, ffy = _sc_force(ctx, "psi_f", "psi_g")
    fgx, fgy = _sc_force(ctx, "psi_g", "psi_f")
    om_f, om_g = ctx.setting("omega"), ctx.setting("omega_g")

    def shifted(u_c, force, om, rho):
        safe = torch.where(rho > 1e-4, rho, 1.0)
        return torch.where(rho > 1e-4, u_c + force / (om * safe), u_c)

    uf = (shifted(ux, ffx, om_f, rf), shifted(uy, ffy, om_f, rf))
    ug = (shifted(ux, fgx, om_g, rg), shifted(uy, fgy, om_g, rg))
    fc = f - om_f * (f - lbm.equilibrium(E, W, rf, uf))
    gc = g - om_g * (g - lbm.equilibrium(E, W, rg, ug))
    coll = ctx.nt_in_group("COLLISION")
    ctx.add_global("TotalDensity1", rf, where=coll)
    ctx.add_global("TotalDensity2", rg, where=coll)
    return ctx.store({"f": torch.where(coll[None], fc, f),
                      "g": torch.where(coll[None], gc, g)})


def init(ctx: NodeCtx) -> dict:
    """Component equilibria from Density / Density_dry, the optional
    double shear layer (SL_L > 0); walls start empty."""
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    rho_f = _plane(ctx, ctx.setting("Density"))
    rho_g = _plane(ctx, ctx.setting("Density_dry"))
    sl_l = ctx.setting("SL_L")
    y = torch.broadcast_to(torch.arange(shape[0], dtype=dt,
                                        device=dev)[:, None], shape)
    x = torch.broadcast_to(torch.arange(shape[1], dtype=dt,
                                        device=dev)[None, :], shape)
    sl_on = sl_l > 0
    safe_l = torch.where(sl_on, sl_l, 1.0)
    ux_sl = torch.where(
        y < safe_l / 2,
        ctx.setting("SL_U") * torch.tanh(
            ctx.setting("SL_lambda") * (y / safe_l - 0.25)),
        ctx.setting("SL_U") * torch.tanh(
            ctx.setting("SL_lambda") * (0.75 - y / safe_l)))
    uy_sl = (ctx.setting("SL_delta") * ctx.setting("SL_U")
             * torch.sin(2.0 * np.pi * (x / safe_l + 0.25)))
    ux = torch.where(sl_on, ux_sl, 0.0)
    uy = torch.where(sl_on, uy_sl, 0.0)
    wall = ctx.nt_is("Wall")
    rho_f = torch.where(wall, 0.0, rho_f)
    rho_g = torch.where(wall, 0.0, rho_g)
    f = lbm.equilibrium(E, W, rho_f, (ux + ctx.setting("Velocity_f"), uy))
    g = lbm.equilibrium(E, W, rho_g, (ux + ctx.setting("Velocity_g"), uy))
    return ctx.store({"f": f, "g": g})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    ux, uy = _common_u(ctx, ctx.group("f"), ctx.group("g"))
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_p(ctx: NodeCtx) -> torch.Tensor:
    """Mixture pressure rho/3 + Gc psi_f psi_g / 3 (reference getP)."""
    rho = _sum(ctx.group("f")) + _sum(ctx.group("g"))
    return rho / 3.0 + ctx.setting("Gc") * ctx.load("psi_f") \
        * ctx.load("psi_g") / 3.0


def _force(own, other):
    def q(ctx):
        fx, fy = _sc_force(ctx, own, other)
        return torch.stack([fx, fy, torch.zeros_like(fx)])
    return q


def build():
    return _def().finalize().bind(
        run=run, init=init,
        stages={"CalcPsi_f": calc_psi_f, "CalcPsi_g": calc_psi_g},
        quantities={
            "Rho": lambda c: _sum(c.group("f")) + _sum(c.group("g")),
            "Rhof": lambda c: _sum(c.group("f")),
            "Rhog": lambda c: _sum(c.group("g")),
            "P": get_p,
            "U": get_u,
            "Ff": _force("psi_f", "psi_g"),
            "Fg": _force("psi_g", "psi_f"),
        })
