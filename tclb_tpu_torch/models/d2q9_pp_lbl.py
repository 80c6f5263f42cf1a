"""d2q9_pp_LBL — pseudopotential multiphase, Lycett-Brown & Luo forcing.

The port's counterpart of the JAX package's ``models/d2q9_pp_lbl.py``
(the reference's ``d2q9_pp_LBL``).  Two stages, like the kuper family:
``calcPsi`` computes the pseudopotential ``psi = sqrt(2 (p0 - rho/3) /
(G/3))`` from the Carnahan-Starling EoS, then ``Run`` applies the
boundary cases and a BGK collision with the LBL third-order-corrected
forcing (``gamma = 1 - omega/4 - rho omega / (4 G cs2 psi^2)``) and the
Shan-Chen force ``F = -G psi(0) sum_i w_i psi(x + e_i) e_i``.  As in the
reference, the collision runs at ``tempomega``, not ``omega``.

Sums over populations run in plane order, powers as products and every
term in the order the device header ``csrc/models/d2q9_pp_lbl.cuh``
repeats.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, _symmetry, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
CS2 = 1.0 / 3.0


def _def() -> ModelDef:
    d = ModelDef("d2q9_pp_LBL", ndim=2,
                 description="pseudopotential multiphase (Lycett-Brown/Luo "
                             "forcing, Carnahan-Starling EoS)")
    d.add_densities("f", E)
    d.add_field("psi", dx=(-1, 1), dy=(-1, 1))
    d.add_stage("BaseIteration", "Run")
    d.add_stage("calcPsi", "calcPsi")
    d.add_stage("BaseInit", "Init", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "calcPsi"))
    d.add_action("Init", ("BaseInit", "calcPsi"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("F", unit="N", vector=True)
    d.add_quantity("P", unit="Pa")
    d.add_quantity("Psi", unit="1")
    d.add_setting("G", default=-1.0, comment="interaction strength")
    d.add_setting("T", default=0.0585, comment="effective temperature")
    d.add_setting("alpha", default=0.25, comment="CS EoS parameter")
    d.add_setting("R", default=0.25, comment="CS EoS parameter")
    d.add_setting("beta", default=1.0, comment="CS EoS parameter")
    d.add_setting("kappa", default=0.0, comment="surface tension parameter")
    d.add_setting("eps_0", default=2.0, comment="mechanical stability coef")
    d.add_setting("betaforcing", default=1.0, comment="beta forcing scheme")
    d.add_setting("omega", comment="one over relaxation time")
    d.add_setting("tempomega", default=1.0,
                  comment="relaxation rate the reference actually collides "
                          "with (src/d2q9_pp_LBL/Dynamics.c.Rt:352)")
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity", default=0.0, zonal=True)
    d.add_setting("VelocityY", default=0.0, zonal=True)
    d.add_setting("Density", default=1.0, zonal=True)
    d.add_setting("GravitationY")
    d.add_setting("GravitationX")
    for i, dflt in enumerate([0, 0, 0, -1 / 3, 0, 0, 0, 0, 0]):
        d.add_setting(f"S{i}", default=dflt, comment="MRT rate (unused in "
                      "the BGK path, kept for config parity)")
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    d.add_node_type("BottomSymmetry", "BOUNDARY")
    d.add_node_type("TopSymmetry", "BOUNDARY")
    # declared for config parity; as in the reference, Run never
    # dispatches it
    d.add_node_type("RightSymmetry", "BOUNDARY")
    return d


def _cs_pressure(ctx: NodeCtx, rho):
    """The Carnahan-Starling EoS."""
    bp = rho * ctx.setting("beta") / 4.0
    om = 1.0 - bp
    return (rho * ctx.setting("R") * ctx.setting("T")
            * (1.0 + bp + bp * bp - bp * bp * bp) / (om * om * om)
            - ctx.setting("alpha") * rho * rho)


def calc_psi(ctx: NodeCtx) -> dict:
    """psi = sqrt(2 (p0 - rho/3) / (G/3)), clamped at 0 against
    round-off (the reference lets sqrt give NaN there)."""
    rho = _sum(ctx.group("f"))
    p0 = _cs_pressure(ctx, rho)
    arg = 2.0 * (p0 - rho / 3.0) / (ctx.setting("G") / 3.0)
    return {"psi": torch.sqrt(torch.clamp(arg, min=0.0))}


def _force(ctx: NodeCtx, rho):
    """The Shan-Chen force plus gravity."""
    psi0 = ctx.load("psi")
    fx = fy = None
    for i in range(1, 9):
        p = ctx.load("psi", int(E[i, 0]), int(E[i, 1]))
        if E[i, 0]:
            t = float(W[i] * E[i, 0]) * p
            fx = t if fx is None else fx + t
        if E[i, 1]:
            t = float(W[i] * E[i, 1]) * p
            fy = t if fy is None else fy + t
    g = ctx.setting("G")
    return (-g * psi0 * fx + ctx.setting("GravitationX") * rho,
            -g * psi0 * fy + ctx.setting("GravitationY") * rho)


def _collision_bgk(ctx: NodeCtx, f):
    """BGK at ``tempomega`` with the LBL forcing source term."""
    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    fx, fy = _force(ctx, rho)
    om = ctx.setting("tempomega")
    g = ctx.setting("G")
    psi0 = ctx.load("psi")
    psi_safe = torch.where(torch.abs(psi0) > 1e-30, psi0,
                           torch.full_like(psi0, 1e-30))
    gamma = 1.0 - 0.25 * om - rho * om / (4.0 * g * CS2
                                          * psi_safe * psi_safe)
    feq = lbm.equilibrium(E, W, rho, (ux, uy))
    ff = fx * fx + fy * fy
    out = []
    for i in range(9):
        ex, ey = float(E[i, 0]), float(E[i, 1])
        eu = ex * ux + ey * uy
        ef = ex * fx + ey * fy
        s = float(W[i]) * ((ex - ux + ex * eu / CS2) * fx
                           + (ey - uy + ey * eu / CS2) * fy
                           + (gamma / (2.0 * rho)) * (ef * ef / CS2 - ff)
                           ) / CS2
        out.append(f[i] - om * (f[i] - feq[i]) + s)
    return torch.stack(out)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    vel = ctx.setting("Velocity")
    den = ctx.setting("Density")

    def wvel_eq(f):
        # an equilibrium inlet at the zonal Density and Velocity
        rho = _plane(ctx, den)
        ux = _plane(ctx, vel)
        return lbm.equilibrium(E, W, rho, (ux, torch.zeros_like(ux)))

    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, den, "pressure", "W"),
        "WVelocity": wvel_eq,
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
        "TopSymmetry": lambda f: _symmetry(f, top=True),
        "BottomSymmetry": lambda f: _symmetry(f, top=False),
    })
    f = torch.where(ctx.nt_in_group("COLLISION")[None],
                    _collision_bgk(ctx, f), f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    rho = _plane(ctx, ctx.setting("Density"))
    ux = _plane(ctx, ctx.setting("Velocity"))
    uy = _plane(ctx, ctx.setting("VelocityY"))
    return ctx.store({"f": lbm.equilibrium(E, W, rho, (ux, uy))})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    """The velocity with the half-force shift."""
    f = ctx.group("f")
    rho = _sum(f)
    fx, fy = _force(ctx, rho)
    ux = (lbm.edot(E[:, 0], f) + 0.5 * fx) / rho
    uy = (lbm.edot(E[:, 1], f) + 0.5 * fy) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_f(ctx: NodeCtx) -> torch.Tensor:
    fx, fy = _force(ctx, _sum(ctx.group("f")))
    return torch.stack([fx, fy, torch.zeros_like(fx)])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={
            "Rho": lambda c: _sum(c.group("f")),
            "U": get_u,
            "F": get_f,
            "P": lambda c: _cs_pressure(c, _sum(c.group("f"))),
            "Psi": lambda c: c.load("psi"),
        },
        stages={"calcPsi": calc_psi})
