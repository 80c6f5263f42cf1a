"""d2q9_lee — Lee-Lin multiphase with potential-form forcing.

The port's counterpart of the JAX package's ``models/d2q9_lee.py``
(reference src/d2q9_lee) on PyTorch tensors.  One d2q9 population and two
Fields read over +-2: the density ``rho`` (recomputed each step with the
boundary overrides, ``CalcRho``) and the chemical potential ``nu = mu0 -
Kappa lap(rho)`` with the double well ``mu0 = 2 Beta (r - rho_l)(r -
rho_v)(2r - rho_v - rho_l)`` (``CalcNu``).  The collision applies Lee's
mixed-difference forcing: per direction a biased (one-sided, distance 2)
and a central projection ``cs2 grad rho - rho grad nu + e.G - u.G``, the
central one inside the velocity and the pre-collision shift, the biased
one after relaxation (BGK, and the reference's literal ``(S - 1)`` MRT).
Three stages: ``BaseIteration``, ``CalcRho`` (streams), ``CalcNu`` (does
not).

Every term is written in the order the device header
``csrc/models/d2q9_lee.cuh`` repeats.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, M, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
CS2 = 1.0 / 3.0
# MRT rates S4..S7 of the reference's #define block (Dynamics.c.Rt:8-13);
# S8 and S9 take omega at run time
MRT_S_FIXED = {3: 4.0 / 3.0, 4: 1.0, 5: 1.0, 6: 1.0}


def _def() -> ModelDef:
    d = ModelDef("d2q9_lee", ndim=2,
                 description="Lee multiphase (potential-form forcing)")
    d.add_densities("f", E)
    d.add_field("rho", dx=(-2, 2), dy=(-2, 2))
    d.add_field("nu", dx=(-2, 2), dy=(-2, 2))
    d.add_stage("BaseIteration", "Run")
    d.add_stage("CalcRho", "CalcRho")
    d.add_stage("CalcNu", "CalcNu", load_densities=False)
    d.add_stage("InitF2", "InitF2", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "CalcRho", "CalcNu"))
    d.add_action("Init", ("InitF2", "CalcRho", "CalcNu"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("Nu", unit="kg/m3")
    d.add_quantity("P", unit="Pa")
    d.add_setting("omega", comment="one over relaxation time")
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("InletVelocity", default=0.0, zonal=True)
    d.add_setting("InletPressure", default=0.0, zonal=True,
                  derived={"InletDensity": lambda p: 1.0 + p / 3.0})
    d.add_setting("InletDensity", default=1.0, zonal=True)
    d.add_setting("OutletDensity", default=1.0, zonal=True)
    d.add_setting("InitDensity", zonal=True)
    d.add_setting("WallDensity", zonal=True)
    d.add_setting("GravitationY")
    d.add_setting("GravitationX")
    d.add_setting("MovingWallVelocity", zonal=True)
    d.add_setting("WetDensity", zonal=True)
    d.add_setting("DryDensity", zonal=True)
    d.add_setting("Wetting", zonal=True)
    d.add_setting("LiquidDensity")
    d.add_setting("VaporDensity")
    d.add_setting("Beta")
    d.add_setting("Kappa")
    d.add_global("MomentumX")
    d.add_global("MomentumY")
    d.add_global("Mass")
    d.add_node_type("MovingWall", "BOUNDARY")
    d.add_node_type("ForcedMovingWall", "BOUNDARY")
    d.add_node_type("Wet", "ADDITIONALS")
    d.add_node_type("Dry", "ADDITIONALS")
    return d


def _mu0(ctx: NodeCtx, r):
    """The double-well bulk chemical potential (reference getP/CalcNu)."""
    rl = ctx.setting("LiquidDensity")
    rv = ctx.setting("VaporDensity")
    return 2.0 * ctx.setting("Beta") * (r - rl) * (r - rv) \
        * (2.0 * r - rv - rl)


def calc_rho(ctx: NodeCtx) -> dict:
    """rho = sum(f) with the boundary overrides (reference CalcRho)."""
    rho = _sum(ctx.group("f"))
    wallish = ctx.nt_is("Wall") | ctx.nt_is("MovingWall")
    wall_rho = ctx.setting("WallDensity")
    wall_rho = torch.where(ctx.nt_is("Wet") & wallish,
                           ctx.setting("WetDensity"), wall_rho)
    wall_rho = torch.where(ctx.nt_is("Dry") & wallish,
                           ctx.setting("DryDensity"), wall_rho)
    rho = torch.where(wallish, wall_rho, rho)
    rho = torch.where(ctx.nt_is("EPressure"), ctx.setting("OutletDensity"),
                      rho)
    rho = torch.where(ctx.nt_is("WPressure"), ctx.setting("InletDensity"),
                      rho)
    return {"rho": rho}


def calc_nu(ctx: NodeCtx) -> dict:
    """nu = mu0(rho) - Kappa lap(rho), lap = sum_i (w_i/cs2)(rho(e) - 2
    rho(0) + rho(-e)) (reference CalcNu)."""
    r0 = ctx.load("rho")
    lap = sum(float(W[i] / CS2)
              * (ctx.load("rho", int(E[i, 0]), int(E[i, 1]))
                 - 2.0 * r0
                 + ctx.load("rho", -int(E[i, 0]), -int(E[i, 1])))
              for i in range(1, 9))
    return {"nu": _mu0(ctx, r0) - ctx.setting("Kappa") * lap}


def _projections(ctx: NodeCtx, u, d):
    """Per-direction biased and central force projections fB_i / fC_i
    (reference fillF)."""
    gx = ctx.setting("GravitationX")
    gy = ctx.setting("GravitationY")
    ug = u[0] * gx + u[1] * gy
    fB, fC = [], []
    for i in range(9):
        dx, dy = int(E[i, 0]), int(E[i, 1])
        if dx == 0 and dy == 0:
            grad_b = grad_c = 0.0
        else:
            r1 = ctx.load("rho", dx, dy)
            r2 = ctx.load("rho", 2 * dx, 2 * dy)
            r0 = ctx.load("rho")
            rm = ctx.load("rho", -dx, -dy)
            n1 = ctx.load("nu", dx, dy)
            n2 = ctx.load("nu", 2 * dx, 2 * dy)
            n0 = ctx.load("nu")
            nm = ctx.load("nu", -dx, -dy)
            grad_b = 0.5 * (-r2 + 4.0 * r1 - 3.0 * r0) * CS2 \
                - d * 0.5 * (-n2 + 4.0 * n1 - 3.0 * n0)
            grad_c = 0.5 * (r1 - rm) * CS2 - d * 0.5 * (n1 - nm)
        eg = float(E[i, 0]) * gx + float(E[i, 1]) * gy
        fB.append(grad_b + eg - ug)
        fC.append(grad_c + eg - ug)
    # ForcedMovingWall: the momentum-matching force (reference fillF)
    fmw = ctx.nt_is("ForcedMovingWall")
    gx2 = (ctx.setting("MovingWallVelocity") - u[0]) * d
    gy2 = (0.0 - u[1]) * d
    ug2 = u[0] * gx2 + u[1] * gy2
    for i in range(9):
        extra = float(E[i, 0]) * gx2 + float(E[i, 1]) * gy2 - ug2
        fB[i] = torch.where(fmw, fB[i] + extra, fB[i])
        fC[i] = torch.where(fmw, fC[i] + extra, fC[i])
    return fB, fC


def _vec_of(proj):
    """make.vector: F = sum_i (w_i/cs2) proj_i e_i."""
    fx = sum(float(W[i] / CS2 * E[i, 0]) * proj[i]
             for i in range(9) if E[i, 0])
    fy = sum(float(W[i] / CS2 * E[i, 1]) * proj[i]
             for i in range(9) if E[i, 1])
    return fx, fy


def _fill(ctx: NodeCtx, f):
    """d, j, u (with the half-central-force shift) and the projections."""
    d = _sum(f)
    jx = lbm.edot(E[:, 0], f)
    jy = lbm.edot(E[:, 1], f)
    fB, fC = _projections(ctx, (jx / d, jy / d), d)
    fcx, fcy = _vec_of(fC)
    u = ((jx + 0.5 * fcx) / d, (jy + 0.5 * fcy) / d)
    return d, (jx, jy), u, fB, fC


def _force_term(feq, d, proj, uF):
    """force(): feq_i (proj_i - u.F) / (d cs2) (reference CollisionBGK)."""
    return [feq[i] * (proj[i] - uF) / (d * CS2) for i in range(9)]


def _collision_bgk(ctx: NodeCtx, f):
    d, (jx, jy), u, fB, fC = _fill(ctx, f)
    fcx, fcy = _vec_of(fC)
    fbx, fby = _vec_of(fB)
    coll = ctx.nt_in_group("COLLISION")
    ctx.add_global("Mass", d, where=coll)
    ctx.add_global("MomentumX", jx + 0.5 * fcx, where=coll)
    ctx.add_global("MomentumY", jy + 0.5 * fcy, where=coll)
    feq = lbm.equilibrium(E, W, d, u)
    omega = ctx.setting("omega")
    uFc = u[0] * fcx + u[1] * fcy
    uFb = u[0] * fbx + u[1] * fby
    fc_term = _force_term(feq, d, fC, uFc)
    fb_term = _force_term(feq, d, fB, uFb)
    out = []
    for i in range(9):
        fneq = f[i] - (feq[i] - 0.5 * fc_term[i])
        out.append((1.0 - omega) * fneq + feq[i] + 0.5 * fb_term[i])
    return torch.stack(out)


def _collision_mrt(ctx: NodeCtx, f):
    """The MRT variant (reference CollisionMRT): half the central force
    pre-added, the non-conserved moments relaxed by the reference's
    literal ``(S - 1)`` (the sign-flipped counterpart of its BGK's ``(1 -
    omega)``), half the biased force post-added."""
    d, _, u, fB, fC = _fill(ctx, f)
    fcx, fcy = _vec_of(fC)
    fbx, fby = _vec_of(fB)
    feq = lbm.equilibrium(E, W, d, u)
    uFc = u[0] * fcx + u[1] * fcy
    uFb = u[0] * fbx + u[1] * fby
    f2 = f + 0.5 * torch.stack(_force_term(feq, d, fC, uFc))
    omega = ctx.setting("omega")
    m = lbm.moments(M, f2)
    meq = lbm.moments(M, feq)
    out_m = []
    for i in range(9):
        if i < 3:
            out_m.append(m[i])
        else:
            s = MRT_S_FIXED.get(i, None)
            rate = (s - 1.0) if s is not None else (omega - 1.0)
            out_m.append((m[i] - meq[i]) * rate + meq[i])
    f3 = lbm.from_moments(M, torch.stack(out_m))
    return f3 + 0.5 * torch.stack(_force_term(feq, d, fB, uFb))


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    vel = ctx.setting("InletVelocity")

    def moving_wall(f):
        # lid at the bottom of the fluid: the upward-moving f2, f5 and f6
        # rebuilt (reference MovingWall)
        rho = f[0] + f[1] + f[3] + 2.0 * (f[7] + f[4] + f[8])
        ru = rho * ctx.setting("MovingWallVelocity")
        f6 = f[8] - 0.5 * ru - 0.5 * (f[3] - f[1])
        f5 = f[7] + 0.5 * ru + 0.5 * (f[3] - f[1])
        return torch.stack([f[0], f[1], f[4], f[3], f[4], f5, f6, f[7],
                            f[8]])

    def wvel_eq(f):
        # the equilibrium inlet with the Wet/Dry density overrides
        rho2 = _plane(ctx, ctx.setting("InletDensity"))
        rho2 = torch.where(ctx.nt_is("Wet"), ctx.setting("WetDensity"), rho2)
        rho2 = torch.where(ctx.nt_is("Dry"), ctx.setting("DryDensity"), rho2)
        return lbm.equilibrium(E, W, rho2, (_plane(ctx, vel),
                                            torch.zeros_like(rho2)))

    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "MovingWall": moving_wall,
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, ctx.setting("InletDensity"),
                                         "pressure", "W"),
        "WVelocity": wvel_eq,
        "EPressure": lambda f: _zou_he_x(f, ctx.setting("OutletDensity"),
                                         "pressure", "E"),
    })
    f = torch.where(ctx.nt_is("BGK")[None], _collision_bgk(ctx, f), f)
    f = torch.where(ctx.nt_is("MRT")[None], _collision_mrt(ctx, f), f)
    return ctx.store({"f": f})


def init_f2(ctx: NodeCtx) -> dict:
    """InitF2: f = feq(the InitRho density, (InletVelocity, 0)) (reference
    InitF2 and InitRho)."""
    rho = _plane(ctx, ctx.setting("InitDensity"))
    rho = torch.where(ctx.nt_is("Wall") | ctx.nt_is("MovingWall"),
                      ctx.setting("WallDensity"), rho)
    rho = torch.where(ctx.nt_is("EPressure"), ctx.setting("OutletDensity"),
                      rho)
    rho = torch.where(ctx.nt_is("WPressure"), ctx.setting("InletDensity"),
                      rho)
    ux = _plane(ctx, ctx.setting("InletVelocity"))
    return ctx.store({"f": lbm.equilibrium(E, W, rho,
                                           (ux, torch.zeros_like(ux)))})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    _, _, u, _, _ = _fill(ctx, ctx.group("f"))
    return torch.stack([u[0], u[1], torch.zeros_like(u[0])])


def build():
    return _def().finalize().bind(
        run=run, init=init_f2,
        stages={"CalcRho": calc_rho, "CalcNu": calc_nu, "InitF2": init_f2},
        quantities={
            "Rho": lambda c: c.load("rho"),
            "U": get_u,
            "Nu": lambda c: c.load("nu"),
            "P": lambda c: _mu0(c, c.load("rho")),
        })
