"""d2q9_pf_curvature — phase-field advection and CSF surface tension from
a stencil curvature.

The port's counterpart of the JAX package's
``models/d2q9_pf_curvature.py`` (the reference's ``d2q9_pf_curvature``,
M. Dzikowski 2016).  On top of d2q9_pf: a ``phi`` Field written by a
``CalcPhi`` stage (walls store a -999 sentinel), a wall-repaired 9-point
stencil (a sentinel link takes the opposite link's value, else the
running mean of the valid links), the gradient, laplacian and curvature
from that stencil, the surface-tension force ``SurfaceTensionRate curv n
exp(-Decay pf^2)`` plus phase-interpolated gravity, and a
phase-interpolated relaxation rate.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_pf_curvature.cuh`` repeats.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.models.d2q9_pf import OPP, OPP18, W, _heq, init
from tclb_tpu_torch.models.family import mirror_perm
from tclb_tpu_torch.ops import lbm

MIRY = mirror_perm(E, 1)
MIRY18 = np.concatenate([MIRY, MIRY + 9])
SENTINEL = -999.0


def _def() -> ModelDef:
    d = ModelDef("d2q9_pf_curvature", ndim=2,
                 description="phase field with CSF curvature surface tension")
    d.add_densities("f", E)
    d.add_densities("h", E)
    d.add_field("phi", dx=(-1, 1), dy=(-1, 1))
    d.add_stage("BaseIteration", "Run")
    d.add_stage("CalcPhi", "CalcPhi")
    d.add_stage("BaseInit", "Init", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "CalcPhi"))
    d.add_action("Init", ("BaseInit", "CalcPhi"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("Normal", unit="1/m", vector=True)
    d.add_quantity("PhaseField", unit="1")
    d.add_quantity("Curvature", unit="1")
    d.add_quantity("InterfaceForce", unit="1", vector=True)
    d.add_setting("omega", comment="one over relaxation time (dense phase)")
    d.add_setting("omega_l", comment="one over relaxation time, light phase")
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity", default=0.0, zonal=True)
    d.add_setting("Pressure", default=0.0, zonal=True)
    d.add_setting("W", default=1.0, comment="anti-diffusivity coeff")
    d.add_setting("M", default=1.0, comment="mobility")
    d.add_setting("PhaseField", default=1.0, zonal=True)
    d.add_setting("GravitationX")
    d.add_setting("GravitationY")
    d.add_setting("GravitationX_l")
    d.add_setting("GravitationY_l")
    d.add_setting("SurfaceTensionDecay", default=100.0)
    d.add_setting("SurfaceTensionRate", default=0.1)
    d.add_setting("WettingAngle", default=0.0, zonal=True)
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    d.add_node_type("NSymmetry", "BOUNDARY")
    d.add_node_type("SSymmetry", "BOUNDARY")
    return d


def calc_phi(ctx: NodeCtx) -> dict:
    """phi = sum(h); walls write the -999 sentinel the stencil repair
    reads.  On a symmetry face the populations moving into the face are
    taken as the mirrors of those leaving it: phi = sum_{ey=0} h + 2
    sum_{ey<0} h on SSymmetry (ey > 0 on NSymmetry)."""
    h = ctx.group("h")
    phi = _sum(h)
    tang = h[0] + h[1] + h[3]
    south = tang + 2.0 * (h[4] + h[7] + h[8])
    north = tang + 2.0 * (h[2] + h[5] + h[6])
    phi = torch.where(ctx.nt_is("SSymmetry"), south, phi)
    phi = torch.where(ctx.nt_is("NSymmetry"), north, phi)
    phi = torch.where(ctx.nt_is("Wall"), torch.full_like(phi, SENTINEL), phi)
    return {"phi": phi}


def repaired_stencil(phis):
    """The wall-repaired stencil of the nine ``phis`` (phi at x + e_j): a
    link holding the sentinel (not above SENTINEL + 1) takes the opposite
    link's value if that is valid, else the running mean of the valid
    links, accumulated in link order."""
    valid = [p > SENTINEL + 1.0 for p in phis]
    temp = torch.zeros_like(phis[0])
    for j in range(9):
        temp = (j * temp + torch.where(valid[j], phis[j], temp)) / (j + 1.0)
    out = []
    for j in range(9):
        o = int(OPP[j])
        fallback = torch.where(valid[o], phis[o], temp)
        out.append(torch.where(valid[j], phis[j], fallback))
    return out


def _repaired_stencil(ctx: NodeCtx):
    return repaired_stencil([ctx.load("phi", int(E[j, 0]), int(E[j, 1]))
                             for j in range(9)])


def _normal(rphis):
    """The unit gradient sum_j rphis_j e_j / |.| (zero where it
    vanishes)."""
    gx = lbm.edot(E[:, 0], rphis)
    gy = lbm.edot(E[:, 1], rphis)
    ln = torch.sqrt(gx * gx + gy * gy)
    safe = torch.where(ln > 0, ln, torch.ones_like(ln))
    zero = torch.zeros_like(ln)
    return (torch.where(ln > 0, gx / safe, zero),
            torch.where(ln > 0, gy / safe, zero))


def _curvature(ctx: NodeCtx, rphis):
    """curv = (lap(phi) - 2 phi (16 phi^2 - 4) W^2) / ((4 phi^2 - 1) W),
    laplacian = 3 (mean_j phi_j - phi_0); 0 where the denominator is
    below 1e-6 (the bulk, where f32 rounds 4 phi^2 - 1 to 0 and f64 to a
    few ulps)."""
    w = ctx.setting("W")
    laplace = 3.0 * (_sum(torch.stack(rphis)) / 9.0 - rphis[0])
    phi0 = ctx.load("phi")
    ln = (4.0 * phi0 * phi0 - 1.0) * w
    dead = torch.abs(ln) < 1e-6
    safe = torch.where(dead, torch.ones_like(ln), ln)
    curv = (laplace - 2.0 * phi0 * (16.0 * phi0 * phi0 - 4.0) * w * w) / safe
    return torch.where(dead, torch.zeros_like(curv), curv)


def _force(ctx: NodeCtx, pf):
    """The surface tension and the phase-interpolated gravity; ``pf`` is
    sum(h)."""
    rphis = _repaired_stencil(ctx)
    nx, ny = _normal(rphis)
    curv = _curvature(ctx, rphis)
    decay = torch.exp(-ctx.setting("SurfaceTensionDecay") * pf * pf)
    rate = ctx.setting("SurfaceTensionRate")
    fx = rate * curv * nx * decay
    fy = rate * curv * ny * decay
    gx = ctx.setting("GravitationX")
    gy = ctx.setting("GravitationY")
    gxl = ctx.setting("GravitationX_l")
    gyl = ctx.setting("GravitationY_l")
    fx = fx + gxl - (pf - 0.5) * (gx - gxl)
    fy = fy + gyl - (pf - 0.5) * (gy - gyl)
    return fx, fy, (nx, ny)


def _boundaries(ctx: NodeCtx, fh: torch.Tensor) -> torch.Tensor:
    vel = ctx.setting("Velocity")
    den = 1.0 + 3.0 * ctx.setting("Pressure")
    pf_set = ctx.setting("PhaseField")

    def zou(kind, side, set_h):
        def apply(fh):
            f = _zou_he_x(fh[:9], vel if kind == "velocity" else den,
                          kind, side)
            h = fh[9:]
            if set_h:
                # pressure faces also pin the phase field to its zonal
                # setting at the Zou/He velocity
                rho = _sum(f)
                ux = lbm.edot(E[:, 0], f) / rho
                uy = lbm.edot(E[:, 1], f) / rho
                h = lbm.equilibrium(E, W, _plane(ctx, pf_set), (ux, uy))
            return torch.cat([f, h])
        return apply

    return ctx.boundary_case(fh, {
        ("Wall", "Solid"): lambda s: lbm.perm(s, OPP18),
        "EVelocity": zou("velocity", "E", False),
        "WPressure": zou("pressure", "W", True),
        "WVelocity": zou("velocity", "W", False),
        "EPressure": zou("pressure", "E", True),
        ("NSymmetry", "SSymmetry"): lambda s: lbm.perm(s, MIRY18),
    })


def run(ctx: NodeCtx) -> dict:
    fh = torch.cat([ctx.group("f"), ctx.group("h")])
    fh = _boundaries(ctx, fh)
    f, h = fh[:9], fh[9:]

    pf = _sum(h)
    fx, fy, n = _force(ctx, pf)

    # the phase-interpolated relaxation rate
    omega_eff = ctx.setting("omega_l") \
        - (pf - 0.5) * (ctx.setting("omega") - ctx.setting("omega_l"))
    rho = _sum(f)
    jx = lbm.edot(E[:, 0], f)
    jy = lbm.edot(E[:, 1], f)
    feq = lbm.equilibrium(E, W, rho, (jx / rho, jy / rho))
    # the force enters the momentum directly (J += F)
    feq2 = lbm.equilibrium(E, W, rho, ((jx + fx) / rho, (jy + fy) / rho))
    fc = feq2 + (1.0 - omega_eff) * (f - feq)

    # h relaxes toward Heq at the momentum-like velocity J + 1.5 F
    uh = (jx + 1.5 * fx, jy + 1.5 * fy)
    omega_ph = 1.0 / (3.0 * ctx.setting("M") + 0.5)
    bh = 3.0 * ctx.setting("M") * (1.0 - 4.0 * pf * pf) * ctx.setting("W")
    hc = (1.0 - omega_ph) * h + omega_ph * _heq(pf, n, uh, bh)

    coll = ctx.nt_in_group("COLLISION")[None]
    f = torch.where(coll, fc, f)
    h = torch.where(coll, hc, h)
    return ctx.store({"f": f, "h": h})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.where(ctx.nt_in_group("BOUNDARY"),
                      1.0 + 3.0 * ctx.setting("Pressure"), _sum(f))
    pf = _sum(ctx.group("h"))
    fx, fy, _ = _force(ctx, pf)
    ux = (lbm.edot(E[:, 0], f) + 0.5 * fx) / rho
    uy = (lbm.edot(E[:, 1], f) + 0.5 * fy) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_curvature(ctx: NodeCtx) -> torch.Tensor:
    return _curvature(ctx, _repaired_stencil(ctx))


def get_normal(ctx: NodeCtx) -> torch.Tensor:
    nx, ny = _normal(_repaired_stencil(ctx))
    return torch.stack([nx, ny, torch.zeros_like(nx)])


def get_iforce(ctx: NodeCtx) -> torch.Tensor:
    rphis = _repaired_stencil(ctx)
    nx, ny = _normal(rphis)
    curv = _curvature(ctx, rphis)
    pf = _sum(ctx.group("h"))
    decay = torch.exp(-ctx.setting("SurfaceTensionDecay") * pf * pf)
    return torch.stack([curv * nx * decay, curv * ny * decay,
                        torch.zeros_like(curv)])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        stages={"CalcPhi": calc_phi},
        quantities={
            "Rho": lambda c: _sum(c.group("f")),
            "U": get_u,
            "Normal": get_normal,
            "PhaseField": lambda c: _sum(c.group("h")),
            "Curvature": get_curvature,
            "InterfaceForce": get_iforce,
        })
