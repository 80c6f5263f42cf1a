"""d2q9 — 2D MRT lattice-Boltzmann with body force, Zou/He in/outlets,
symmetry walls and inlet/outlet flux + pressure-loss objectives.

The port's counterpart of the JAX package's ``models/d2q9.py``, op for op on
PyTorch tensors: per-node ``switch`` dispatch is mask selects, the moment
transforms are unrolled multiply-adds with scalar coefficients.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.ops import lbm

# D2Q9 velocity set (standard ordering: rest, axis, diagonal).
E = np.array([(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
              (1, 1), (-1, 1), (-1, -1), (1, -1)], dtype=np.int32)
W = lbm.weights(E)
OPP = lbm.opposite(E)                      # bounce-back pairing
M = lbm.mrt_basis_d2q9(E)                  # (9, 9) orthogonal moment basis


def _def() -> ModelDef:
    d = ModelDef("d2q9", ndim=2,
                 description="2D MRT with Zou/He boundaries and objectives")
    d.add_densities("f", E)
    # coupling buffer for in-process forcing (reference
    # src/d2q9/Dynamics.R:18-20)
    d.add_density("BC[0]", group="BC")
    d.add_density("BC[1]", group="BC")
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_setting("omega", comment="one over relaxation time",
                  derived={"S78": lambda om: 1.0 - om})
    d.add_setting("nu", default=1 / 6, comment="viscosity",
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity", default=0.0, zonal=True,
                  comment="inlet/outlet/init velocity")
    d.add_setting("Density", default=1.0, zonal=True,
                  comment="inlet/outlet/init density")
    d.add_setting("GravitationY")
    d.add_setting("GravitationX")
    d.add_setting("S3", default=-1 / 3, comment="MRT energy relaxation")
    d.add_setting("S4", default=0.0)
    d.add_setting("S56", default=0.0)
    d.add_setting("S78", default=0.0)
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    d.add_node_type("BottomSymmetry", "BOUNDARY")
    d.add_node_type("TopSymmetry", "BOUNDARY")
    return d


# ----------------------------------------------------------------------- #
# physics
# ----------------------------------------------------------------------- #


def _equilibrium(rho, ux, uy):
    return lbm.equilibrium(E, W, rho, (ux, uy))


def _zou_he_x(f, rho_or_u, kind: str, side: str) -> torch.Tensor:
    """Zou/He velocity/pressure boundaries on x-normal faces.

    ``side`` 'W' (flow enters +x) or 'E' (flow leaves +x); ``kind``
    'velocity' (given ux) or 'pressure' (given rho).  Unknown populations
    are rebuilt from the bounce-back of the non-equilibrium part plus a
    transverse correction."""
    tang = f[0] + f[2] + f[4]
    if side == "W":
        known = f[3] + f[7] + f[6]
        if kind == "velocity":
            ux = rho_or_u
            rho = (tang + 2.0 * known) / (1.0 - ux)
        else:
            rho = rho_or_u
            ux = 1.0 - (tang + 2.0 * known) / rho
        ru = rho * ux
        f1 = f[3] + (2.0 / 3.0) * ru
        f5 = f[7] + (1.0 / 6.0) * ru + 0.5 * (f[4] - f[2])
        f8 = f[6] + (1.0 / 6.0) * ru + 0.5 * (f[2] - f[4])
        return torch.stack([f[0], f1, f[2], f[3], f[4], f5, f[6], f[7], f8])
    known = f[1] + f[5] + f[8]
    if kind == "velocity":
        ux = rho_or_u
        rho = (tang + 2.0 * known) / (1.0 + ux)
    else:
        rho = rho_or_u
        ux = -1.0 + (tang + 2.0 * known) / rho
    ru = rho * ux
    f3 = f[1] - (2.0 / 3.0) * ru
    f7 = f[5] - (1.0 / 6.0) * ru + 0.5 * (f[2] - f[4])
    f6 = f[8] - (1.0 / 6.0) * ru + 0.5 * (f[4] - f[2])
    return torch.stack([f[0], f[1], f[2], f3, f[4], f[5], f6, f7, f[8]])


def _symmetry(f, top: bool) -> torch.Tensor:
    """Mirror across an x-parallel wall: populations with the wall-normal
    velocity component are replaced by their mirror images."""
    if top:   # wall above: downward-moving come from upward-moving mirrors
        return torch.stack([f[0], f[1], f[2], f[3], f[2], f[5], f[6], f[6],
                            f[5]])
    return torch.stack([f[0], f[1], f[4], f[3], f[4], f[8], f[7], f[7],
                        f[8]])


def _collision_mrt(ctx: NodeCtx, f: torch.Tensor) -> torch.Tensor:
    rho = torch.sum(f, dim=0)
    jx = lbm.edot(E[:, 0], f)
    jy = lbm.edot(E[:, 1], f)
    ux, uy = jx / rho, jy / rho

    # objectives on Inlet/Outlet-tagged collision nodes
    # (reference src/d2q9/Dynamics.c.Rt:250-270)
    usq = ux * ux + uy * uy
    mrt = ctx.nt_is("MRT")
    ploss = ux / rho * ((rho - 1.0) / 3.0 + usq / rho * 0.5)
    zero = torch.zeros_like(ploss)
    ctx.add_global("OutletFlux", ux / rho, where=ctx.nt_is("Outlet") & mrt)
    ctx.add_global("InletFlux", ux / rho, where=ctx.nt_is("Inlet") & mrt)
    ctx.add_global("PressureLoss",
                   torch.where(ctx.nt_is("Inlet"), ploss, zero)
                   - torch.where(ctx.nt_is("Outlet"), ploss, zero),
                   where=(ctx.nt_is("Inlet") | ctx.nt_is("Outlet")) & mrt)

    # relax the non-equilibrium moments with the pre-force velocity (the
    # conserved moments relax at rate 0 and drop out exactly) ...
    rates = [None, None, None,
             ctx.setting("S3"), ctx.setting("S4"),
             ctx.setting("S56"), ctx.setting("S56"),
             ctx.setting("S78"), ctx.setting("S78")]
    feq = _equilibrium(rho, ux, uy)
    mn = lbm.moments(M, f - feq)
    m_neq = torch.stack([torch.zeros_like(mn[i]) if r is None else mn[i] * r
                         for i, r in enumerate(rates)])
    # ... then shift the velocity by the body force and add the post-force
    # equilibrium back: Minv @ (m_neq + M @ feq2) == Minv @ m_neq + feq2
    ux2 = ux + ctx.setting("GravitationX") + ctx.density("BC[0]")
    uy2 = uy + ctx.setting("GravitationY") + ctx.density("BC[1]")
    return lbm.from_moments(M, m_neq) + _equilibrium(rho, ux2, uy2)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    vel = ctx.setting("Velocity")
    den = ctx.setting("Density")
    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, den, "pressure", "W"),
        "WVelocity": lambda f: _zou_he_x(f, vel, "velocity", "W"),
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
        "TopSymmetry": lambda f: _symmetry(f, top=True),
        "BottomSymmetry": lambda f: _symmetry(f, top=False),
    })
    f = torch.where(ctx.nt_is("MRT")[None], _collision_mrt(ctx, f), f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    den = ctx.setting("Density")
    vel = ctx.setting("Velocity")
    shape = ctx.flags.shape
    dt, dev = ctx._fields.dtype, ctx._fields.device
    rho = torch.broadcast_to(torch.as_tensor(den, dtype=dt, device=dev),
                             shape)
    ux = torch.broadcast_to(torch.as_tensor(vel, dtype=dt, device=dev),
                            shape)
    f = _equilibrium(rho, ux, torch.zeros(shape, dtype=dt, device=dev))
    return ctx.store({"f": f,
                      "BC": torch.zeros((2,) + tuple(shape), dtype=dt,
                                        device=dev)})


def get_rho(ctx: NodeCtx) -> torch.Tensor:
    return torch.sum(ctx.group("f"), dim=0)


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    # measured velocity includes half the body force
    # (reference src/d2q9/Dynamics.c.Rt:43-49)
    ux = ux + ctx.density("BC[0]") * 0.5 + ctx.setting("GravitationX") * 0.5
    uy = uy + ctx.density("BC[1]") * 0.5 + ctx.setting("GravitationY") * 0.5
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def build():
    model = _def().finalize()
    return model.bind(run=run, init=init,
                      quantities={"Rho": get_rho, "U": get_u})
