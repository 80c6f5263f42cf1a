"""d2q9_kuper — Kupershtokh pseudopotential multiphase (phase change).

The port's counterpart of the JAX package's ``models/d2q9_kuper.py`` on
PyTorch tensors (the collision takes the post-force equilibrium directly,
where the JAX package passes it through the moment basis and back: the
same function, with less f32 mass drift).  A two-stage iteration: ``Run`` assembles the
Kupershtokh exact-difference force from the neighbours' pseudopotential
``phi`` (a Field read through ``ctx.load`` on the un-streamed storage) and
collides with a settings-driven MRT; ``CalcPhi`` then computes
``phi = FAcc sqrt(rho/3 - Magic p_vdW(rho, T))`` from the streamed density
that the next ``Run`` will see.

Sums over populations are written out in plane order (``_rho``) and powers
as products, so the CUDA version of this physics
(``csrc/models/d2q9_kuper.cuh``) can repeat the arithmetic op for op.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, M, OPP, _equilibrium
from tclb_tpu_torch.models.family import mirror_perm
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
# shell force weights (reference src/d2q9_kuper/Dynamics.c.Rt:115)
GS = np.array([0.0, 1.0, 1.0, 1.0, 1.0, 0.25, 0.25, 0.25, 0.25])
# van der Waals EOS constants (reference src/d2q9_kuper/Dynamics.c.Rt:291-293)
A2 = 3.852462271644162
B2 = 0.1304438860971524 * 4.0
C2 = 2.785855170470555
MIRROR_Y = mirror_perm(E, 1)       # the N/S symmetry mirror


def _def() -> ModelDef:
    d = ModelDef("d2q9_kuper", ndim=2,
                 description="Kupershtokh pseudopotential multiphase")
    d.add_densities("f", E)
    d.add_field("phi", dx=(-1, 1), dy=(-1, 1))
    d.add_stage("BaseIteration", "Run")
    d.add_stage("CalcPhi", "CalcPhi")
    d.add_stage("BaseInit", "Init", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "CalcPhi"))
    d.add_action("Init", ("BaseInit", "CalcPhi"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("P", unit="Pa")
    d.add_quantity("F", unit="N", vector=True)
    d.add_setting("omega", default=1.0)
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5),
                           "S7": lambda nu: 1.0 - 1.0 / (3 * nu + 0.5),
                           "S8": lambda nu: 1.0 - 1.0 / (3 * nu + 0.5)})
    d.add_setting("InletVelocity")
    d.add_setting("Temperature", default=0.9,
                  comment="temperature of the liquid/gas")
    d.add_setting("FAcc", default=1.0, comment="multiplier of potential")
    d.add_setting("Magic", default=0.01)
    d.add_setting("MagicA", default=-0.152, comment="A in force calc")
    d.add_setting("MagicF", default=-2.0 / 3.0, comment="force multiplier")
    d.add_setting("GravitationX")
    d.add_setting("GravitationY")
    d.add_setting("MovingWallVelocity")
    d.add_setting("Density", default=1.0, zonal=True)
    d.add_setting("Wetting", default=1.0)
    for i, dflt in enumerate([0, 0, 0, -1 / 3, 0, 0, 0, 0, 0]):
        d.add_setting(f"S{i}", default=dflt, comment="MRT keep factor")
    d.add_global("WallForceX")
    d.add_global("WallForceY")
    d.add_node_type("NSymmetry", "BOUNDARY")
    d.add_node_type("SSymmetry", "BOUNDARY")
    d.add_node_type("MovingWall", "BOUNDARY")
    return d


def _rho(f: torch.Tensor) -> torch.Tensor:
    """``f[0] + f[1] + ... + f[8]`` in plane order."""
    return lbm.edot(np.ones(len(f)), f)


def _eos_pressure(rho, t):
    """Magic-scaled van der Waals pressure
    (reference src/d2q9_kuper/Dynamics.c.Rt:317-318)."""
    br = B2 * rho / 4.0
    om = 1.0 - br
    return ((rho * (-(br * br * br) + br * br + br + 1.0) * t * C2)
            / (om * om * om) - A2 * rho * rho)


def calc_phi(ctx: NodeCtx) -> dict:
    """CalcPhi stage: pseudopotential from the streamed density; boundary
    nodes other than the symmetry mirrors use the zonal Density."""
    rho = _rho(ctx.group("f"))
    bound = ctx.nt_in_group("BOUNDARY") \
        & ~(ctx.nt_is("NSymmetry") | ctx.nt_is("SSymmetry"))
    rho = torch.where(bound, ctx.setting("Density"), rho)
    p = ctx.setting("Magic") * _eos_pressure(rho, ctx.setting("Temperature"))
    phi = ctx.setting("FAcc") * torch.sqrt(torch.clamp(rho / 3.0 - p,
                                                       min=0.0))
    return {"phi": phi}


def _force(ctx: NodeCtx, f: torch.Tensor):
    """Kupershtokh exact-difference force from the neighbours' phi
    (reference src/d2q9_kuper/Dynamics.c.Rt:57-127), plus the wall
    momentum term and the wall-force globals."""
    a = ctx.setting("MagicA")
    b = 1.0 - 2.0 * a
    phi0 = ctx.load("phi")
    fx = torch.zeros_like(phi0)
    fy = torch.zeros_like(phi0)
    # phi is sampled at -e_i and weighted with +e_i (reference
    # src/d2q9_kuper/Dynamics.c.Rt:19): this sets the force's sign
    for i in range(1, 9):
        phii = ctx.load("phi", -int(E[i, 0]), -int(E[i, 1]))
        r = a * phii * phii + b * phii * phi0
        gr = float(GS[i]) * r
        if E[i, 0]:
            fx = fx + float(E[i, 0]) * gr
        if E[i, 1]:
            fy = fy + float(E[i, 1]) * gr
    scale = ctx.setting("MagicF")
    fx, fy = scale * fx, scale * fy
    ex = lbm.edot(E[:, 0], f)
    ey = lbm.edot(E[:, 1], f)
    wall = ctx.nt_is("Wall")
    fx = torch.where(wall, fx + 2.0 * ex, fx)
    fy = torch.where(wall, fy + 2.0 * ey, fy)
    ctx.add_global("WallForceX", ex, where=wall)
    ctx.add_global("WallForceY", ey, where=wall)
    return fx, fy


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    mwv = ctx.setting("MovingWallVelocity")

    def moving_wall(f):
        # bounce-back with tangential wall momentum (Ladd correction)
        fb = lbm.perm(f, OPP)
        return torch.stack([fb[i] + 6.0 * float(W[i]) * float(E[i, 0]) * mwv
                            if E[i, 0] else fb[i] for i in range(9)])

    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "MovingWall": moving_wall,
        "NSymmetry": lambda f: lbm.perm(f, MIRROR_Y),
        "SSymmetry": lambda f: lbm.perm(f, MIRROR_Y),
    })

    rho = _rho(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    mn = lbm.moments(M, f - _equilibrium(rho, ux, uy))
    m_neq = torch.stack([mn[i] * ctx.setting(f"S{i}") for i in range(9)])
    fx, fy = _force(ctx, f)
    ux2 = ux + fx / rho + ctx.setting("GravitationX")
    uy2 = uy + fy / rho + ctx.setting("GravitationY")
    # Minv (m_neq + M feq2) == Minv m_neq + feq2: taking feq2 directly
    # spares a basis round trip whose f32 rounding biases the mass
    fc = lbm.from_moments(M, m_neq) + _equilibrium(rho, ux2, uy2)
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device

    def plane(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dt, device=dev),
                                  shape)

    f = _equilibrium(plane(ctx.setting("Density")),
                     plane(ctx.setting("InletVelocity")),
                     torch.zeros(shape, dtype=dt, device=dev))
    return ctx.store({"f": f})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = _rho(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_p(ctx: NodeCtx) -> torch.Tensor:
    return ctx.setting("Magic") * _eos_pressure(_rho(ctx.group("f")),
                                                ctx.setting("Temperature"))


def get_f(ctx: NodeCtx) -> torch.Tensor:
    fx, fy = _force(ctx, ctx.group("f"))
    return torch.stack([fx, fy, torch.zeros_like(fx)])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        stages={"CalcPhi": calc_phi},
        quantities={"Rho": lambda c: _rho(c.group("f")),
                    "U": get_u, "P": get_p, "F": get_f})
