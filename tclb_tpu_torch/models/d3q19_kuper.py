"""d3q19_kuper — 3D Kupershtokh pseudopotential multiphase.

The port's counterpart of the JAX package's ``models/d3q19_kuper.py`` on
PyTorch tensors: the 3D form of ``d2q9_kuper``.  A two-stage iteration:
``Run`` takes the family's boundary cases (its velocity faces impose 0:
the model has no Velocity setting), assembles the exact-difference force
over the 18 moving directions from the neighbours' pseudopotential
``phi`` (a Field read through ``ctx.load`` on the un-streamed storage,
sampled at -e_i, weighted with +e_i and the shell weight ``18 w_i``) and
collides with BGK plus the force as an equilibrium difference;
``CalcPhi`` computes ``phi = FAcc sqrt(rho/3 - Magic p_vdW(rho, T))``
from the streamed density (the zonal Density on boundary nodes), which
the next ``Run`` reads.

Sums over populations run in plane order, so the device header
``csrc/models/d3q19_kuper.cuh`` can repeat the arithmetic op for op.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d2q9_kuper import _eos_pressure
from tclb_tpu_torch.models.d3q19 import E, OPP, W, macroscopic, plane_sum
from tclb_tpu_torch.ops import lbm

# gradient shell weights: 18 w_i gives (1, 1/2) on (axis, edge)
GS = 18.0 * W


def _def() -> ModelDef:
    d = ModelDef("d3q19_kuper", ndim=3,
                 description="3D Kupershtokh pseudopotential multiphase")
    d.add_densities("f", E)
    d.add_field("phi", dx=(-1, 1), dy=(-1, 1), dz=(-1, 1))
    d.add_stage("BaseIteration", "Run")
    d.add_stage("CalcPhi", "CalcPhi")
    d.add_stage("BaseInit", "Init", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "CalcPhi"))
    d.add_action("Init", ("BaseInit", "CalcPhi"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("P", unit="Pa")
    d.add_setting("omega", default=1.0)
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Temperature", default=0.56)
    d.add_setting("FAcc", default=1.0)
    d.add_setting("Magic", default=0.01)
    d.add_setting("MagicA", default=-0.152)
    d.add_setting("MagicF", default=-2.0 / 3.0)
    for ax in ("X", "Y", "Z"):
        d.add_setting(f"Gravitation{ax}")
    d.add_setting("Density", default=3.26, zonal=True)
    d.add_setting("Wetting", default=1.0)
    return d


def calc_phi(ctx: NodeCtx) -> dict:
    """CalcPhi stage: the pseudopotential from the streamed density;
    boundary nodes use the zonal Density."""
    rho = plane_sum(ctx.group("f"))
    rho = torch.where(ctx.nt_in_group("BOUNDARY"), ctx.setting("Density"),
                      rho)
    p = ctx.setting("Magic") * _eos_pressure(rho, ctx.setting("Temperature"))
    phi = ctx.setting("FAcc") * torch.sqrt(torch.clamp(rho / 3.0 - p,
                                                       min=0.0))
    return {"phi": phi}


def _force(ctx: NodeCtx):
    """The exact-difference force over the 18 moving directions."""
    a = ctx.setting("MagicA")
    b = 1.0 - 2.0 * a
    phi0 = ctx.load("phi")
    frc = [torch.zeros_like(phi0) for _ in range(3)]
    for i in range(1, 19):
        # phi sampled at -e_i, as the reference does (see d2q9_kuper._force)
        phii = ctx.load("phi", -int(E[i, 0]), -int(E[i, 1]), -int(E[i, 2]))
        gr = float(GS[i]) * (a * phii * phii + b * phii * phi0)
        for ax in range(3):
            if E[i, ax]:
                frc[ax] = frc[ax] + float(E[i, ax]) * gr
    return frc


def run(ctx: NodeCtx) -> dict:
    f = family.apply_boundaries(ctx, ctx.group("f"), E, W, OPP)
    frc = _force(ctx)
    s = ctx.setting("MagicF")
    rho, u = macroscopic(f)
    grav = family.gravity_of(ctx)
    u2 = tuple(u[ax] + (s * frc[ax] / rho + grav[ax]) for ax in range(3))
    feq = lbm.equilibrium(E, W, rho, u)
    fc = f + ctx.setting("omega") * (feq - f) \
        + (lbm.equilibrium(E, W, rho, u2) - feq)
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    rho = torch.broadcast_to(torch.as_tensor(ctx.setting("Density"),
                                             dtype=dt, device=dev), shape)
    zero = torch.zeros(shape, dtype=dt, device=dev)
    return ctx.store({"f": lbm.equilibrium(E, W, rho, (zero, zero, zero))})


def get_p(ctx: NodeCtx) -> torch.Tensor:
    rho = torch.sum(ctx.group("f"), dim=0)
    return ctx.setting("Magic") * _eos_pressure(rho,
                                                ctx.setting("Temperature"))


def build():
    q = family.make_getters(E, force_of=family.gravity_of)
    q["P"] = get_p
    return _def().finalize().bind(run=run, init=init,
                                  stages={"CalcPhi": calc_phi},
                                  quantities=q)
