"""d3q19_adj — 3D topology optimisation with a porous design field.

The port's counterpart of the JAX package's ``models/d3q19_adj.py`` (the
reference's ``d3q19_adj``): the d3q19 MRT with a design density ``w``
(``parameter=True``, not streamed) and Brinkman penalisation on ``nw = w
/ (1 - PorocityGamma (1 - w))`` inside the collision; the globals Drag and
Lift (the x and y velocity where the design is solid) and Material and
MaterialPenalty over the DesignSpace nodes, beside the family's
PressureLoss, OutletFlux and InletFlux.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d3q19_adj.cuh`` repeats, so the generic 3D
kernels agree with this eager step to a few ulps.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d3q19 import E, M, OPP, STRESS, W, macroscopic
from tclb_tpu_torch.ops import lbm


def _def():
    d = family.base_def("d3q19_adj", E, "3D porous topology optimization",
                        faces="WE", symmetries="NS")
    d.add_density("w", group="w", parameter=True)
    d.add_setting("S_high", default=1.0)
    d.add_setting("Porocity", default=0.0, zonal=True)
    d.add_setting("PorocityGamma", default=0.0)
    d.add_quantity("W")
    d.add_quantity("WB", adjoint=True)
    d.add_global("Drag")
    d.add_global("Lift")
    d.add_global("Material")
    d.add_global("MaterialPenalty")
    return d


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    w = ctx.density("w")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    rho, u = macroscopic(f)
    feq = lbm.equilibrium(E, W, rho, u)
    fneq = [f[k] - feq[k] for k in range(19)]
    relax = lbm.two_rate_relax(M, *STRESS, fneq, 1.0 - ctx.setting("omega"),
                               1.0 - ctx.setting("S_high"))
    g = family.gravity_of(ctx)
    nw = w / (1.0 - ctx.setting("PorocityGamma") * (1.0 - w))
    u2 = tuple(u[a] + g[a] for a in range(3))
    coll = ctx.nt_in_group("COLLISION")
    ctx.add_global("Drag", (1.0 - nw) * u2[0], where=coll)
    ctx.add_global("Lift", (1.0 - nw) * u2[1], where=coll)
    u2 = tuple(c * nw for c in u2)
    fc = relax + lbm.equilibrium(E, W, rho, u2)
    f = torch.where(coll[None], fc, f)
    in_design = ctx.nt_in_group("DESIGNSPACE")
    ctx.add_global("MaterialPenalty", w * (1.0 - w), where=in_design)
    ctx.add_global("Material", 1.0 - w, where=in_design)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    w = 1.0 - torch.broadcast_to(
        torch.as_tensor(ctx.setting("Porocity"), dtype=dt, device=dev),
        shape)
    w = torch.where(ctx.nt_is("Solid"), torch.zeros_like(w), w)
    return family.standard_init(ctx, E, W, extra={"w": w[None]})


def build():
    q = family.make_getters(E, force_of=family.gravity_of)

    def wq(c):
        return c.density("w")

    q.update({"W": wq, "WB": wq})
    return _def().finalize().bind(run=run, init=init, quantities=q)
