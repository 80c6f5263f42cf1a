"""d3q19_les — 3D BGK with the Smagorinsky subgrid closure.

The port's counterpart of the JAX package's ``models/d3q19_les.py``, op for
op on PyTorch tensors: the 19-velocity set, weights and bounce-back pairs
of ``models/d3q19.py``, BGK at a relaxation rate lowered node by node by
an eddy viscosity from the non-equilibrium momentum flux
(``lbm.smagorinsky_omega_unrolled``), and the velocity-shift body force.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d3q19 import E, OPP, W
from tclb_tpu_torch.ops import lbm


def _def():
    d = family.base_def("d3q19_les", E, "3D BGK + Smagorinsky LES",
                        faces="WE", symmetries="NS")
    d.add_setting("Smag", default=0.16, comment="Smagorinsky constant")
    return d


def collide(f: torch.Tensor, omega, smag, force) -> torch.Tensor:
    """BGK at the Smagorinsky rate with the velocity-shift body force
    ``force = (gx, gy, gz)``; the eager model and the plain versions of the
    kernels share it."""
    rho = torch.sum(f, dim=0)
    u = tuple(lbm.edot(E[:, a], f) / rho for a in range(3))
    feq = lbm.equilibrium(E, W, rho, u)
    om_eff = lbm.smagorinsky_omega_unrolled(E, f, feq, rho, omega, smag)
    fc = f + om_eff[None] * (feq - f)
    u2 = tuple(u[a] + force[a] for a in range(3))
    return fc + (lbm.equilibrium(E, W, rho, u2) - feq)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    fc = collide(f, ctx.setting("omega"), ctx.setting("Smag"),
                 family.gravity_of(ctx))
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    return family.standard_init(ctx, E, W)


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities=family.make_getters(E, force_of=family.gravity_of))
