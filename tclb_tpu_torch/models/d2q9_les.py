"""d2q9_les — 2D BGK with the Smagorinsky subgrid closure.

The port's counterpart of the JAX package's ``models/d2q9_les.py``, op for
op on PyTorch tensors: the relaxation rate is lowered node by node by an
eddy viscosity from the non-equilibrium momentum flux (Hou et al.'s
closed form, ``lbm.smagorinsky_omega_unrolled``).
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d2q9 import E
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)


def _def():
    d = family.base_def("d2q9_les", E, "2D BGK + Smagorinsky LES")
    d.add_setting("Smag", default=0.16, comment="Smagorinsky constant")
    d.add_node_type("TopSymmetry", "BOUNDARY")
    d.add_node_type("BottomSymmetry", "BOUNDARY")
    return d


def collide(f: torch.Tensor, omega, smag, force) -> torch.Tensor:
    """BGK at the Smagorinsky rate with the velocity-shift body force
    ``force = (gx, gy)``; the eager model and the plain versions of the
    kernels share it."""
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    feq = lbm.equilibrium(E, W, rho, (ux, uy))
    om_eff = lbm.smagorinsky_omega_unrolled(E, f, feq, rho, omega, smag)
    fc = f + om_eff[None] * (feq - f)
    gx, gy = force
    return fc + (lbm.equilibrium(E, W, rho, (ux + gx, uy + gy)) - feq)


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
