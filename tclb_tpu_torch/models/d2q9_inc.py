"""d2q9_inc — 2D incompressible formulation (He & Luo).

The port's counterpart of the JAX package's ``models/d2q9_inc.py``, op for
op on PyTorch tensors: the equilibrium is linear in the density with a
fixed reference density,
``f_eq = w (rho + rho0 (3 e.u + 4.5 (e.u)^2 - 1.5 u^2))`` with
``u = j / rho0``.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d2q9 import E
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
RHO0 = 1.0


def inc_equilibrium(rho, ux, uy) -> torch.Tensor:
    usq = ux * ux + uy * uy
    out = []
    for i in range(9):
        eu = float(E[i, 0]) * ux + float(E[i, 1]) * uy
        out.append(float(W[i])
                   * (rho + RHO0 * (3.0 * eu + 4.5 * eu * eu - 1.5 * usq)))
    return torch.stack(out)


def _def():
    d = family.base_def("d2q9_inc", E, "2D incompressible formulation")
    d.add_node_type("TopSymmetry", "BOUNDARY")
    d.add_node_type("BottomSymmetry", "BOUNDARY")
    return d


def collide(f: torch.Tensor, omega, force) -> torch.Tensor:
    """He-Luo BGK with the velocity-shift body force ``force = (gx,
    gy)``; the eager model and the plain versions of the kernels share
    it."""
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / RHO0
    uy = lbm.edot(E[:, 1], f) / RHO0
    feq = inc_equilibrium(rho, ux, uy)
    fc = f + omega * (feq - f)
    gx, gy = force
    return fc + (inc_equilibrium(rho, ux + gx, uy + gy) - feq)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    fc = collide(f, ctx.setting("omega"), family.gravity_of(ctx))
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device

    def plane(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dt, device=dev),
                                  shape)

    zero = torch.zeros(shape, dtype=dt, device=dev)
    return ctx.store({"f": inc_equilibrium(plane(ctx.setting("Density")),
                                           plane(ctx.setting("Velocity")),
                                           zero)})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    ux = lbm.edot(E[:, 0], f) / RHO0
    uy = lbm.edot(E[:, 1], f) / RHO0
    gx, gy = family.gravity_of(ctx)
    return torch.stack([ux + 0.5 * gx, uy + 0.5 * gy, torch.zeros_like(ux)])


def build():
    q = family.make_getters(E)
    q["U"] = get_u
    return _def().finalize().bind(run=run, init=init, quantities=q)
