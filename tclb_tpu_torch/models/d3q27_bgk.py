"""d3q27_BGK and d3q27_BGK_galcor — 3D 27-velocity BGK, the second with the
third-order (Galilean-invariance) equilibrium correction.

The port's counterpart of the JAX package's ``models/d3q27_bgk.py``, op for
op on PyTorch tensors: the velocity set is the tensor-product order of
``cumulant.velocity_set(3)``; "galcor" adds the third-order Hermite term
``(e.u)^3/(6 cs^6) - (e.u) u^2/(2 cs^4)`` to the equilibrium; the body
force enters as the equilibrium difference at the shifted velocity.
Wall/Solid bounce-back, W/E velocity and pressure faces, N/S symmetry.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.ops import cumulant, lbm

E = cumulant.velocity_set(3)
W = lbm.weights(E)
OPP = lbm.opposite(E)
CS2 = lbm.CS2


def equilibrium(rho, u, galcor: bool) -> torch.Tensor:
    """The second-order equilibrium, plus the third-order terms where
    ``galcor``: a (27, *shape) stack."""
    usq = sum(c * c for c in u)
    out = []
    for i in range(27):
        eu = sum(float(E[i, a]) * u[a] for a in range(3) if E[i, a])
        if isinstance(eu, int):
            common = 1.0 - usq / (2 * CS2)
        else:
            common = (1.0 + eu / CS2 + eu * eu / (2 * CS2 * CS2)
                      - usq / (2 * CS2))
            if galcor:
                common = common + (eu * eu * eu / (6 * CS2 ** 3)
                                   - eu * usq / (2 * CS2 * CS2))
        out.append(float(W[i]) * rho * common)
    return torch.stack(out)


def collide(f: torch.Tensor, omega, force, galcor: bool) -> torch.Tensor:
    """BGK with the velocity-shift body force ``force = (gx, gy, gz)``; the
    eager model and the plain versions of the kernels share it."""
    rho = torch.sum(f, dim=0)
    u = tuple(lbm.edot(E[:, a], f) / rho for a in range(3))
    feq = equilibrium(rho, u, galcor)
    fc = f + omega * (feq - f)
    u2 = tuple(u[a] + force[a] for a in range(3))
    return fc + (equilibrium(rho, u2, galcor) - feq)


def _make(name: str, galcor: bool):
    def _def():
        return family.base_def(name, E,
                               "3D BGK" + (" + Galilean correction"
                                           if galcor else ""),
                               faces="WE", symmetries="NS")

    def run(ctx: NodeCtx) -> dict:
        f = ctx.group("f")
        f = family.apply_boundaries(ctx, f, E, W, OPP)
        family.add_flux_objectives(ctx, f, E)
        fc = collide(f, ctx.setting("omega"), family.gravity_of(ctx),
                     galcor)
        f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
        return ctx.store({"f": f})

    def init(ctx: NodeCtx) -> dict:
        return family.standard_init(ctx, E, W)

    def build():
        return _def().finalize().bind(
            run=run, init=init,
            quantities=family.make_getters(E, force_of=family.gravity_of))

    return build


build = _make("d3q27_BGK", galcor=False)
build_galcor = _make("d3q27_BGK_galcor", galcor=True)
