"""d2q9_plate — plate drag optimization (Smagorinsky BGK with wall
reaction forces).

The port's counterpart of the JAX package's ``models/d2q9_plate.py`` (the
reference's ``d2q9_plate``): the family's boundaries (bounce-back, the W
and E velocity and pressure faces on the zonal Velocity and Density) and
flux objectives, a BGK collision at the Smagorinsky rate
(``ops/lbm.py:smagorinsky_omega_unrolled``) with the velocity-shift body
force, and the plate reaction-force objectives ForceX, ForceY, Moment and
PowerX summed by momentum exchange at Wall nodes.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_plate.cuh`` repeats, so the generic
kernels agree with this eager step to a few ulps.  The rate's ``sqrt`` of
the squared stress norm has a derivative of 0 where that norm is exactly 0
(:func:`stress_norm`): there every vector of the unit ball is a
subgradient of the norm, and 0 is the one that does not depend on the
direction.  The JAX package's derivative there is NaN (``0 * inf``).
"""

from __future__ import annotations

import math

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d2q9 import E
from tclb_tpu_torch.models.d2q9_heat import _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)


def _def():
    d = family.base_def("d2q9_plate", E, "plate drag optimization")
    d.add_setting("tau0", default=1.0,
                  comment="base relaxation time")
    d.add_setting("Smag", default=0.16)
    d.add_global("ForceX", comment="reaction force X")
    d.add_global("ForceY", comment="reaction force Y")
    d.add_global("Moment", comment="reaction moment")
    d.add_global("PowerX", comment="power extracted in X")
    return d


def stress_norm(pi2: torch.Tensor) -> torch.Tensor:
    """``sqrt(pi2)``, whose derivative is 0 where ``pi2 == 0``: the
    argument of the root is 1 there, and the root is then dropped."""
    zero = pi2 == 0
    return torch.where(zero, torch.zeros_like(pi2), torch.sqrt(
        torch.where(zero, torch.ones_like(pi2), pi2)))


def smagorinsky_omega(f, feq, rho, omega0, smag) -> torch.Tensor:
    """``lbm.smagorinsky_omega_unrolled`` for d2q9, op for op, with
    :func:`stress_norm` for the root of the squared stress norm."""
    pi2 = None
    for a in range(2):
        for b in range(a, 2):
            ks = [k for k in range(9) if E[k, a] * E[k, b]]
            pab = sum(float(E[k, a] * E[k, b]) * (f[k] - feq[k])
                      for k in ks)
            term = pab * pab * (1.0 if a == b else 2.0)
            pi2 = term if pi2 is None else pi2 + term
    tau0 = 1.0 / omega0
    tau_eff = 0.5 * (tau0 + torch.sqrt(
        tau0 * tau0 + 18.0 * math.sqrt(2.0) * smag * smag
        * stress_norm(pi2) / rho))
    return 1.0 / tau_eff


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    # momentum exchange on walls: the plate's reaction force
    # (reference ForceX/ForceY globals)
    wall = ctx.nt_is("Wall")
    ex = lbm.edot(E[:, 0], f)
    ey = lbm.edot(E[:, 1], f)
    ctx.add_global("ForceX", 2.0 * ex, where=wall)
    ctx.add_global("ForceY", 2.0 * ey, where=wall)
    vel = ctx.setting("Velocity")
    ctx.add_global("PowerX", 2.0 * ex * vel, where=wall)
    ctx.add_global("Moment", 2.0 * ey, where=wall)

    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    feq = lbm.equilibrium(E, W, rho, (ux, uy))
    om0 = 1.0 / (3.0 * ctx.setting("nu") + 0.5)
    om_eff = smagorinsky_omega(f, feq, rho, om0, ctx.setting("Smag"))
    fc = f + om_eff[None] * (feq - f)
    gx, gy = family.gravity_of(ctx)
    fc = fc + (lbm.equilibrium(E, W, rho, (ux + gx, uy + gy)) - feq)
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    return family.standard_init(ctx, E, W)


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities=family.make_getters(E, force_of=family.gravity_of))
