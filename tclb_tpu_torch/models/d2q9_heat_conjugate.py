"""d2q9_heat_conjugate — conjugate solid/fluid heat transfer.

The port's counterpart of the JAX package's ``models/d2q9_heat_conjugate.py``
(a framework extension of ``d2q9_heat``, not a reference model): the
temperature lattice streams through Solid nodes (no bounce-back there) and
collides inside them towards the local temperature at rest with the
solid's diffusivity ``SolidAlfa``, while the flow bounces back.  Its device
header is ``csrc/models/d2q9_heat_conjugate.cuh`` (``d2q9_heat.cuh``'s
physics built with the conjugate branch).
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import d2q9_heat
from tclb_tpu_torch.models.d2q9_heat import _sum, _t_eq


def _def():
    d = d2q9_heat._def()
    d.name = "d2q9_heat_conjugate"
    d.description = "conjugate solid/fluid heat transfer"
    d.add_setting("SolidAlfa", default=0.05,
                  comment="thermal diffusivity of the solid")
    return d


def run(ctx: NodeCtx) -> dict:
    # temperature conducts through Solid nodes: no bounce-back of T there
    out = d2q9_heat.run(ctx, solid_adiabatic=False)
    fT = out["T"]
    temp = _sum(fT)
    z = torch.zeros_like(temp)
    om_s = 1.0 / (3.0 * ctx.setting("SolidAlfa") + 0.5)
    tc = fT + om_s * (_t_eq(temp, z, z) - fT)
    solid = ctx.nt_is("Solid")[None]
    return {**out, "T": torch.where(solid, tc, fT)}


def build():
    return _def().finalize().bind(
        run=run, init=d2q9_heat.init,
        quantities={"Rho": d2q9_heat.get_rho, "T": d2q9_heat.get_t,
                    "U": d2q9_heat.get_u})
