"""d2q9_hb — thermal d2q9 with shear-driven material destruction.

The port's counterpart of the JAX package's ``models/d2q9_hb.py``
(reference ``src/d2q9_hb``): ``d2q9_heat``'s flow and advected scalar T,
the shear quantities (Q, Qxx, Qxy, Qyy, SS from the non-equilibrium
stress of the post-collision f) and ``Destroy`` nodes where the scalar
erodes at ``DestructionRate * SS^DestructionPower``; the global
DestroyedCellFlux sums what was eroded.  Its device header is
``csrc/models/d2q9_hb.cuh`` (``d2q9_heat.cuh``'s physics built with the
erosion branch).
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import d2q9_heat
from tclb_tpu_torch.models.d2q9 import E, _equilibrium
from tclb_tpu_torch.models.d2q9_heat import _sum
from tclb_tpu_torch.ops import lbm


def _def():
    d = d2q9_heat._def()
    d.name = "d2q9_hb"
    d.description = "thermal d2q9 with shear-driven destruction"
    d.add_quantity("Q")
    d.add_quantity("Qxx")
    d.add_quantity("Qxy")
    d.add_quantity("Qyy")
    d.add_quantity("SS", unit="N/m2")
    d.add_setting("DestructionRate", default=0.0)
    d.add_setting("DestructionPower", default=1.0)
    d.add_global("DestroyedCellFlux")
    d.add_node_type("Destroy", "ADDITIONALS")
    d.add_node_type("Outlet2", "ADDITIONALS")
    return d


def _neq_stress(f: torch.Tensor):
    """The non-equilibrium stress of ``f``: ``(qxx, qxy, qyy, ss)``."""
    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    fneq = f - _equilibrium(rho, ux, uy)
    qxx = lbm.edot(E[:, 0] * E[:, 0], fneq)
    qxy = lbm.edot(E[:, 0] * E[:, 1], fneq)
    qyy = lbm.edot(E[:, 1] * E[:, 1], fneq)
    ss = torch.sqrt(qxx * qxx + 2.0 * qxy * qxy + qyy * qyy)
    return qxx, qxy, qyy, ss


def run(ctx: NodeCtx) -> dict:
    out = d2q9_heat.run(ctx)
    fT = out["T"]
    ss = _neq_stress(out["f"])[3]
    rate = ctx.setting("DestructionRate") * torch.pow(
        torch.clamp(ss, min=1e-30), ctx.setting("DestructionPower"))
    destroy = ctx.nt_is("Destroy")
    scale = torch.where(destroy, torch.clamp(1.0 - rate, min=0.0),
                        torch.ones_like(rate))
    ctx.add_global("DestroyedCellFlux", _sum(fT) * (1.0 - scale),
                   where=destroy)
    return {**out, "T": fT * scale[None]}


def build():
    q = {"Rho": d2q9_heat.get_rho, "T": d2q9_heat.get_t,
         "U": d2q9_heat.get_u}

    def mk(i):
        return lambda ctx: _neq_stress(ctx.group("f"))[i]

    q.update({"Qxx": mk(0), "Qxy": mk(1), "Qyy": mk(2), "SS": mk(3),
              "Q": mk(3)})
    return _def().finalize().bind(run=run, init=d2q9_heat.init,
                                  quantities=q)
