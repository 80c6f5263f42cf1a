"""d2q9_kuper_adj — Kupershtokh multiphase with a design density.

The port's counterpart of the JAX package's ``models/d2q9_kuper_adj.py``
(the reference's ``d2q9_kuper_adj``): ``models/d2q9_kuper.py`` with a
per-node design density ``wd`` (``parameter=True``, not streamed) that
scales the pseudopotential CalcPhi writes, ``phi = FAcc sqrt(max(rho/3 -
p, 0)) wd``, so that the interaction strength is the handle of a design.
Init writes wd = 1.  The whole two-stage step is differentiable; the
kernels reverse it with ``csrc/models/d2q9_kuper_adj.cuh``'s
``stage_b<0>`` and ``stage_b<1>``.

Where ``rho/3 - p <= 0`` the clamp engages: the JAX package's derivative
is NaN there (``jnp.sqrt(jnp.maximum(x, 0))``), the port's is 0 (its
``torch.clamp`` and the kernel's reverse alike); the gradient is defined
only where ``rho/3 - p > 0``.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import d2q9_kuper


def _def():
    d = d2q9_kuper._def()
    d.name = "d2q9_kuper_adj"
    d.description = "Kupershtokh multiphase with design field"
    d.add_density("wd", group="wd", parameter=True)
    d.add_quantity("WD")
    d.add_quantity("WDB", adjoint=True)
    return d


def calc_phi(ctx: NodeCtx) -> dict:
    out = d2q9_kuper.calc_phi(ctx)
    # the design field scales the local pseudopotential
    return {"phi": out["phi"] * ctx.density("wd")}


def init(ctx: NodeCtx) -> dict:
    out = d2q9_kuper.init(ctx)
    return {**out, "wd": torch.ones(tuple(ctx.flags.shape),
                                    dtype=ctx._fields.dtype,
                                    device=ctx._fields.device)}


def build():
    def wq(c):
        return c.density("wd")

    return _def().finalize().bind(
        run=d2q9_kuper.run, init=init,
        stages={"CalcPhi": calc_phi},
        quantities={"Rho": lambda c: d2q9_kuper._rho(c.group("f")),
                    "U": d2q9_kuper.get_u, "P": d2q9_kuper.get_p,
                    "F": d2q9_kuper.get_f, "WD": wq, "WDB": wq})
