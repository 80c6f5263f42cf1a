"""d2q9_cumulant — 2D cumulant collision.

The port's counterpart of the JAX package's ``models/d2q9_cumulant.py``, op
for op on PyTorch tensors.  Its populations are in the tensor-product order
of ``ops/cumulant.py:velocity_set(2)`` (index 3i + j holds the velocity
(i - 1, j - 1)), not ``d2q9``'s order, so weights, bounce-back pairs and
mirrors all follow from this model's own ``E``.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.ops import cumulant, lbm

E = cumulant.velocity_set(2)        # tensor order: (cx, cy), index -1,0,1
W = lbm.weights(E)
OPP = lbm.opposite(E)


def _def():
    d = family.base_def("d2q9_cumulant", E, "2D cumulant collision")
    d.add_setting("omega_bulk", default=1.0,
                  comment="bulk (trace) relaxation rate")
    return d


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    shape = f.shape[1:]
    Fp, _, _ = cumulant.collide_d2q9(
        f.reshape((3, 3) + shape), ctx.setting("omega"),
        ctx.setting("omega_bulk"), force=family.gravity_of(ctx))
    f = torch.where(ctx.nt_in_group("COLLISION")[None],
                    Fp.reshape((9,) + shape), f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    return family.standard_init(ctx, E, W)


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities=family.make_getters(E, force_of=family.gravity_of))
