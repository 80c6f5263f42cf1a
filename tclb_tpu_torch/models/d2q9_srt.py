"""d2q9_SRT — 2D single-relaxation-time BGK.

The port's counterpart of the JAX package's ``models/d2q9_srt.py``, op for
op on PyTorch tensors: BGK collision with the velocity-shift body force,
bounce-back walls, non-equilibrium bounce-back velocity/pressure faces,
Top/Bottom symmetry mirrors and the in/outlet flux objectives.
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
    d = family.base_def("d2q9_SRT", E, "2D single-relaxation-time BGK")
    d.add_node_type("TopSymmetry", "BOUNDARY")
    d.add_node_type("BottomSymmetry", "BOUNDARY")
    return d


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    fc, _, _ = lbm.bgk_collide(E, W, f, ctx.setting("omega"),
                               force=family.gravity_of(ctx))
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    return family.standard_init(ctx, E, W)


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities=family.make_getters(E, force_of=family.gravity_of))
