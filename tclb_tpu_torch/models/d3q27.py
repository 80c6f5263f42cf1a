"""d3q27 — 3D 27-velocity central-moment (cascaded) MRT.

The port's counterpart of the JAX package's ``models/d3q27.py`` on PyTorch
tensors: the cascaded central-moment operator
(``ops/cumulant.py:collide_d3q27`` with ``correlated=False``: the higher
moments project onto the factorized Gaussian equilibrium) with gravity as
a velocity shift, under the family's W/E faces, N/S symmetries and flux
objectives.  The device header ``csrc/models/d3q27.cuh`` repeats the
boundary cases op for op and shares its collision with the z-slab kernels
(``csrc/models/d3q27_moments.cuh``).
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.ops import cumulant, lbm

E = cumulant.velocity_set(3)
W = lbm.weights(E)
OPP = lbm.opposite(E)


def _def():
    d = family.base_def("d3q27", E, "3D central-moment (cascaded) MRT",
                        faces="WE", symmetries="NS")
    d.add_setting("omega_bulk", default=1.0,
                  comment="bulk (trace) relaxation rate")
    return d


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    shape = f.shape[1:]
    Fp, _, _ = cumulant.collide_d3q27(
        f.reshape((3, 3, 3) + shape), ctx.setting("omega"),
        ctx.setting("omega_bulk"), force=family.gravity_of(ctx),
        correlated=False)
    f = torch.where(ctx.nt_in_group("COLLISION")[None],
                    Fp.reshape((27,) + shape), f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    return family.standard_init(ctx, E, W)


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities=family.make_getters(E, force_of=family.gravity_of))
