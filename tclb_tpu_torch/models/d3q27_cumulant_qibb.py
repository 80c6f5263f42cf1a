"""d3q27_cumulant_qibb_small — cumulant collision with interpolated (Q-cut)
bounce-back for off-grid walls.

The port's counterpart of the JAX package's ``models/d3q27_cumulant_qibb.py``
on PyTorch tensors (the reference's d3q27_cumulant_qibb_small).  Per
streaming link a wall-cut distance ``q in [0, 1]`` (the fraction of the
link inside the fluid; ``-1``: no cut) drives Bouzidi-style interpolated
bounce-back around the cumulant collision with Galilean correction:

* pre-collision: on a QIBB node every cut link replaces its pulled-in
  population ``f[opp(i)]`` (which came from the solid side) with the
  node's own pre-streaming ``f_i``, and the patched stack is kept as
  ``f_pre``;
* post-collision: cut links blend
  ``f_i <- ((1 - q) f_pre_i + q (f_i + f_opp(i))) / (1 + q)``.

The cut distances are 26 densities ``q[i]`` that do not stream, aligned
with the velocity set's entries 1..26 in its tensor-product order (entry
0 is the velocity (-1, -1, -1), entry 13 the rest one), as the reference
aligns them; ``utils.geometry.cuts_from_sdf`` paints them.  The device
header ``csrc/models/d3q27_cumulant_qibb.cuh`` repeats this step and
shares its collision with the z-slab kernels
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
    d = family.base_def("d3q27_cumulant_qibb_small", E,
                        "3D cumulant with interpolated (Q-cut) bounce-back",
                        faces="WENS", symmetries="NS", objectives=False)
    d.add_setting("nubuffer", default=0.01)
    d.add_setting("GalileanCorrection", default=1.0)
    d.add_setting("omega_bulk", default=1.0)
    for ax in ("X", "Y", "Z"):
        d.add_setting(f"Force{ax}")
    d.add_global("Flux", unit="m3/s")
    d.add_node_type("QIBB", "HO_BOUNDARY")
    d.add_node_type("Buffer", "ADDITIONALS")
    for i in range(1, 27):
        d.add_density(f"q[{i}]", group="q")
    d.add_quantity("P", unit="Pa")
    return d


def _force(ctx: NodeCtx):
    return tuple(ctx.setting(f"Force{ax}") + g for ax, g in
                 zip(("X", "Y", "Z"), family.gravity_of(ctx)))


def run(ctx: NodeCtx) -> dict:
    f = family.apply_boundaries(ctx, ctx.group("f"), E, W, OPP)
    qibb = ctx.nt_is("QIBB")
    cuts = ctx.group("q")
    # pre-collision: cut links take the node's own pre-streaming f_i in
    # place of the value pulled in from the solid side
    planes = [f[i] for i in range(27)]
    for i in range(1, 27):
        b = int(OPP[i])
        planes[b] = torch.where(qibb & (cuts[i - 1] >= 0.0),
                                ctx.load(f"f[{i}]"), planes[b])
    fpre = torch.stack(planes)
    shape = fpre.shape[1:]
    om_buffer = 1.0 / (3.0 * ctx.setting("nubuffer") + 0.5)
    om = torch.where(ctx.nt_is("Buffer"), om_buffer, ctx.setting("omega"))
    Fp, _, (ux, _, _) = cumulant.collide_d3q27(
        fpre.reshape((3, 3, 3) + shape), om, ctx.setting("omega_bulk"),
        force=_force(ctx), correlated=True,
        galilean=ctx.setting("GalileanCorrection"))
    coll = ctx.nt_in_group("COLLISION")
    f = torch.where(coll[None], Fp.reshape((27,) + shape), fpre)
    ctx.add_global("Flux", ux, where=coll)
    # post-collision: the interpolated bounce-back on cut links
    out = [f[i] for i in range(27)]
    for i in range(1, 27):
        q = torch.clamp(cuts[i - 1], min=0.0)
        b = int(OPP[i])
        blended = ((1.0 - q) * fpre[i] + q * (f[i] + f[b])) / (1.0 + q)
        out[i] = torch.where(qibb & (cuts[i - 1] >= 0.0), blended, out[i])
    return ctx.store({"f": torch.stack(out)})


def init(ctx: NodeCtx) -> dict:
    # the painted cuts are static geometry: Init keeps them
    return family.standard_init(ctx, E, W, extra={"q": ctx.group("q")})


def build():
    q = family.make_getters(E, force_of=_force)
    q["P"] = lambda c: (torch.sum(c.group("f"), dim=0) - 1.0) / 3.0
    return _def().finalize().bind(run=run, init=init, quantities=q)
