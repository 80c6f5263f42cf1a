"""d3q19_heat_adj (+ _art / _prop variants) — 3D conjugate-heat topology
optimization.

The port's counterpart of the JAX package's ``models/d3q19_heat_adj.py``
(the reference's ``d3q19_heat_adj``, ``d3q19_heat_adj_art`` and
``d3q19_heat_adj_prop``): d3q19 flow under the family's W/E faces and N/S
symmetries with a BGK collision and Brinkman velocity penalization by a
design density ``w`` (``parameter=True``, not streamed), and the d3q7
temperature of ``models/d3q19_heat.py`` with a w-interpolated diffusivity
between ``FluidAlfa`` and ``SolidAlfa``.  The variants differ in how the
design penalizes momentum:

* base: the velocity of the post-collision equilibrium scaled by ``w``;
* ``_art``: scaled by ``2 w - 1`` (w = 0 reverses the momentum);
* ``_prop``: the design propagates along +x through the streamed pair
  ``w0`` (dx -1) and ``w1`` (dx +1): on Propagate nodes the effective
  weight is ``w - PropagateX (1 - w1(x - 1))``, clipped to [0, 1] on every
  node and stored into both; momentum and diffusivity use it, and the
  global MaterialPenalty ``w (1 - w)`` penalizes intermediate material.

Globals: HeatFlux (Outlet nodes), Material (DesignSpace nodes) and Drag
(collision nodes) beside the family's PressureLoss, OutletFlux and
InletFlux, which these models register and never add to.

Derivatives follow the JAX package where PyTorch's differ: ``|u_x|`` in
Drag has derivative +1 at 0 (``abs_jax``), and the clip is
``minimum(maximum(x, 0), 1)`` with tensor bounds, whose derivative is 0.5
at x = 0 and x = 1 as ``jnp.clip``'s is (``torch.clamp`` gives 1 there).
Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d3q19_heat_adj_common.cuh`` repeats, so the
generic 3D kernels agree with this eager step to a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.models.d2q9_heat_adj import abs_jax
from tclb_tpu_torch.models.d3q19 import E, OPP, W, macroscopic
from tclb_tpu_torch.models.d3q19_heat import ET, OPPT, WT, _t_eq
from tclb_tpu_torch.ops import lbm


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] with the derivative ``jnp.clip`` has: 0.5
    at either bound (a tie of ``maximum`` or ``minimum``)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def _make(name: str, variant: str = "base"):
    def _def():
        d = family.base_def(name, E, "3D conjugate-heat topology opt",
                            faces="WE", symmetries="NS")
        d.add_densities("T", ET, group="T")
        d.add_density("w", group="w", parameter=True)
        d.add_setting("InletTemperature", default=1.0)
        d.add_setting("InitTemperature", default=1.0)
        d.add_setting("FluidAlfa", default=0.1)
        d.add_setting("SolidAlfa", default=0.01)
        d.add_setting("Porocity", default=0.0, zonal=True)
        d.add_quantity("T", unit="K")
        d.add_quantity("W")
        d.add_quantity("TB", adjoint=True)
        d.add_quantity("WB", adjoint=True)
        d.add_global("HeatFlux")
        d.add_global("Material")
        d.add_global("Drag")
        if variant == "prop":
            # the streamed weight pair: w0 streams -x, w1 streams +x
            d.add_density("w0", dx=-1, group="wm")
            d.add_density("w1", dx=1, group="wm")
            d.add_setting("PropagateX", default=0.0,
                          comment="strength of +x design propagation")
            d.add_global("MaterialPenalty")
            d.add_node_type("Propagate", "ADDITIONALS")
        return d

    def run(ctx: NodeCtx) -> dict:
        f = ctx.group("f")
        fT = ctx.group("T")
        w = ctx.density("w")
        f = family.apply_boundaries(ctx, f, E, W, OPP)
        t_in = ctx.setting("InletTemperature")
        fT = ctx.boundary_case(fT, {
            ("Wall", "Solid"): lambda t: lbm.perm(t, OPPT),
            "WVelocity": lambda t: torch.stack(
                [torch.broadcast_to(float(wt) * t_in, t.shape[1:])
                 for wt in WT]),
        })
        extra_store = {}
        if variant == "prop":
            # the pulled w1 carries the upstream (x - 1) value
            w1_up = ctx.density("w1")
            w_eff = torch.where(
                ctx.nt_is("Propagate"),
                w - ctx.setting("PropagateX") * (1.0 - w1_up), w)
            w_eff = clip01(w_eff)
            extra_store["wm"] = torch.stack([w_eff, w_eff])
        else:
            w_eff = w
        rho, u = macroscopic(f)
        om = ctx.setting("omega")
        feq = lbm.equilibrium(E, W, rho, u)
        coll_mask = ctx.nt_in_group("COLLISION")
        ctx.add_global("Drag", (1.0 - w_eff) * abs_jax(u[0]),
                       where=coll_mask)
        scale = 2.0 * w_eff - 1.0 if variant == "art" else w_eff
        u2 = tuple(c * scale for c in u)
        fc = f + om * (feq - f) + (lbm.equilibrium(E, W, rho, u2) - feq)
        temp = lbm.edot(np.ones(7), fT)
        alfa = ctx.setting("FluidAlfa") * w_eff \
            + ctx.setting("SolidAlfa") * (1.0 - w_eff)
        om_t = 1.0 / (4.0 * alfa + 0.5)
        tc = fT + om_t[None] * (_t_eq(temp, torch.stack(u2)) - fT)
        coll = coll_mask[None]
        f = torch.where(coll, fc, f)
        fT = torch.where(coll, tc, fT)
        ctx.add_global("HeatFlux", temp * u2[0], where=ctx.nt_is("Outlet"))
        in_design = ctx.nt_in_group("DESIGNSPACE")
        ctx.add_global("Material", 1.0 - w_eff, where=in_design)
        if variant == "prop":
            ctx.add_global("MaterialPenalty", w_eff * (1.0 - w_eff),
                           where=in_design)
        return ctx.store({"f": f, "T": fT, **extra_store})

    def init(ctx: NodeCtx) -> dict:
        shape = tuple(ctx.flags.shape)
        dt, dev = ctx._fields.dtype, ctx._fields.device

        def plane(v):
            return torch.broadcast_to(torch.as_tensor(v, dtype=dt,
                                                      device=dev), shape)

        fT = torch.stack([float(wt) * plane(ctx.setting("InitTemperature"))
                          for wt in WT])
        w = 1.0 - plane(ctx.setting("Porocity"))
        w = torch.where(ctx.nt_is("Solid"), torch.zeros_like(w), w)
        extra = {"T": fT, "w": w[None]}
        if variant == "prop":
            extra["wm"] = torch.stack([w, w])
        return family.standard_init(ctx, E, W, extra=extra)

    def build():
        q = family.make_getters(E, force_of=family.gravity_of)

        def tq(c):
            return torch.sum(c.group("T"), dim=0)

        def wq(c):
            return c.density("w")

        q.update({"T": tq, "W": wq, "TB": tq, "WB": wq})
        return _def().finalize().bind(run=run, init=init, quantities=q)

    return build


build = _make("d3q19_heat_adj")
build_art = _make("d3q19_heat_adj_art", variant="art")
build_prop = _make("d3q19_heat_adj_prop", variant="prop")
