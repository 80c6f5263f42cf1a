"""d2q9_diff — 2D advection-diffusion with adjoint support.

The port's counterpart of the JAX package's ``models/d2q9_diff.py`` (the
reference's ``d2q9_diff``): a scalar concentration advected by the
prescribed velocity (UX, UY) with BGK diffusion, and a distributed
source ``Source * w`` on DesignSpace nodes, where the design density
``w`` (``parameter=True``) is the adjoint design variable.  The globals
TotalC (collision nodes) and OutC (Outlet nodes) sum the concentration.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_diff.cuh`` repeats; its reverse stage
runs the gradients on ``generic2d_step_b``.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, OPP
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)


def _def() -> ModelDef:
    d = ModelDef("d2q9_diff", ndim=2, description="2D advection-diffusion")
    d.add_densities("f", E)
    d.add_density("w", group="w", parameter=True)
    d.add_quantity("C", comment="concentration")
    d.add_quantity("W")
    d.add_setting("omega", default=1.0)
    d.add_setting("Diffusivity", default=1 / 6,
                  derived={"omega": lambda a: 1.0 / (3 * a + 0.5)})
    d.add_setting("UX", comment="advection velocity x")
    d.add_setting("UY", comment="advection velocity y")
    d.add_setting("InitC", default=0.0, zonal=True)
    d.add_setting("Source", default=0.0, comment="source scale of w")
    d.add_global("TotalC", comment="total concentration")
    d.add_global("OutC", comment="outlet concentration flux")
    return d


def _eq(c, ux, uy) -> torch.Tensor:
    """``w_i c (1 + 3 e_i.u)`` with both components of ``e_i.u`` written
    out (zero ones included)."""
    out = []
    for i in range(9):
        eu = float(E[i, 0]) * ux + float(E[i, 1]) * uy
        out.append(float(W[i]) * c * (1.0 + 3.0 * eu))
    return torch.stack(out)


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    w = ctx.density("w")
    f = ctx.boundary_case(f, {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
    })
    c = _sum(f)
    ux = ctx.setting("UX")
    uy = ctx.setting("UY")
    om = ctx.setting("omega")
    fc = f + om * (_eq(c, ux, uy) - f)
    # the distributed source on DesignSpace nodes (the design variable)
    src = ctx.setting("Source") * w
    src = torch.where(ctx.nt_in_group("DESIGNSPACE"), src,
                      torch.zeros_like(src))
    fc = fc + _eq(src, ux * 0.0, uy * 0.0)
    coll = ctx.nt_in_group("COLLISION")
    f = torch.where(coll[None], fc, f)
    ctx.add_global("TotalC", c, where=coll)
    ctx.add_global("OutC", c, where=ctx.nt_is("Outlet"))
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    c = _plane(ctx, ctx.setting("InitC"))
    z = torch.zeros_like(c)
    return ctx.store({"f": _eq(c, z, z), "w": z[None] + 0.5})


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={"C": lambda ctx: _sum(ctx.group("f")),
                    "W": lambda ctx: ctx.density("w")})
