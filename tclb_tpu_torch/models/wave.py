"""wave — the scalar wave equation as a first-order system on Fields.

The port's counterpart of the JAX package's ``models/wave.py`` (the
reference's ``wave``, an R-only skeleton: ``u'' = c (u_xx + u_yy)``
through the Fields u and v read over a +-1 stencil, Dirichlet nodes
pinned to the zonal ``Value``).  Nothing streams: the one stage reads
both Fields from the un-streamed storage.

Every term is written in the order the device header
``csrc/models/wave.cuh`` repeats.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9_heat import _plane


def _def() -> ModelDef:
    d = ModelDef("wave", ndim=2, description="wave equation on fields")
    d.add_field("u", dx=(-1, 1), dy=(-1, 1))
    d.add_field("v", dx=(-1, 1), dy=(-1, 1))
    d.add_quantity("U")
    d.add_setting("Speed", default=0.1)
    d.add_setting("Value", default=0.0, zonal=True)
    d.add_setting("Viscosity", default=0.0)
    d.add_node_type("Dirichlet", "BOUNDARY")
    return d


def run(ctx: NodeCtx) -> dict:
    u = ctx.load("u")
    v = ctx.load("v")
    lap = (ctx.load("u", 1, 0) + ctx.load("u", -1, 0)
           + ctx.load("u", 0, 1) + ctx.load("u", 0, -1) - 4.0 * u)
    v = v + ctx.setting("Speed") * lap - ctx.setting("Viscosity") * v
    u = u + v
    pinned = ctx.nt_is("Dirichlet")
    u = torch.where(pinned, ctx.setting("Value"), u)
    v = torch.where(pinned, torch.zeros_like(v), v)
    return {"u": u, "v": v}


def init(ctx: NodeCtx) -> dict:
    u = _plane(ctx, ctx.setting("Value")).clone()
    return {"u": u, "v": torch.zeros_like(u)}


def build():
    return _def().finalize().bind(
        run=run, init=init, quantities={"U": lambda c: c.load("u")})
