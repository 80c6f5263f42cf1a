"""wave2d — the 2D wave equation with adjoint support.

The port's counterpart of the JAX package's ``models/wave2d.py`` (the
reference's ``wave2d``): a finite-difference wave equation carried on the
lattice machinery.  Four copies ``h1..h4`` of the height, each streamed
along one link, deliver the 5-point Laplacian; ``u`` is the time
derivative, the design density ``w`` (``parameter=True``) masks the
domain (0 at walls) and ``Loss`` damps.  Obj1 nodes sum the squared
Laplacian into TotalDiff.

Every term is written in the order the device header
``csrc/models/wave2d.cuh`` repeats; its reverse stage runs the gradients
on ``generic2d_step_b``.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9_heat import _plane


def _def() -> ModelDef:
    d = ModelDef("wave2d", ndim=2, description="2D wave equation")
    d.add_density("h", group="state")
    d.add_density("u", group="state")
    d.add_density("h1", dx=1, dy=0, group="hn")
    d.add_density("h2", dx=0, dy=1, group="hn")
    d.add_density("h3", dx=-1, dy=0, group="hn")
    d.add_density("h4", dx=0, dy=-1, group="hn")
    d.add_density("w", group="w", parameter=True)
    d.add_quantity("H")
    d.add_quantity("W")
    d.add_quantity("WB", adjoint=True)
    d.add_quantity("HB", adjoint=True)
    d.add_setting("WaveK", default=0.1, comment="wave speed coefficient")
    d.add_setting("SolidH", default=0.0, comment="H of solid nodes")
    d.add_setting("Loss", default=1.0, comment="u multiplier")
    d.add_global("TotalDiff", comment="total diff")
    d.add_node_type("Obj1", "OBJECTIVE")
    return d


def run(ctx: NodeCtx) -> dict:
    h = ctx.density("h")
    u = ctx.density("u")
    w = ctx.density("w")
    du = (ctx.density("h1") + ctx.density("h2") + ctx.density("h3")
          + ctx.density("h4") - 4.0 * h)
    ctx.add_global("TotalDiff", du * du, where=ctx.nt_is("Obj1"))
    u = u + du * ctx.setting("WaveK")
    h = (h + u) * w
    u = u * ctx.setting("Loss")
    return ctx.store({"state": torch.stack([h, u]),
                      "hn": torch.stack([h, h, h, h]), "w": w[None]})


def init(ctx: NodeCtx) -> dict:
    zero = _plane(ctx, 0.0)
    w = torch.where(ctx.nt_is("Wall"), zero, zero + 1.0)
    h = torch.where(ctx.nt_is("Solid"), _plane(ctx, ctx.setting("SolidH")),
                    zero)
    return ctx.store({"state": torch.stack([h, zero]),
                      "hn": torch.stack([h, h, h, h]), "w": w[None]})


def build():
    def hq(c):
        return c.density("h")

    def wq(c):
        return c.density("w")

    return _def().finalize().bind(
        run=run, init=init,
        quantities={"H": hq, "W": wq, "HB": hq, "WB": wq})
