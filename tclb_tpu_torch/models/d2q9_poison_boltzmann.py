"""d2q9_poison_boltzmann — nonlinear Poisson-Boltzmann potential solver.

The port's counterpart of the JAX package's
``models/d2q9_poison_boltzmann.py`` (reference
src/d2q9_poison_boltzmann) on PyTorch tensors.  One ``g`` population
iterates Guo's Poisson LBM (``models/guo_poisson.py``) toward a fixed point
of ``epsilon lap(psi) = -rho_e(psi)`` with the full nonlinear charge
density ``rho_e = -2 n_inf z el sinh(z el / (kb T) psi)``; walls impose
the zeta potential ``g_i = wp_i psi_bc``.  Three stages: ``BaseIteration``
collides, ``CalcPsi`` refreshes the ``psi`` Field from the streamed
``g``, and ``CalcSubiter`` (no streaming) counts the sweeps in the
``subiter`` plane.

Every term is written in the order the device header
``csrc/models/d2q9_poison_boltzmann.cuh`` repeats.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E
from tclb_tpu_torch.models.d2q9_heat import _plane
from tclb_tpu_torch.models.guo_poisson import WP
from tclb_tpu_torch.models.guo_poisson import collide as _guo_collide
from tclb_tpu_torch.models.guo_poisson import psi_of as _psi_of
from tclb_tpu_torch.ops import lbm


def _def() -> ModelDef:
    d = ModelDef("d2q9_poison_boltzmann", ndim=2,
                 description="nonlinear Poisson-Boltzmann solver")
    d.add_densities("g", E)
    d.add_density("subiter")
    d.add_field("psi", dx=(-1, 1), dy=(-1, 1))
    d.add_quantity("Psi")
    d.add_quantity("Subiter")
    d.add_quantity("rho_e", unit="kg/m3")
    d.add_stage("BaseIteration", "Run")
    d.add_stage("CalcPsi", "CalcPsi")
    d.add_stage("CalcSubiter", "CalcSubiter", load_densities=False)
    d.add_stage("BaseInit", "Init", load_densities=False)
    d.add_action("Iteration", ("BaseIteration", "CalcPsi", "CalcSubiter"))
    d.add_action("Init", ("BaseInit", "CalcPsi"))
    d.add_setting("tau_psi", default=1.0)
    d.add_setting("n_inf", default=1.0)
    d.add_setting("z", default=1.0)
    d.add_setting("el", default=1.0)
    d.add_setting("kb", default=1.0)
    d.add_setting("T", default=1.0)
    d.add_setting("epsilon", default=1.0)
    d.add_setting("dt", default=1.0)
    d.add_setting("psi_bc", default=1.0, zonal=True,
                  comment="zeta potential at walls")
    d.add_setting("psi0", default=1.0, zonal=True)
    return d


def _rho_e(ctx: NodeCtx, psi):
    z = ctx.setting("z")
    return -2.0 * ctx.setting("n_inf") * z * ctx.setting("el") \
        * torch.sinh(z * ctx.setting("el") / ctx.setting("kb")
                     / ctx.setting("T") * psi)


def run(ctx: NodeCtx) -> dict:
    g = ctx.group("g")
    g = ctx.boundary_case(g, {
        ("Wall", "Solid"): lambda g: lbm.wstack(
            WP, _plane(ctx, ctx.setting("psi_bc"))),
    })
    psi = _psi_of(g)
    gc = _guo_collide(g, psi, _rho_e(ctx, psi), ctx.setting("tau_psi"),
                      ctx.setting("dt"), ctx.setting("epsilon"))
    return ctx.store({"g": torch.where(ctx.nt_in_group("COLLISION")[None],
                                       gc, g)})


def calc_psi(ctx: NodeCtx) -> dict:
    return {"psi": _psi_of(ctx.group("g"))}


def calc_subiter(ctx: NodeCtx) -> dict:
    return {"subiter": ctx.density("subiter") + 1.0}


def init(ctx: NodeCtx) -> dict:
    psi0 = _plane(ctx, ctx.setting("psi0"))
    return ctx.store({"g": lbm.wstack(WP, psi0),
                      "subiter": torch.zeros_like(psi0)})


def build():
    return _def().finalize().bind(
        run=run, init=init,
        stages={"CalcPsi": calc_psi, "CalcSubiter": calc_subiter},
        quantities={
            "Psi": lambda c: _psi_of(c.group("g")),
            "Subiter": lambda c: c.density("subiter"),
            "rho_e": lambda c: _rho_e(c, _psi_of(c.group("g"))),
        })
