"""sw — shallow-water equations on d2q9 with an energy-extraction design
field.

The port's counterpart of the JAX package's ``models/sw.py`` (reference
``src/sw``): an MRT collision whose equilibrium energy moments carry the
shallow-water pressure ``g h^2`` terms (reference src/sw/Dynamics.c.Rt:
228-241), a ``w`` design field damping momentum (energy extraction), and
the TotalDiff / EnergyGain objectives on Obj1 nodes and the Material
total.  The moment transforms are unrolled over the basis in row order, as
the device header ``csrc/models/sw.cuh`` repeats them.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, M, OPP, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane
from tclb_tpu_torch.ops import lbm


def _def() -> ModelDef:
    d = ModelDef("sw", ndim=2, description="Shallow water equation")
    d.add_densities("f", E)
    d.add_density("w", group="w", parameter=True)
    d.add_quantity("Rho", unit="m")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("RhoB", adjoint=True)
    d.add_quantity("UB", adjoint=True, vector=True)
    d.add_quantity("W")
    d.add_quantity("WB", adjoint=True)
    d.add_setting("omega", default=1.0,
                  comment="one over relaxation time")
    d.add_setting("nu", default=1 / 6, comment="viscosity",
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5),
                           "S8": lambda nu: 1.0 / (3 * nu + 0.5),
                           "S9": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("InletVelocity")
    d.add_setting("InletPressure", default=0.0,
                  derived={"InletDensity": lambda p: 1.0 + p / 3.0})
    d.add_setting("InletDensity", default=1.0)
    d.add_setting("Gravity", default=1.0)
    d.add_setting("SolidH", default=1.0)
    d.add_setting("EnergySink", default=0.0)
    d.add_setting("Height", default=0.0, zonal=True)
    # relaxation rates of the non-conserved moments (e, eps, qx, qy, pxx,
    # pxy): reference S2..S9 (src/sw/Dynamics.c.Rt:206-248)
    for nm in ("S2", "S3", "S5", "S7"):
        d.add_setting(nm, default=1.0)
    d.add_setting("S8", default=1.0)
    d.add_setting("S9", default=1.0)
    d.add_global("PressDiff")
    d.add_global("TotalDiff", comment="total variation of velocity")
    d.add_global("Material", comment="total material")
    d.add_global("EnergyGain")
    d.add_node_type("Obj1", "OBJECTIVE")
    return d


def _eq_moments(dd, jx, jy, g) -> list:
    """Shallow-water equilibrium moments in the (rho, jx, jy, e, eps, qx,
    qy, pxx, pxy) basis (reference Req, src/sw/Dynamics.c.Rt:228-241)."""
    inv = 1.0 / dd
    usq = (jx * jx + jy * jy) * inv
    return [dd, jx, jy,
            -4.0 * dd + 3.0 * usq + 3.0 * dd * dd * g,
            4.0 * dd - 3.0 * usq - 4.5 * dd * dd * g,
            -jx, -jy,
            (jx * jx - jy * jy) * inv,
            jx * jy * inv]


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    w = ctx.density("w")
    vel = ctx.setting("InletVelocity")
    den = ctx.setting("InletDensity")
    f = ctx.boundary_case(f, {
        "Wall": lambda f: lbm.perm(f, OPP),
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, den, "pressure", "W"),
        "WVelocity": lambda f: _zou_he_x(f, vel, "velocity", "W"),
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
    })
    g = ctx.setting("Gravity")
    m = lbm.moments(M, f)
    dd, jx, jy = m[0], m[1], m[2]
    rates = [None, None, None] + [ctx.setting(n) for n in (
        "S2", "S3", "S5", "S7", "S8", "S9")]
    req = _eq_moments(dd, jx, jy, g)
    # keep (1 - S) of the non-equilibrium part
    m_rel = [None] * 3 + [(1.0 - rates[i]) * (m[i] - req[i])
                          for i in range(3, 9)]
    obj = ctx.nt_is("Obj1")
    ctx.add_global("TotalDiff", jx * jx + jy * jy, where=obj)
    pre = jx * jx + jy * jy
    # momentum damping by the design field: energy extraction
    jx2, jy2 = jx * w, jy * w
    ctx.add_global("EnergyGain", pre - (jx2 * jx2 + jy2 * jy2), where=obj)
    ctx.add_global("Material", w)
    req2 = _eq_moments(dd, jx2, jy2, g)
    m_post = torch.stack([dd, jx2, jy2] + [m_rel[i] + req2[i]
                                           for i in range(3, 9)])
    fc = lbm.from_moments(M, m_post)
    f = torch.where(ctx.nt_in_group("COLLISION")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    h = _plane(ctx, ctx.setting("Height"))
    one = torch.ones(shape, dtype=dt, device=dev)
    dd = torch.where(h > 0, h, one)
    dd = torch.where(ctx.nt_is("Solid"), _plane(ctx, ctx.setting("SolidH")),
                     dd)
    ux = _plane(ctx, ctx.setting("InletVelocity"))
    req = _eq_moments(dd, dd * ux, torch.zeros(shape, dtype=dt, device=dev),
                      ctx.setting("Gravity"))
    f = lbm.from_moments(M, torch.stack(req))
    w = torch.where(ctx.nt_is("Solid") | ctx.nt_is("Wall"),
                    torch.zeros(shape, dtype=dt, device=dev),
                    _plane(ctx, 1.0 - ctx.setting("EnergySink")))
    return ctx.store({"f": f, "w": w[None]})


def get_rho(ctx: NodeCtx) -> torch.Tensor:
    return torch.sum(ctx.group("f"), dim=0)


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_w(ctx: NodeCtx) -> torch.Tensor:
    return ctx.density("w")


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": get_rho, "U": get_u, "W": get_w,
                    "RhoB": get_rho, "UB": get_u, "WB": get_w})
