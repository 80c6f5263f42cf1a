"""d2q9_solid — dendritic solidification with flow, heat and solute.

The port's counterpart of the JAX package's ``models/d2q9_solid.py``
(reference ``src/d2q9_solid``): three d2q9 lattices, ``f`` (flow), ``g``
(temperature ``rhoT``) and ``h`` (solute concentration ``C``), coupled to
the solid fraction ``fi_s`` (a Field read at the eight neighbours) and the
banked solid-side concentration ``Cs``:

* each collision keeps ``1 - 1/(3 D + 0.5)`` of the non-equilibrium part
  and re-adds the equilibrium at the forced velocity; the solute keep
  factor is blended with the solid fraction, ``kC (1 - fi_s) - fi_s``;
* interface nodes (a fully solid node among the nine) grow by
  ``(Cl_eq - C) / (Cl_eq (1 - k))``, clamped to ``1 - fi_s``, rejecting
  solute into the liquid and banking ``C k dfi`` in ``Cs``;
* ``Cl_eq`` carries the Gibbs-Thomson curvature and the 4-fold
  anisotropy ``cos(4 (theta - Theta0))``, evaluated through the
  double-angle identities on the fi_s gradient (no arccos in the step);
* flow feels the solid through ``a = (-2 ux fi_s, -2 uy fi_s + Buoyancy
  (rhoT / rho - T0))``; the temperature and solute equilibria ride the
  midpoint velocity ``u + a / 2``.

Every term is written in the order the device header
``csrc/models/d2q9_solid.cuh`` repeats.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, OPP, _equilibrium, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
PI = 3.14159265358979311600
# the fi_s neighbourhood in the reference's order (dx outer, dy inner)
NEIGHBOURS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


def _def() -> ModelDef:
    d = ModelDef("d2q9_solid", ndim=2,
                 description="dendritic solidification: flow + heat + "
                             "solute + solid fraction")
    d.add_densities("f", E)
    d.add_densities("g", E, group="g")
    d.add_densities("h", E, group="h")
    d.add_field("fi_s", dx=(-1, 1), dy=(-1, 1),
                comment="solid fraction (solidification)")
    d.add_density("Cs", comment="solid-side banked concentration")
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("T", unit="K")
    d.add_quantity("C", unit="1")
    d.add_quantity("Ct", unit="1")
    d.add_quantity("Cl_eq", unit="1")
    d.add_quantity("Solid", unit="1")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("K", unit="1/m")
    d.add_quantity("Theta", unit="1")
    d.add_setting("nu", default=1 / 6, comment="viscosity", unit="m2/s")
    d.add_setting("FluidAlfa", default=1.0, unit="m2/s",
                  comment="thermal diffusivity")
    d.add_setting("SoluteDiffusion", default=1.0, unit="m2/s",
                  comment="solute diffusion coefficient in liquid")
    d.add_setting("C0", comment="concentration 0")
    d.add_setting("T0", comment="temperature 0", unit="K")
    d.add_setting("Teq", comment="equilibrium interface temperature",
                  unit="K")
    d.add_setting("Velocity", default=0.0, zonal=True, unit="m/s")
    d.add_setting("Pressure", default=0.0, zonal=True, unit="Pa")
    d.add_setting("Temperature", default=0.0, zonal=True, unit="K")
    d.add_setting("Concentration", default=0.0, zonal=True)
    d.add_setting("Theta0", default=0.0, zonal=True, unit="d",
                  comment="angle of preferential growth")
    d.add_setting("PartitionCoef", default=0.1,
                  comment="partition coefficient k")
    d.add_setting("LiquidusSlope", default=1.0, comment="liquidus slope m")
    d.add_setting("GTCoef", default=0.0, unit="mK",
                  comment="Gibbs-Thomson coefficient")
    d.add_setting("SurfaceAnisotropy", default=0.0,
                  comment="degree of surface-energy anisotropy")
    d.add_setting("SoluteCapillar", default=0.0, unit="m",
                  comment="solutal capillary length d_0")
    d.add_setting("Buoyancy", default=0.0, unit="m/s2K",
                  comment="Boussinesq buoyancy coefficient")
    # OutFlux and Heater are declared and unused, as in the reference
    d.add_global("OutFlux")
    d.add_global("Material")
    d.add_node_type("Heater", "ADDITIONALS")
    d.add_node_type("ForceTemperature", "ADDITIONALS")
    d.add_node_type("ForceConcentration", "ADDITIONALS")
    d.add_node_type("Seed", "ADDITIONALS")
    d.add_node_type("Obj", "OBJECTIVE")
    return d


def _fi_derivs(ctx: NodeCtx):
    """The fi_s neighbourhood and its central differences (the reference's
    LBM_FD=FALSE branch, Dynamics.c.Rt:41-46)."""
    fi = {off: ctx.load("fi_s", *off) for off in NEIGHBOURS}
    dx_ = 0.5 * (fi[(1, 0)] - fi[(-1, 0)])
    dy_ = 0.5 * (fi[(0, 1)] - fi[(0, -1)])
    dxx = fi[(1, 0)] - 2.0 * fi[(0, 0)] + fi[(-1, 0)]
    dyy = fi[(0, 1)] - 2.0 * fi[(0, 0)] + fi[(0, -1)]
    dxy = 0.25 * (fi[(1, 1)] + fi[(-1, -1)] - fi[(1, -1)] - fi[(-1, 1)])
    return fi, dx_, dy_, dxx, dyy, dxy


def _angle(dx_, dy_):
    """Gradient angle with quadrant corrections, 0 where the gradient
    vanishes (the reference's getTheta)."""
    d2 = dx_ * dx_ + dy_ * dy_
    safe = torch.where(d2 > 0.0, d2, torch.ones_like(d2))
    theta = torch.arccos(torch.sqrt(torch.clamp(dx_ * dx_ / safe, 0.0,
                                                1.0)))
    theta = torch.where(dx_ < 0, PI - theta, theta)
    theta = torch.where(dy_ < 0, 2.0 * PI - theta, theta)
    return torch.where(d2 > 0.0, theta, torch.zeros_like(d2))


def _curvature(dx_, dy_, dxx, dyy, dxy):
    """Interface curvature, 0 where the gradient vanishes; also ``d2`` and
    the guarded ``safe``."""
    d2 = dx_ * dx_ + dy_ * dy_
    safe = torch.where(d2 > 0.0, d2, torch.ones_like(d2))
    k = (2.0 * dx_ * dy_ * dxy - dx_ * dx_ * dyy
         - dy_ * dy_ * dxx) * safe ** -1.5
    return torch.where(d2 > 0.0, k, torch.zeros_like(d2)), d2, safe


def _cl_eq(ctx: NodeCtx, T, derivs=None):
    """Equilibrium interface concentration with the Gibbs-Thomson
    curvature undercooling and the 4-fold anisotropy (reference getCl_eq),
    ``cos(4 (theta - Theta0))`` through the double-angle identities."""
    _, dx_, dy_, dxx, dyy, dxy = derivs or _fi_derivs(ctx)
    k, d2, safe = _curvature(dx_, dy_, dxx, dyy, dxy)
    c2 = (dx_ * dx_ - dy_ * dy_) / safe
    s2 = 2.0 * dx_ * dy_ / safe
    c4 = c2 * c2 - s2 * s2
    s4 = 2.0 * s2 * c2
    # a vanishing gradient has theta = 0: cos(4 (theta - Theta0)) is then
    # cos(4 Theta0)
    c4 = torch.where(d2 > 0.0, c4, torch.ones_like(d2))
    s4 = torch.where(d2 > 0.0, s4, torch.zeros_like(d2))
    th0 = 4.0 * ctx.setting("Theta0")
    cos4 = c4 * torch.cos(th0) + s4 * torch.sin(th0)
    aniso = 1.0 - 15.0 * ctx.setting("SurfaceAnisotropy") * cos4
    return ctx.setting("C0") + ((T - ctx.setting("Teq"))
                                + ctx.setting("GTCoef") * k * aniso
                                ) / ctx.setting("LiquidusSlope")


def _refill_w(q, target):
    """West-face refill of an advection-diffusion lattice: the e_x = +1
    populations from the target scalar, ``w_i 6 (target - sum_{e_x <= 0}
    q)`` (reference WVelocity/WPressure g/h blocks)."""
    keep = sum(q[i] for i in range(9) if E[i, 0] <= 0)
    s = 6.0 * (target - keep)
    return torch.stack([float(W[i]) * s if E[i, 0] == 1 else q[i]
                        for i in range(9)])


def _refill_e(q):
    """East-face outflow refill: the e_x = -1 populations from the e_x =
    +1 ones (reference EPressure g/h blocks)."""
    s = 6.0 * sum(q[i] for i in range(9) if E[i, 0] == 1)
    return torch.stack([float(W[i]) * s if E[i, 0] == -1 else q[i]
                        for i in range(9)])


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    g = ctx.group("g")
    h = ctx.group("h")
    fi_s = ctx.density("fi_s")
    cs = ctx.density("Cs")
    vel = ctx.setting("Velocity")
    den = 1.0 + ctx.setting("Pressure") / 3.0

    # boundaries (reference Run switch, Dynamics.c.Rt:243-270); every case
    # reads the bounced-back stacks, as the reference does
    bb = (ctx.nt_is("Wall") | ctx.nt_is("Solid"))[None]
    f = torch.where(bb, lbm.perm(f, OPP), f)
    g = torch.where(bb, lbm.perm(g, OPP), g)
    h = torch.where(bb, lbm.perm(h, OPP), h)
    t_in = ctx.setting("Temperature")
    c_in = ctx.setting("Concentration")
    present = ctx.present
    cases = []
    for name, fn in (
            ("WVelocity", lambda: (_zou_he_x(f, vel, "velocity", "W"),
                                   _refill_w(g, t_in), _refill_w(h, c_in))),
            ("WPressure", lambda: (_zou_he_x(f, den, "pressure", "W"),
                                   _refill_w(g, t_in), _refill_w(h, c_in))),
            # the reference's EVelocity touches f only
            ("EVelocity", lambda: (_zou_he_x(f, vel, "velocity", "E"), g,
                                   h)),
            ("EPressure", lambda: (_zou_he_x(f, 1.0, "pressure", "E"),
                                   _refill_e(g), _refill_e(h)))):
        if present is None or name in present:
            cases.append((ctx.nt_is(name)[None], fn()))
    for m, (ff, gg, hh) in cases:
        f = torch.where(m, ff, f)
        g = torch.where(m, gg, g)
        h = torch.where(m, hh, h)

    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    rhoT = _sum(g)
    c = _sum(h)

    ctx.add_global("Material", fi_s, where=ctx.nt_is("Obj"))

    # Dirichlet forcing (reference Q / dC, Dynamics.c.Rt:341-346)
    zero = torch.zeros_like(rho)
    q_force = torch.where(ctx.nt_is("ForceTemperature"),
                          ctx.setting("Temperature") - rhoT, zero)
    dc = torch.where(ctx.nt_is("ForceConcentration"),
                     ctx.setting("Concentration") - c, zero)

    kf = 1.0 - 1.0 / (3.0 * ctx.setting("nu") + 0.5)
    kt = 1.0 - 1.0 / (3.0 * ctx.setting("FluidAlfa") + 0.5)
    kc0 = 1.0 - 1.0 / (3.0 * ctx.setting("SoluteDiffusion") + 0.5)
    kc = (-kc0 - 1.0) * fi_s + kc0     # solid nodes reflect the solute

    # interface growth (Dynamics.c.Rt:354-374)
    derivs = _fi_derivs(ctx)
    all_liquid = None
    for off in NEIGHBOURS:
        cond = derivs[0][off] < 1.0
        all_liquid = cond if all_liquid is None else (all_liquid & cond)
    interface = ~all_liquid
    cl_eq = _cl_eq(ctx, rhoT / rho, derivs)
    pk = ctx.setting("PartitionCoef")
    grow = interface & (cl_eq > c)
    dfi_raw = (cl_eq - c) / (cl_eq * (1.0 - pk))
    dfi = torch.where(grow, torch.minimum(dfi_raw, 1.0 - fi_s), zero)
    fi_new = fi_s + dfi
    # the reference overwrites dC at growing nodes (:369)
    dc = torch.where(grow, c * (1.0 - pk) * dfi, dc)
    cs_new = cs + c * pk * dfi

    # forcing accelerations (Dynamics.c.Rt:376-377)
    ax = -2.0 * ux * fi_new
    ay = -2.0 * uy * fi_new + ctx.setting("Buoyancy") * (
        rhoT / rho - ctx.setting("T0"))

    # collisions: keep (x - xeq(u)) + xeq(shifted); g and h ride the
    # midpoint velocity u + a / 2 (Dynamics.c.Rt:371-388)
    coll = ctx.nt_in_group("COLLISION")
    feq = _equilibrium(rho, ux, uy)
    fc = kf * (f - feq) + _equilibrium(rho, ux + ax, uy + ay)
    uxm, uym = ux + 0.5 * ax, uy + 0.5 * ay
    geq = _equilibrium(rhoT, uxm, uym)
    gc = kt * (g - geq) + _equilibrium(rhoT + q_force, uxm, uym)
    heq = _equilibrium(c, uxm, uym)
    hc = kc[None] * (h - heq) + _equilibrium(c + dc, uxm, uym)

    f = torch.where(coll[None], fc, f)
    g = torch.where(coll[None], gc, g)
    h = torch.where(coll[None], hc, h)
    fi_out = torch.where(coll, fi_new, fi_s)
    cs_out = torch.where(coll, cs_new, cs)
    return ctx.store({"f": f, "g": g, "h": h, "fi_s": fi_out,
                      "Cs": cs_out})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    rho = torch.ones(shape, dtype=dt, device=dev)
    ux = _plane(ctx, ctx.setting("Velocity"))
    uy = torch.zeros(shape, dtype=dt, device=dev)
    rhoT = _plane(ctx, ctx.setting("Temperature"))
    c = _plane(ctx, ctx.setting("Concentration"))
    seed = ctx.nt_is("Seed")
    zero = torch.zeros(shape, dtype=dt, device=dev)
    fi = torch.where(seed, torch.ones_like(zero), zero)
    cs = torch.where(seed, c * ctx.setting("PartitionCoef"), zero)
    return ctx.store({"f": _equilibrium(rho, ux, uy),
                      "g": _equilibrium(rhoT, ux, uy),
                      "h": _equilibrium(c, ux, uy), "fi_s": fi, "Cs": cs})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_theta(ctx: NodeCtx) -> torch.Tensor:
    """Growth angle from the isotropic (weighted) fi_s gradient: the
    reference's getTheta uses the LBM_FD D1 form (Dynamics.c.Rt:117-131),
    unlike getCl_eq's central differences."""
    dx_ = dy_ = None
    for i in range(9):
        ex, ey = int(E[i, 0]), int(E[i, 1])
        if ex == 0 and ey == 0:
            continue
        p = ctx.load("fi_s", ex, ey) * float(W[i])
        if ex:
            dx_ = p * ex if dx_ is None else dx_ + p * ex
        if ey:
            dy_ = p * ey if dy_ is None else dy_ + p * ey
    return _angle(dx_ * 3.0, dy_ * 3.0)


def build():
    def get_rho(ctx):
        return torch.sum(ctx.group("f"), dim=0)

    def get_t(ctx):
        return torch.sum(ctx.group("g"), dim=0)

    def get_c(ctx):
        return torch.sum(ctx.group("h"), dim=0)

    def get_ct(ctx):
        return (torch.sum(ctx.group("h"), dim=0)
                * (1.0 - ctx.density("fi_s")) + ctx.density("Cs"))

    def get_solid(ctx):
        return ctx.density("fi_s")

    def get_cl_eq(ctx):
        rho = torch.sum(ctx.group("f"), dim=0)
        return _cl_eq(ctx, torch.sum(ctx.group("g"), dim=0) / rho)

    def get_k(ctx):
        _, dx_, dy_, dxx, dyy, dxy = _fi_derivs(ctx)
        return _curvature(dx_, dy_, dxx, dyy, dxy)[0]

    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": get_rho, "T": get_t, "C": get_c, "Ct": get_ct,
                    "Cl_eq": get_cl_eq, "Solid": get_solid, "U": get_u,
                    "K": get_k, "Theta": get_theta})
