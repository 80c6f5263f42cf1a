"""d2q9_pf_pressureEvolution — conservative phase-field two-phase LBM in
pressure-evolution form (Fakhari/Geier/Lee).

The port's counterpart of the JAX package's
``models/d2q9_pf_pressure_evolution.py`` (reference
src/d2q9_pf_pressureEvolution) on PyTorch tensors.  The hydrodynamic
population ``f`` is the pressure-shifted g-bar distribution, relaxed by a
classical-matrix MRT whose stress rate follows the phase; the phase field
streams on ``h`` with the conservative Allen-Cahn equilibrium, and the
``PhaseF`` Field (read over +-2) carries the gradient, the laplacian and
the directional differences.  Two stages: ``BaseIter`` collides, then
``calcPhase`` sums the streamed ``h`` into ``PhaseF``.

Population sums run in plane order and every term in the order the device
header ``csrc/models/d2q9_pf_pressure_evolution.cuh`` repeats.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
OPP18 = np.concatenate([OPP, OPP + 9])

# classical (integer Lallemand-Luo) d2q9 moment rows: rho, e, eps, jx, qx,
# jy, qy, pxx, pxy (reference Dynamics.c.Rt:298-307)
M_CLASSIC = np.array([
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [-4, -1, -1, -1, -1, 2, 2, 2, 2],
    [4, -2, -2, -2, -2, 1, 1, 1, 1],
    [0, 1, 0, -1, 0, 1, -1, -1, 1],
    [0, -2, 0, 2, 0, 1, -1, -1, 1],
    [0, 0, 1, 0, -1, 1, 1, -1, -1],
    [0, 0, -2, 0, 2, 1, 1, -1, -1],
    [0, 1, -1, 1, -1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, -1, 1, -1],
], dtype=np.float64)


def _def() -> ModelDef:
    d = ModelDef("d2q9_pf_pressureEvolution", ndim=2,
                 description="pressure-evolution phase-field two-phase LBM")
    d.add_densities("f", E)
    d.add_densities("h", E)
    d.add_field("PhaseF", dx=(-2, 2), dy=(-2, 2), group="phi")
    d.add_stage("PhaseInit", "Init", load_densities=False)
    d.add_stage("BaseInit", "Init_distributions", load_densities=False)
    d.add_stage("calcPhase", "calcPhaseF")
    d.add_stage("BaseIter", "Run")
    d.add_action("Iteration", ("BaseIter", "calcPhase"))
    d.add_action("Init", ("PhaseInit", "BaseInit", "calcPhase"))
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("PhaseField", unit="1")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("P", unit="Pa")
    d.add_quantity("Mu", unit="1")
    d.add_quantity("InterfaceForce", unit="N", vector=True)
    d.add_setting("Density_h", default=1.0, comment="high density")
    d.add_setting("Density_l", default=1.0, comment="low density")
    d.add_setting("PhaseField_h", default=1.0)
    d.add_setting("PhaseField_l", default=0.0)
    d.add_setting("PhaseField", default=0.0, zonal=True)
    d.add_setting("W", default=4.0, comment="interface width")
    d.add_setting("M", default=0.05, comment="mobility")
    d.add_setting("sigma", default=1e-3, comment="surface tension")
    d.add_setting("omega_l", default=1.0)
    d.add_setting("omega_h", default=1.0)
    d.add_setting("nu_l", default=1 / 6,
                  derived={"omega_l": lambda nu: 1.0 / (3 * nu)})
    d.add_setting("nu_h", default=1 / 6,
                  derived={"omega_h": lambda nu: 1.0 / (3 * nu)})
    for i in range(7):
        d.add_setting(f"S{i}", default=1.0, comment="relaxation param")
    d.add_setting("VelocityX", default=0.0, zonal=True)
    d.add_setting("VelocityY", default=0.0, zonal=True)
    d.add_setting("Pressure", default=0.0, zonal=True)
    d.add_setting("GravitationX")
    d.add_setting("GravitationY")
    d.add_setting("BuoyancyX")
    d.add_setting("BuoyancyY")
    d.add_setting("GmatchedX")
    d.add_setting("GmatchedY")
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    d.add_global("TotalDensity", unit="1kg/m3",
                 comment="mass conservation check")
    return d


# --------------------------------------------------------------------- #
# the PhaseF stencil
# --------------------------------------------------------------------- #


def _phase(ctx, dx=0, dy=0):
    return ctx.load("PhaseF", dx, dy)


def _rho_of(ctx, pf):
    rl = ctx.setting("Density_l")
    rh = ctx.setting("Density_h")
    pl = ctx.setting("PhaseField_l")
    ph = ctx.setting("PhaseField_h")
    return rl + (rh - rl) * (pf - pl) / (ph - pl)


def _grad_phi(ctx):
    """Isotropic central gradient (reference calcGradPhi)."""
    gx = (_phase(ctx, 1, 0) - _phase(ctx, -1, 0)) / 3.0 \
        + (_phase(ctx, 1, 1) - _phase(ctx, -1, -1)
           + _phase(ctx, 1, -1) - _phase(ctx, -1, 1)) / 12.0
    gy = (_phase(ctx, 0, 1) - _phase(ctx, 0, -1)) / 3.0 \
        + (_phase(ctx, 1, 1) - _phase(ctx, -1, -1)
           + _phase(ctx, -1, 1) - _phase(ctx, 1, -1)) / 12.0
    return gx, gy


def _mu(ctx):
    """Chemical potential with the 9-point laplacian (reference getMu)."""
    pf = _phase(ctx)
    pl = ctx.setting("PhaseField_l")
    ph = ctx.setting("PhaseField_h")
    pavg = 0.5 * (pl + ph)
    w = ctx.setting("W")
    sig = ctx.setting("sigma")
    lp = (_phase(ctx, 1, 1) + _phase(ctx, -1, 1)
          + _phase(ctx, 1, -1) + _phase(ctx, -1, -1)
          + 4.0 * (_phase(ctx, 1, 0) + _phase(ctx, -1, 0)
                   + _phase(ctx, 0, 1) + _phase(ctx, 0, -1))
          - 20.0 * pf) / 6.0
    return (4.0 * (12.0 * sig / w) * (pf - pl) * (pf - ph) * (pf - pavg)
            - 1.5 * sig * w * lp)


def _body_force(ctx, rho, pf):
    """(rho - rho_h) Buoyancy + rho Gravitation + (1 - pf) rho_h Gmatched."""
    rh = ctx.setting("Density_h")
    fbx = (rho - rh) * ctx.setting("BuoyancyX") \
        + rho * ctx.setting("GravitationX") \
        + (1.0 - pf) * rh * ctx.setting("GmatchedX")
    fby = (rho - rh) * ctx.setting("BuoyancyY") \
        + rho * ctx.setting("GravitationY") \
        + (1.0 - pf) * rh * ctx.setting("GmatchedY")
    return fbx, fby


def _rc(ctx):
    """Directional central differences Rc_i = (phi(e_i) - phi(-e_i)) / 2."""
    out = [torch.zeros_like(_phase(ctx))]
    for i in range(1, 9):
        dx, dy = int(E[i, 0]), int(E[i, 1])
        out.append(0.5 * (_phase(ctx, dx, dy) - _phase(ctx, -dx, -dy)))
    return out


def _gamma(u):
    """Gamma_i = feq_i / rho (the equilibrium at unit density)."""
    return lbm.equilibrium(E, W, torch.ones_like(u[0]), u)


def _correction_terms(ctx, gamma, u, grad, fb, mu, rc):
    """The interface and body-force corrections: iface_i = ((Gamma_i -
    w_i)(rho_h - rho_l)/3 + mu Gamma_i)(Rc_i - u.grad), body_i = Gamma_i
    ((e_i - u).Fb)."""
    drho = ctx.setting("Density_h") - ctx.setting("Density_l")
    ugrad = u[0] * grad[0] + u[1] * grad[1]
    iface, body = [], []
    for i in range(9):
        gi = gamma[i]
        iface.append(((gi - float(W[i])) * drho / 3.0 + mu * gi)
                     * (rc[i] - ugrad))
        body.append(gi * ((float(E[i, 0]) - u[0]) * fb[0]
                          + (float(E[i, 1]) - u[1]) * fb[1]))
    return torch.stack(iface), torch.stack(body)


def _normal(grad):
    gn = torch.sqrt(grad[0] * grad[0] + grad[1] * grad[1])
    safe = torch.where(gn > 0, gn, 1.0)
    return (torch.where(gn > 0, grad[0] / safe, 0.0),
            torch.where(gn > 0, grad[1] / safe, 0.0))


def _heq(ctx, pf, gamma, n):
    """h equilibrium Gamma_i pf + theta w_i e.n, theta = 3M(1 - 4(pf -
    pfavg)^2)/W."""
    pavg = 0.5 * (ctx.setting("PhaseField_l")
                  + ctx.setting("PhaseField_h"))
    theta = (3.0 * ctx.setting("M")) \
        * (1.0 - 4.0 * (pf - pavg) * (pf - pavg)) / ctx.setting("W")
    out = []
    for i in range(9):
        en = sum(float(E[i, a]) * n[a] for a in range(2) if E[i, a])
        out.append(gamma[i] * pf if isinstance(en, int)
                   else gamma[i] * pf + theta * float(W[i]) * en)
    return torch.stack(out)


# --------------------------------------------------------------------- #
# stages
# --------------------------------------------------------------------- #


def phase_init(ctx: NodeCtx) -> dict:
    """PhaseInit: PhaseF from the zonal setting."""
    return {"PhaseF": _plane(ctx, ctx.setting("PhaseField"))}


def calc_phase(ctx: NodeCtx) -> dict:
    """calcPhase: PhaseF = the sum of the streamed h."""
    return {"PhaseF": _sum(ctx.group("h"))}


def init_distributions(ctx: NodeCtx) -> dict:
    """BaseInit: h at equilibrium, g-bar at minus half the corrections."""
    pf = _phase(ctx)
    grad = _grad_phi(ctx)
    n = _normal(grad)
    mu = _mu(ctx)
    rho = _rho_of(ctx, pf)
    ctx.add_global("TotalDensity", rho)
    u = (_plane(ctx, ctx.setting("VelocityX")),
         _plane(ctx, ctx.setting("VelocityY")))
    fb = _body_force(ctx, rho, pf)
    gamma = _gamma(u)
    iface, body = _correction_terms(ctx, gamma, u, grad, fb, mu, _rc(ctx))
    h = _heq(ctx, pf, gamma, n)
    f = -0.5 * iface - 0.5 * body
    return ctx.store({"f": f, "h": h})


def _velocity(ctx, f, rho, mu, grad, fb):
    jx = lbm.edot(E[:, 0], f)
    jy = lbm.edot(E[:, 1], f)
    return ((3.0 / rho) * (jx + (0.5 / 3.0) * (mu * grad[0] + fb[0])),
            (3.0 / rho) * (jy + (0.5 / 3.0) * (mu * grad[1] + fb[1])))


def _pressure(ctx, f, u, grad):
    return _sum(f) \
        + (ctx.setting("Density_h") - ctx.setting("Density_l")) \
        * (grad[0] * u[0] + grad[1] * u[1]) / 6.0


def run(ctx: NodeCtx) -> dict:
    fh = torch.cat([ctx.group("f"), ctx.group("h")])
    # only bounce-back walls: the reference's velocity and pressure faces
    # have empty bodies
    fh = ctx.boundary_case(fh, {
        ("Wall", "Solid"): lambda s: lbm.perm(s, OPP18),
    })
    f, h = fh[:9], fh[9:]

    pf = _phase(ctx)
    rho = _rho_of(ctx, pf)
    ctx.add_global("TotalDensity", rho, where=ctx.nt_is("MRT"))
    mu = _mu(ctx)
    fb = _body_force(ctx, rho, pf)
    grad = _grad_phi(ctx)
    u = _velocity(ctx, f, rho, mu, grad, fb)
    p = _pressure(ctx, f, u, grad)

    gamma = _gamma(u)
    iface, body = _correction_terms(ctx, gamma, u, grad, fb, mu, _rc(ctx))
    g_bar_eq = gamma * rho / 3.0 + lbm.wstack(W, p - rho / 3.0)
    r = f - (g_bar_eq - 0.5 * iface - 0.5 * body)

    # classical-matrix MRT with the phase-interpolated stress rate
    pl = ctx.setting("PhaseField_l")
    ph = ctx.setting("PhaseField_h")
    tau = 1.0 / (ctx.setting("omega_l")
                 + (ctx.setting("omega_h") - ctx.setting("omega_l"))
                 * (pf - pl) / (ph - pl))
    s_stress = 1.0 / (tau + 0.5)
    m = lbm.moments(M_CLASSIC, r)
    m = torch.stack([m[i] * ctx.setting(f"S{i}") for i in range(7)]
                    + [m[7] * s_stress, m[8] * s_stress])
    r = lbm.from_moments(M_CLASSIC, m)
    fc = f - r + iface + body

    # the phase-field collision
    n = _normal(grad)
    omega_ph = 1.0 / (3.0 * ctx.setting("M") + 0.5)
    hc = h - omega_ph * (h - _heq(ctx, pf, gamma, n))

    coll = ctx.nt_is("MRT")[None]
    return ctx.store({"f": torch.where(coll, fc, f),
                      "h": torch.where(coll, hc, h)})


# --------------------------------------------------------------------- #
# quantities
# --------------------------------------------------------------------- #


def _macro_u(ctx):
    f = ctx.group("f")
    pf = _phase(ctx)
    rho = _rho_of(ctx, pf)
    grad = _grad_phi(ctx)
    return f, grad, _velocity(ctx, f, rho, _mu(ctx),
                              grad, _body_force(ctx, rho, pf))


def get_u(ctx: NodeCtx) -> torch.Tensor:
    _, _, (ux, uy) = _macro_u(ctx)
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_p(ctx: NodeCtx) -> torch.Tensor:
    f, grad, u = _macro_u(ctx)
    return _pressure(ctx, f, u, grad)


def get_iforce(ctx: NodeCtx) -> torch.Tensor:
    mu = _mu(ctx)
    grad = _grad_phi(ctx)
    return torch.stack([mu * grad[0], mu * grad[1], torch.zeros_like(mu)])


def build():
    return _def().finalize().bind(
        run=run, init=init_distributions,
        stages={"Init": phase_init,
                "Init_distributions": init_distributions,
                "calcPhaseF": calc_phase},
        quantities={
            "Rho": lambda c: _rho_of(c, _phase(c)),
            "PhaseField": lambda c: _phase(c),
            "U": get_u,
            "P": get_p,
            "Mu": lambda c: _mu(c),
            "InterfaceForce": get_iforce,
        })
