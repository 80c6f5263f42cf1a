"""d2q9_npe_guo — Nernst-Planck electrokinetics (Guo's coupled LBM).

The port's counterpart of the JAX package's ``models/d2q9_npe_guo.py``
(reference ``src/d2q9_npe_guo``, validated there against the
electro-osmotic channel flow).  Five d2q9 populations, stored in the order
phi, g, f, h_0, h_1 (45 planes), solve four coupled equations:

* ``g``: the internal potential psi by Guo's Poisson LBM
  (``models/guo_poisson.py``), with the charge source;
* ``phi``: the external potential by the same solver, source-free, driven
  by the Dirichlet ``phi_bc`` at pressure faces;
* ``h_0`` / ``h_1``: the ion number densities n0 / n1 (valence +-ez),
  advection-diffusion with the equilibrium ``w_i n (1 - e.u / cs2)`` and
  the electro-migration source ``-+ w_i ez (e.gradPsi) n B``;
* ``f``: fluid BGK with the exact-difference electric body force
  ``F = -gradPhi rho_e / rho t_to_s^2``.

Charge density ``rho_e = el ez (n0 - n1)``; the potential gradients are
the first moments of the solver populations, ``grad = -(3/2) sum_i (g_i -
wp_i psi) e_i``.  Every term is written in the order the device header
``csrc/models/d2q9_npe_guo.cuh`` repeats.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.models.guo_poisson import WP, WP0
from tclb_tpu_torch.models.guo_poisson import collide as _guo_collide
from tclb_tpu_torch.models.guo_poisson import psi_of as _psi_of
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
CS2 = 1.0 / 3.0
TAU_PSI = 1.0
TAU_PHI = 1.0
GROUPS = ("phi", "g", "f", "h_0", "h_1")
# the symmetry mirrors: the bottom's (2, 6, 5) from (4, 7, 8), the top's
# the other way round
BOTTOM = ((2, 4), (6, 7), (5, 8))
TOP = ((4, 2), (7, 6), (8, 5))


def _def() -> ModelDef:
    d = ModelDef("d2q9_npe_guo", ndim=2,
                 description="Nernst-Planck electrokinetics (Guo)")
    for gname in GROUPS:
        d.add_densities(gname, E)
    d.add_quantity("F", unit="kgm/s2", vector=True)
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("n0", unit="An/m3")
    d.add_quantity("n1", unit="An/m3")
    d.add_quantity("Psi", unit="V")
    d.add_quantity("Phi", unit="V")
    d.add_quantity("GradPsi", unit="V/m", vector=True)
    d.add_quantity("GradPhi", unit="V/m", vector=True)
    d.add_quantity("rho_e", unit="C/m3")
    d.add_setting("n_inf_0")
    d.add_setting("n_inf_1")
    d.add_setting("el", default=1.0)
    d.add_setting("el_kbT", default=1.0)
    d.add_setting("epsilon", default=1.0)
    d.add_setting("dt", default=1.0)
    d.add_setting("psi0", default=1.0)
    d.add_setting("phi0", default=1.0)
    d.add_setting("ez", default=1.0)
    d.add_setting("Ex", default=0.0)
    d.add_setting("D", default=1.0 / 6.0, comment="ion diffusivity")
    d.add_setting("nu", default=1 / 6, comment="viscosity")
    d.add_setting("rho_bc", default=1.0, zonal=True)
    d.add_setting("phi_bc", default=1.0, zonal=True)
    d.add_setting("psi_bc", default=1.0, zonal=True,
                  comment="zeta potential at walls")
    d.add_setting("t_to_s", default=1.0)
    # never accumulated: the reference's AddToTotalMomentum is commented
    # out (src/d2q9_npe_guo/Dynamics.c.Rt:252)
    d.add_global("TotalMomentum")
    d.add_node_type("BottomSymmetry", "BOUNDARY")
    d.add_node_type("TopSymmetry", "BOUNDARY")
    return d


def _stack(ctx: NodeCtx) -> torch.Tensor:
    return torch.cat([ctx.group(n) for n in GROUPS])


def _split(s: torch.Tensor) -> tuple:
    return tuple(s[9 * i:9 * i + 9] for i in range(5))


def _grad_of(g, pot):
    """``-(3/2) sum_i (g_i - wp_i pot) e_i`` (reference getGradPsi)."""
    gx = sum(float(E[i, 0]) * (g[i] - float(WP[i]) * pot)
             for i in range(9) if E[i, 0])
    gy = sum(float(E[i, 1]) * (g[i] - float(WP[i]) * pot)
             for i in range(9) if E[i, 1])
    return -1.5 * gx / TAU_PSI, -1.5 * gy / TAU_PSI


def _macro(ctx: NodeCtx, f, g, phi, h0, h1):
    rho = _sum(f)
    n0 = _sum(h0)
    n1 = _sum(h1)
    psi = _psi_of(g)
    pot = _psi_of(phi)
    rho_e = ctx.setting("el") * ctx.setting("ez") * (n0 - n1)
    gpsi = _grad_of(g, psi)
    gphi = _grad_of(phi, pot)
    ts = ctx.setting("t_to_s")
    fx = -gphi[0] * rho_e / rho * ts * ts
    fy = -gphi[1] * rho_e / rho * ts * ts
    return rho, n0, n1, psi, pot, rho_e, gpsi, (fx, fy)


def _mirror(stack: torch.Tensor, pairs) -> torch.Tensor:
    out = []
    for grp in _split(stack):
        planes = [grp[i] for i in range(9)]
        for to, src in pairs:
            planes[to] = grp[src]
        out.append(torch.stack(planes))
    return torch.cat(out)


def run(ctx: NodeCtx) -> dict:
    s = _stack(ctx)
    n_inf_0 = ctx.setting("n_inf_0")
    n_inf_1 = ctx.setting("n_inf_1")
    psi_bc = ctx.setting("psi_bc")
    phi_bc = ctx.setting("phi_bc")

    def wall(stack):
        phi_, g_, f_, h0_, h1_ = _split(stack)
        ez, kbt = ctx.setting("ez"), ctx.setting("el_kbT")
        return torch.cat([
            lbm.perm(phi_, OPP), lbm.wstack(WP, _plane(ctx, psi_bc)),
            lbm.perm(f_, OPP),
            lbm.wstack(W, _plane(ctx, n_inf_0 * torch.exp(-ez * psi_bc
                                                          * kbt))),
            lbm.wstack(W, _plane(ctx, n_inf_1 * torch.exp(ez * psi_bc
                                                          * kbt)))])

    def pressure(stack, side):
        phi_, g_, f_, h0_, h1_ = _split(stack)
        rho_b = ctx.setting("rho_bc") if side == "W" else 1.0
        return torch.cat([
            lbm.wstack(WP, _plane(ctx, phi_bc)), lbm.perm(g_, OPP),
            _zou_he_x(f_, rho_b, "pressure", side),
            lbm.wstack(W, _plane(ctx, n_inf_0)),
            lbm.wstack(W, _plane(ctx, n_inf_1))])

    s = ctx.boundary_case(s, {
        ("Wall", "Solid"): wall,
        "WPressure": lambda st: pressure(st, "W"),
        "EPressure": lambda st: pressure(st, "E"),
        "BottomSymmetry": lambda st: _mirror(st, BOTTOM),
        "TopSymmetry": lambda st: _mirror(st, TOP),
    })
    phi, g, f, h0, h1 = _split(s)

    # collision (reference CollisionBGK :241-317)
    rho, n0, n1, psi, pot, rho_e, gpsi, force = _macro(ctx, f, g, phi, h0,
                                                       h1)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    # the measured velocity (half the force) enters the ion equilibria
    umx = ux + force[0] * 0.5
    umy = uy + force[1] * 0.5
    d_ion = ctx.setting("D")
    tau_d = 3.0 * d_ion + 0.5
    bk = 3.0 * d_ion / tau_d * ctx.setting("el_kbT")
    ez = ctx.setting("ez")
    h0c, h1c = [], []
    for i in range(9):
        cu = float(E[i, 0]) * umx + float(E[i, 1]) * umy
        S = float(E[i, 0]) * gpsi[0] + float(E[i, 1]) * gpsi[1]
        heq0 = float(W[i]) * n0 * (1.0 - cu / CS2)
        heq1 = float(W[i]) * n1 * (1.0 - cu / CS2)
        h0c.append(h0[i] - (h0[i] - heq0) / tau_d
                   - float(W[i]) * ez * S * n0 * bk)
        h1c.append(h1[i] - (h1[i] - heq1) / tau_d
                   + float(W[i]) * ez * S * n1 * bk)
    gc = _guo_collide(g, psi, rho_e, TAU_PSI, ctx.setting("dt"),
                      ctx.setting("epsilon"))
    phic = phi - (phi - lbm.wstack(WP, pot)) / TAU_PHI
    omega = 1.0 / (3.0 * ctx.setting("nu") + 0.5)
    feq = lbm.equilibrium(E, W, rho, (ux, uy))
    feq2 = lbm.equilibrium(E, W, rho, (ux + force[0], uy + force[1]))
    fc = f - omega * (f - feq) + (feq2 - feq)

    coll = ctx.nt_in_group("COLLISION")[None]
    return ctx.store({
        "f": torch.where(coll, fc, f), "g": torch.where(coll, gc, g),
        "phi": torch.where(coll, phic, phi),
        "h_0": torch.where(coll, torch.stack(h0c), h0),
        "h_1": torch.where(coll, torch.stack(h1c), h1)})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    ones = torch.ones(shape, dtype=dt, device=dev)
    zero = torch.zeros(shape, dtype=dt, device=dev)
    # g_i = wp0 psi0 for every i (reference Init :221-239), so that getPsi
    # returns psi0; phi likewise
    g = torch.stack([ctx.setting("psi0") * WP0 * ones for _ in range(9)])
    phi = torch.stack([ctx.setting("phi0") * WP0 * ones for _ in range(9)])
    f = lbm.equilibrium(E, W, ones, (zero, zero))
    h0 = torch.stack([ctx.setting("n_inf_0") * float(W[i]) * ones
                      for i in range(9)])
    h1 = torch.stack([ctx.setting("n_inf_1") * float(W[i]) * ones
                      for i in range(9)])
    return ctx.store({"f": f, "g": g, "phi": phi, "h_0": h0, "h_1": h1})


def _q(fn):
    def wrap(ctx):
        phi, g, f, h0, h1 = _split(_stack(ctx))
        return fn(f, *_macro(ctx, f, g, phi, h0, h1))
    return wrap


def _vec(x, y) -> torch.Tensor:
    return torch.stack([x, y, torch.zeros_like(x)])


def _u(f, rho, n0, n1, psi, pot, rho_e, gpsi, force):
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return _vec(ux + 0.5 * force[0], uy + 0.5 * force[1])


def _gphi(ctx: NodeCtx) -> torch.Tensor:
    phi = ctx.group("phi")
    return _vec(*_grad_of(phi, _psi_of(phi)))


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={
            "F": _q(lambda f, *m: _vec(*m[-1])),
            "U": _q(_u),
            "Rho": _q(lambda f, *m: m[0]),
            "n0": _q(lambda f, *m: m[1]),
            "n1": _q(lambda f, *m: m[2]),
            "Psi": _q(lambda f, *m: m[3]),
            "Phi": _q(lambda f, *m: m[4]),
            "GradPsi": _q(lambda f, *m: _vec(*m[6])),
            "GradPhi": _gphi,
            "rho_e": _q(lambda f, *m: m[5]),
        })
