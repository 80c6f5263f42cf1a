"""d2q9_pf — conservative phase-field interface tracking on two lattices.

The port's counterpart of the JAX package's ``models/d2q9_pf.py`` (the
reference's ``d2q9_pf``, M. Dzikowski 2016).  Two d2q9 populations:
``f`` carries the flow (every non-conserved moment relaxed at one rate,
with exact-difference gravity), ``h`` the phase field with the
anti-diffusive sharpening term ``Bh w_i e.n``, ``Bh = 3 M (1 - 4 pf^2)
W``; the interface normal comes from the first central moments of ``h``.
Walls bounce both groups, the Zou/He faces act on ``f`` only.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d2q9_pf.cuh`` repeats.  ``W``, ``OPP18``,
``_heq``, ``_normal_of`` and ``init`` serve ``d2q9_pf_curvature`` too.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, _zou_he_x
from tclb_tpu_torch.models.d2q9_heat import _plane, _sum
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)
OPP18 = np.concatenate([OPP, OPP + 9])


def _def() -> ModelDef:
    d = ModelDef("d2q9_pf", ndim=2,
                 description="conservative phase-field interface tracking")
    d.add_densities("f", E)
    d.add_densities("h", E)
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("Normal", unit="1/m", vector=True)
    d.add_quantity("PhaseField", unit="1")
    d.add_setting("omega", comment="one over relaxation time")
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity", default=0.0, zonal=True)
    d.add_setting("Pressure", default=0.0, zonal=True)
    d.add_setting("W", default=1.0, comment="anti-diffusivity coeff")
    d.add_setting("M", default=1.0, comment="mobility")
    d.add_setting("PhaseField", default=1.0, zonal=True,
                  comment="phase-field marker scalar")
    d.add_setting("GravitationX")
    d.add_setting("GravitationY")
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    return d


def _heq(pf, n, u, bh) -> torch.Tensor:
    """The h equilibrium: the advected phase field plus the sharpening
    flux along the interface normal ``n`` (the rest population has no
    e.n term)."""
    base = lbm.equilibrium(E, W, pf, u)
    out = [base[0]]
    for i in range(1, 9):
        en = lbm.edot(E[i], n)
        out.append(base[i] + bh * float(W[i]) * en)
    return torch.stack(out)


def _normal_of(kx, ky):
    """``-k / |k|``, zero where ``|k|`` vanishes."""
    ln = torch.sqrt(kx * kx + ky * ky)
    safe = torch.where(ln > 0, ln, torch.ones_like(ln))
    zero = torch.zeros_like(ln)
    return (torch.where(ln > 0, -kx / safe, zero),
            torch.where(ln > 0, -ky / safe, zero))


def _normal(h, u):
    """The interface normal from the first central moments of h:
    k = sum_i h_i (e_i - u), n = -k / |k|."""
    pf = _sum(h)
    return _normal_of(lbm.edot(E[:, 0], h) - pf * u[0],
                      lbm.edot(E[:, 1], h) - pf * u[1])


def _boundaries(ctx: NodeCtx, fh: torch.Tensor) -> torch.Tensor:
    """Walls bounce both groups; the Zou/He faces act on f only."""
    vel = ctx.setting("Velocity")
    den = 1.0 + 3.0 * ctx.setting("Pressure")

    def zou(kind, side):
        def apply(fh):
            f = _zou_he_x(fh[:9], vel if kind == "velocity" else den,
                          kind, side)
            return torch.cat([f, fh[9:]])
        return apply

    return ctx.boundary_case(fh, {
        ("Wall", "Solid"): lambda s: lbm.perm(s, OPP18),
        "EVelocity": zou("velocity", "E"),
        "WPressure": zou("pressure", "W"),
        "WVelocity": zou("velocity", "W"),
        "EPressure": zou("pressure", "E"),
    })


def run(ctx: NodeCtx) -> dict:
    fh = torch.cat([ctx.group("f"), ctx.group("h")])
    fh = _boundaries(ctx, fh)
    f, h = fh[:9], fh[9:]

    # the flow: every non-conserved moment at rate omega, exact-difference
    # gravity (equal rates make the moment basis immaterial)
    rho = _sum(f)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    gx = ctx.setting("GravitationX")
    gy = ctx.setting("GravitationY")
    omega = ctx.setting("omega")
    feq = lbm.equilibrium(E, W, rho, (ux, uy))
    u2 = (ux + gx, uy + gy)
    feq2 = lbm.equilibrium(E, W, rho, u2)
    fc = feq2 + (1.0 - omega) * (f - feq)

    # the phase field sees the post-collision velocity
    pf = _sum(h)
    n = _normal(h, u2)
    omega_ph = 1.0 / (3.0 * ctx.setting("M") + 0.5)
    bh = 3.0 * ctx.setting("M") * (1.0 - 4.0 * pf * pf) * ctx.setting("W")
    hc = h - omega_ph * (h - _heq(pf, n, u2, bh))

    coll = ctx.nt_in_group("COLLISION")[None]
    f = torch.where(coll, fc, f)
    h = torch.where(coll, hc, h)
    return ctx.store({"f": f, "h": h})


def init(ctx: NodeCtx) -> dict:
    rho = _plane(ctx, 1.0 + 3.0 * ctx.setting("Pressure"))
    ux = _plane(ctx, ctx.setting("Velocity"))
    uy = torch.zeros_like(ux)
    pf = _plane(ctx, ctx.setting("PhaseField"))
    f = lbm.equilibrium(E, W, rho, (ux, uy))
    h = lbm.equilibrium(E, W, pf, (ux, uy))
    return ctx.store({"f": f, "h": h})


def _u(f):
    rho = _sum(f)
    return lbm.edot(E[:, 0], f) / rho, lbm.edot(E[:, 1], f) / rho


def get_u(ctx: NodeCtx) -> torch.Tensor:
    ux, uy = _u(ctx.group("f"))
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def get_normal(ctx: NodeCtx) -> torch.Tensor:
    nx, ny = _normal(ctx.group("h"), _u(ctx.group("f")))
    return torch.stack([nx, ny, torch.zeros_like(nx)])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={
            "Rho": lambda c: _sum(c.group("f")),
            "U": get_u,
            "Normal": get_normal,
            "PhaseField": lambda c: _sum(c.group("h")),
        })
