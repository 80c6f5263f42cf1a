"""d3q27_viscoplastic — Bingham viscoplastic rheology (regularized MRT).

The port's counterpart of the JAX package's ``models/d3q27_viscoplastic.py``
on PyTorch tensors (the reference's hand-written
src/d3q27_viscoplastic/Dynamics.c): a single-step stress-projection
collision on MRT nodes.  He forcing terms ``Phi_i = 3 w_i rho (e_i.F)``
and equilibria shifted by ``-Phi/2``; the non-equilibrium momentum flux
``S`` made deviatoric and contracted: nodes with ``S:S < 2 Y^2`` are
unyielded (their stress is written back unscaled, ``yield_stat = 1``,
``nu_app = 0``), yielded ones scale it by ``(6 nu - 1)/(6 nu + 1) +
sqrt(2/S:S) Y omega`` and report ``nu_app = nu + Y sqrt(S:S / 2)``; the
write-back ``f_i = 4.5 w_i (e_i . S . e_i) + feq_i + Phi_i``.  The
27-velocity Zou/He velocity and pressure faces on X and Y, the Y/Z mirror
symmetries and bounce-back; the slice monitors' 18 globals.

Sums over populations run in plane order and every term in the order the
device header ``csrc/models/d3q27_viscoplastic.cuh`` repeats, so the
generic 3D kernels agree with this eager step to a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.family import mirror_perm
from tclb_tpu_torch.ops import cumulant, lbm

E = cumulant.velocity_set(3)
W = lbm.weights(E)
OPP = lbm.opposite(E)
PLANES = ("XY", "XZ", "YZ")
# the six entries of S: (a, b) for a <= b
PAIRS = tuple((a, b) for a in range(3) for b in range(a, 3))


def _def() -> ModelDef:
    d = ModelDef("d3q27_viscoplastic", ndim=3,
                 description="Bingham viscoplastic (regularized MRT)")
    d.add_densities("f", E)
    d.add_density("nu_app")
    d.add_density("yield_stat")
    d.add_quantity("P", unit="Pa")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("nu_app", unit="m2/s")
    d.add_quantity("yield_stat")
    d.add_setting("nu", default=1 / 6, comment="plastic viscosity")
    d.add_setting("Velocity", default=0.0, zonal=True)
    d.add_setting("Pressure", default=0.0, zonal=True)
    d.add_setting("ForceX")
    d.add_setting("ForceY")
    d.add_setting("ForceZ")
    d.add_setting("YieldStress", default=0.0)
    # Flux/TotalRho are declared but never accumulated, as in the reference
    d.add_global("Flux", unit="m3/s")
    d.add_global("TotalRho", unit="kg")
    for pl in PLANES:
        for gname in ("vx", "vy", "vz", "rho1", "rho2", "area"):
            d.add_global(pl + gname)
    for nt in ("SymmetryY", "SymmetryZ",
               "NVelocity_ZouHe", "SVelocity_ZouHe", "EVelocity_ZouHe",
               "WVelocity_ZouHe", "NPressure_ZouHe", "SPressure_ZouHe",
               "EPressure_ZouHe", "WPressure_ZouHe"):
        d.add_node_type(nt, "BOUNDARY")
    for nt in ("XYslice1", "XZslice1", "YZslice1",
               "XYslice2", "XZslice2", "YZslice2"):
        d.add_node_type(nt, "ADDITIONALS")
    return d


def _zou_he_3d(ctx: NodeCtx, f, axis: int, side: int, kind: str):
    """d3q27 Zou/He on an axis-normal face: ``side=+1`` where the fluid
    lies in +axis.  The velocity kind imposes the zonal ``Velocity`` as
    the +axis velocity, the pressure kind ``rho = 1 + 3 Pressure``; the
    tangential momentum J_t = -3 x the wall-parallel knowns' zeroes the
    face's tangential momentum."""
    en = E[:, axis]
    s_t = lbm.edot((en == 0).astype(float), f)
    s_i = lbm.edot((en == -side).astype(float), f)
    if kind == "velocity":
        v = ctx.setting("Velocity")
        rho = (s_t + 2.0 * s_i) / (1.0 - side * v)
        jn = v * rho
    else:
        rho = 1.0 + 3.0 * ctx.setting("Pressure")
        jn = (s_t + 2.0 * s_i - rho) / (-side)
    jt = {t: -3.0 * lbm.edot(np.where(en == 0, E[:, t], 0), f)
          for t in range(3) if t != axis}
    out = [f[i] for i in range(27)]
    for i in np.where(en == side)[0]:
        ej = float(E[i, axis]) * jn
        for t, val in jt.items():
            if E[i, t]:
                ej = ej + float(E[i, t]) * val
        out[i] = f[int(OPP[i])] + 6.0 * float(W[i]) * ej
    return torch.stack(out)


def _collision(ctx: NodeCtx, f):
    """The stress-projection collision of every node, the slice monitors,
    and ``nu_app`` and ``yield_stat``."""
    rho = lbm.edot(np.ones(27), f)
    fx, fy, fz = (ctx.setting(n) for n in ("ForceX", "ForceY", "ForceZ"))
    ux = lbm.edot(E[:, 0], f) / rho + fx * 0.5
    uy = lbm.edot(E[:, 1], f) / rho + fy * 0.5
    uz = lbm.edot(E[:, 2], f) / rho + fz * 0.5
    usq = ux * ux + uy * uy + uz * uz
    phi, feq = [], []
    for i in range(27):
        ex, ey, ez = (float(v) for v in E[i])
        ef = ex * fx + ey * fy + ez * fz
        p = 3.0 * float(W[i]) * rho * ef if (ex or ey or ez) \
            else torch.zeros_like(rho)
        eu = ex * ux + ey * uy + ez * uz
        fe = float(W[i]) * rho * (1.0 + 3.0 * eu * (1.0 + 1.5 * eu)
                                  - 1.5 * usq) - 0.5 * p
        phi.append(p)
        feq.append(fe)
    # the non-equilibrium momentum flux, deviatoric
    S = {}
    for a, b in PAIRS:
        s = None
        for i in range(27):
            c = float(E[i, a] * E[i, b])
            if c == 0.0:
                continue
            t = c * (f[i] - feq[i])
            s = t if s is None else s + t
        S[(a, b)] = s
    tr3 = (S[(0, 0)] + S[(1, 1)] + S[(2, 2)]) / 3.0
    for a in range(3):
        S[(a, a)] = S[(a, a)] - tr3
    scontr = None
    for a, b in PAIRS:
        t = (1.0 if a == b else 2.0) * S[(a, b)] * S[(a, b)]
        scontr = t if scontr is None else scontr + t
    y = ctx.setting("YieldStress")
    nu = ctx.setting("nu")
    omega = 1.0 / (3.0 * nu + 0.5)
    unyielded = scontr < 2.0 * y * y
    safe = torch.where(scontr > 0, scontr, torch.ones_like(scontr))
    sq2s = torch.sqrt(2.0 / safe)
    c_bgk = (6.0 * nu - 1.0) / (6.0 * nu + 1.0)
    c = torch.where(y < 1e-15, c_bgk, c_bgk + sq2s * y * omega)
    scale = torch.where(unyielded, torch.ones_like(c), c)
    nu_app = torch.where(unyielded, torch.zeros_like(sq2s), nu + y / sq2s)
    yield_stat = unyielded.to(rho.dtype)
    out = []
    for i in range(27):
        quad = None
        for a, b in PAIRS:
            cc = int(E[i, a] * E[i, b]) * (1 if a == b else 2)
            if cc == 0:
                continue
            t = float(cc) * S[(a, b)]
            quad = t if quad is None else quad + t
        coef = 4.5 * float(W[i]) * quad * scale if quad is not None \
            else torch.zeros_like(rho)
        out.append(coef + feq[i] + phi[i])
    # the slice monitors (reference Dynamics.c:540-578)
    for pl in PLANES:
        s1 = ctx.nt_is(pl + "slice1")
        ctx.add_global(pl + "vx", ux, where=s1)
        ctx.add_global(pl + "vy", uy, where=s1)
        ctx.add_global(pl + "vz", uz, where=s1)
        ctx.add_global(pl + "rho1", rho, where=s1)
        ctx.add_global(pl + "area", torch.ones_like(rho), where=s1)
        ctx.add_global(pl + "rho2", rho, where=ctx.nt_is(pl + "slice2"))
    return torch.stack(out), nu_app, yield_stat


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = ctx.boundary_case(f, {
        "EPressure_ZouHe": lambda f: _zou_he_3d(ctx, f, 0, -1, "pressure"),
        "WPressure_ZouHe": lambda f: _zou_he_3d(ctx, f, 0, +1, "pressure"),
        "SPressure_ZouHe": lambda f: _zou_he_3d(ctx, f, 1, +1, "pressure"),
        "NPressure_ZouHe": lambda f: _zou_he_3d(ctx, f, 1, -1, "pressure"),
        "WVelocity_ZouHe": lambda f: _zou_he_3d(ctx, f, 0, +1, "velocity"),
        "NVelocity_ZouHe": lambda f: _zou_he_3d(ctx, f, 1, -1, "velocity"),
        "SVelocity_ZouHe": lambda f: _zou_he_3d(ctx, f, 1, +1, "velocity"),
        "EVelocity_ZouHe": lambda f: _zou_he_3d(ctx, f, 0, -1, "velocity"),
        "SymmetryY": lambda f: lbm.perm(f, mirror_perm(E, 1)),
        "SymmetryZ": lambda f: lbm.perm(f, mirror_perm(E, 2)),
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
    })
    fc, nu_app, yield_stat = _collision(ctx, f)
    coll = ctx.nt_is("MRT")
    return ctx.store({
        "f": torch.where(coll[None], fc, f),
        "nu_app": torch.where(coll, nu_app, ctx.density("nu_app")),
        "yield_stat": torch.where(coll, yield_stat,
                                  ctx.density("yield_stat"))})


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    rho = torch.broadcast_to(torch.as_tensor(
        1.0 + 3.0 * ctx.setting("Pressure"), dtype=dt, device=dev), shape)
    zero = torch.zeros(shape, dtype=dt, device=dev)
    f = lbm.equilibrium(E, W, rho, (zero, zero, zero))
    return ctx.store({"f": f, "nu_app": zero, "yield_stat": zero})


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    return torch.stack([(lbm.edot(E[:, a], f) + 0.5 * ctx.setting(n)) / rho
                        for a, n in enumerate(("ForceX", "ForceY",
                                               "ForceZ"))])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={
            "P": lambda c: (torch.sum(c.group("f"), dim=0) - 1.0) / 3.0,
            "U": get_u,
            "nu_app": lambda c: c.density("nu_app"),
            "yield_stat": lambda c: c.density("yield_stat"),
        })
