"""Shared model-building blocks for the standard hydrodynamic families.

The port's counterpart of the JAX package's ``models/family.py``.  Every
standard model repeats one skeleton: f-densities over a velocity set,
Rho/U getters, zonal Velocity/Density settings, a boundary ``switch``
with bounce-back / non-equilibrium bounce-back faces / symmetry mirrors,
then a collision.  :func:`base_def` declares the common registry entries
and :func:`boundary_cases` builds the boundary dispatch from whatever
boundary node types the model declares; the eager engine and the plain
versions of the kernels dispatch the same cases.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.ops import lbm

# face name -> (E-column axis, side): side +1 = fluid lies toward +axis
FACES = {
    "W": (0, +1), "E": (0, -1),
    "S": (1, +1), "N": (1, -1),
    "B": (2, +1), "T": (2, -1),
}


def mirror_perm(E: np.ndarray, axis: int) -> np.ndarray:
    """Population permutation mirroring velocity component ``axis``."""
    Em = E.copy()
    Em[:, axis] = -Em[:, axis]
    perm = np.zeros(len(E), dtype=np.int32)
    for i, e in enumerate(Em):
        (j,) = np.where((E == e).all(axis=1))
        perm[i] = j[0]
    return perm


def base_def(name: str, E: np.ndarray, description: str = "",
             faces: str = "WE", symmetries: str = "",
             objectives: bool = True) -> ModelDef:
    """Common registry skeleton: f densities, Rho/U quantities,
    nu/Velocity/Density settings, gravity, in/outlet flux objectives.

    ``faces`` lists the faces with Velocity/Pressure BCs; W/E reuse the
    default node types, the others add <F>Velocity/<F>Pressure types.
    ``symmetries`` adds <F>Symmetry mirror types."""
    ndim = E.shape[1]
    d = ModelDef(name, ndim=ndim, description=description or name)
    d.add_densities("f", E)
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_setting("nu", default=1 / 6, comment="viscosity",
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("omega", default=1.0, comment="one over relaxation time")
    d.add_setting("Velocity", default=0.0, zonal=True,
                  comment="inlet/outlet/init velocity")
    d.add_setting("Density", default=1.0, zonal=True,
                  comment="inlet/outlet/init density")
    for ax in ("X", "Y", "Z")[:ndim]:
        d.add_setting(f"Gravitation{ax}")
    if objectives:
        d.add_global("PressureLoss", unit="1mPa")
        d.add_global("OutletFlux", unit="1m2/s")
        d.add_global("InletFlux", unit="1m2/s")
    for face in faces:
        if face not in "WE":   # WVelocity/EPressure/... are defaults
            d.add_node_type(f"{face}Velocity", "BOUNDARY")
            d.add_node_type(f"{face}Pressure", "BOUNDARY")
    for face in symmetries:
        d.add_node_type(f"{face}Symmetry", "BOUNDARY")
    return d


def boundary_cases(model, E: np.ndarray, W: np.ndarray, OPP: np.ndarray,
                   vel, den, extra: Optional[dict] = None) -> dict:
    """The ordered case dict for every boundary node type the model
    declares: Wall/Solid bounce-back, <F>Velocity / <F>Pressure faces by
    non-equilibrium bounce-back, <F>Symmetry mirrors.  ``vel``/``den`` are
    the (zonal) Velocity/Density values, planes or scalars."""
    cases: dict = {("Wall", "Solid"): lambda f: lbm.perm(f, OPP)}
    known = model.node_types
    for face, (axis, side) in FACES.items():
        if axis >= E.shape[1]:
            continue
        vname, pname = f"{face}Velocity", f"{face}Pressure"
        if vname in known:
            # vel is the signed +axis component on every face, as the
            # reference's ZouHe takes it
            cases[vname] = (lambda f, a=axis, s=side:
                            lbm.nebb_boundary(E, W, OPP, f, a, s,
                                              "velocity", vel))
        if pname in known:
            cases[pname] = (lambda f, a=axis, s=side:
                            lbm.nebb_boundary(E, W, OPP, f, a, s,
                                              "pressure", den))
        sname = f"{face}Symmetry"
        if sname in known:
            perm = mirror_perm(E, axis)
            cases[sname] = lambda f, p=perm: lbm.perm(f, p)
    # legacy d2q9 names for y-mirrors
    for nm, axis in (("TopSymmetry", 1), ("BottomSymmetry", 1)):
        if nm in known and axis < E.shape[1]:
            perm = mirror_perm(E, axis)
            cases[nm] = lambda f, p=perm: lbm.perm(f, p)
    if extra:
        cases.update(extra)
    return cases


def apply_boundaries(ctx: NodeCtx, f: torch.Tensor, E: np.ndarray,
                     W: np.ndarray, OPP: np.ndarray,
                     extra: Optional[dict] = None) -> torch.Tensor:
    """Mask-dispatch the :func:`boundary_cases` of the model."""
    si = ctx.model.setting_index
    vel = ctx.setting("Velocity") if "Velocity" in si else 0.0
    den = ctx.setting("Density") if "Density" in si else 1.0
    cases = boundary_cases(ctx.model, E, W, OPP, vel, den, extra)
    return ctx.boundary_case(f, cases)


def add_flux_objectives(ctx: NodeCtx, f: torch.Tensor, E: np.ndarray
                        ) -> None:
    """Inlet/Outlet flux + pressure-loss globals on OBJECTIVE-tagged
    collision nodes."""
    if "OutletFlux" not in ctx.model.global_index:
        return
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    usq = ux * ux + uy * uy
    if E.shape[1] == 3:
        uz = lbm.edot(E[:, 2], f) / rho
        usq = usq + uz * uz
    coll = ctx.nt_in_group("COLLISION")
    ploss = ux / rho * ((rho - 1.0) / 3.0 + usq / rho * 0.5)
    ctx.add_global("OutletFlux", ux / rho, where=ctx.nt_is("Outlet") & coll)
    ctx.add_global("InletFlux", ux / rho, where=ctx.nt_is("Inlet") & coll)
    ctx.add_global("PressureLoss",
                   torch.where(ctx.nt_is("Inlet"), ploss, -ploss),
                   where=(ctx.nt_is("Inlet") | ctx.nt_is("Outlet")) & coll)


def standard_init(ctx: NodeCtx, E: np.ndarray, W: np.ndarray,
                  extra: Optional[dict] = None) -> dict:
    """Equilibrium init from the zonal Density/Velocity settings."""
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    ndim = E.shape[1]

    def plane(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dt, device=dev),
                                  shape)

    rho = plane(ctx.setting("Density"))
    ux = plane(ctx.setting("Velocity"))
    u = (ux,) + tuple(torch.zeros(shape, dtype=dt, device=dev)
                      for _ in range(ndim - 1))
    groups = {"f": lbm.equilibrium(E, W, rho, u)}
    if extra:
        groups.update(extra)
    return ctx.store(groups)


def make_getters(E: np.ndarray, force_of=None) -> dict[str, Callable]:
    """Rho and U quantity getters; ``force_of(ctx)`` (acceleration tuple)
    shifts the measured U by half the force."""

    def get_rho(ctx: NodeCtx) -> torch.Tensor:
        return torch.sum(ctx.group("f"), dim=0)

    def get_u(ctx: NodeCtx) -> torch.Tensor:
        f = ctx.group("f")
        rho = torch.sum(f, dim=0)
        comps = [lbm.edot(E[:, a], f) / rho for a in range(E.shape[1])]
        if force_of is not None:
            comps = [c + 0.5 * g for c, g in zip(comps, force_of(ctx))]
        while len(comps) < 3:
            comps.append(torch.zeros_like(comps[0]))
        return torch.stack(comps)

    return {"Rho": get_rho, "U": get_u}


def dispatch_boundary_cases(cases: dict, f: torch.Tensor, mask_of,
                            present: Optional[set] = None) -> torch.Tensor:
    """Mask-dispatch a :func:`boundary_cases` dict outside a ``NodeCtx``
    (the plain versions of the kernels): ``mask_of(name)`` yields the bool
    plane of a node type; cases whose types are all absent from
    ``present`` are skipped."""
    out = f
    for names, fn in cases.items():
        names = [n for n in ((names,) if isinstance(names, str) else names)
                 if present is None or n in present]
        if not names:
            continue
        m = mask_of(names[0])
        for n in names[1:]:
            m = m | mask_of(n)
        out = torch.where(m[None], fn(f), out)
    return out


def gravity_of(ctx: NodeCtx):
    """Acceleration tuple from the Gravitation* settings."""
    names = [f"Gravitation{a}" for a in ("X", "Y", "Z")]
    return tuple(ctx.setting(n) for n in names
                 if n in ctx.model.setting_index)
