"""d3q27_cumulant — the 3D cumulant model of the forced-channel family.

The port's counterpart of the JAX package's ``models/d3q27_cumulant.py``,
op for op on PyTorch tensors: Geier-style cumulant collision, zonal
Velocity/Density/Turbulence, ForceX/Y/Z body force, N/S symmetry plus
velocity/pressure faces, a turbulent-inlet node type fed by the coupling
densities ``SynthT{X,Y,Z}``, the volume-flux global, and running averages
of velocity and pressure (``average=True`` densities, reset by
``<Average>``).
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.ops import cumulant, lbm

E = cumulant.velocity_set(3)
W = lbm.weights(E)
OPP = lbm.opposite(E)


def _def():
    d = family.base_def("d3q27_cumulant", E, "3D cumulant collision",
                        faces="WENS", symmetries="NS", objectives=False)
    d.add_setting("nubuffer", default=0.01,
                  comment="viscosity in the buffer layer")
    d.add_setting("Turbulence", default=0.0, zonal=True,
                  comment="inlet turbulence intensity")
    d.add_setting("GalileanCorrection", default=1.0,
                  comment="Galilean correction term")
    d.add_setting("omega_bulk", default=1.0)
    for ax in ("X", "Y", "Z"):
        d.add_setting(f"Force{ax}")
    d.add_global("Flux", unit="m3/s", comment="volume flux")
    d.add_node_type("WVelocityTurbulent", "BOUNDARY")
    d.add_node_type("Buffer", "ADDITIONALS")
    # synthetic-turbulence coupling buffers
    d.add_density("SynthTX", group="SynthT")
    d.add_density("SynthTY", group="SynthT")
    d.add_density("SynthTZ", group="SynthT")
    d.add_quantity("P", unit="Pa")
    # running averages (the <Average> machinery)
    d.add_density("avgP", group="avg", average=True)
    d.add_density("avgUX", group="avgU", average=True)
    d.add_density("avgUY", group="avgU", average=True)
    d.add_density("avgUZ", group="avgU", average=True)
    d.add_quantity("avgU", unit="m/s", vector=True)
    d.add_quantity("averageP", unit="Pa")
    return d


def _force(ctx: NodeCtx):
    return tuple(ctx.setting(f"Force{ax}") + g for ax, g in
                 zip(("X", "Y", "Z"), family.gravity_of(ctx)))


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    vel = ctx.setting("Velocity")
    # turbulent inlet: mean + the SynthT fluctuation scaled by the zonal
    # Turbulence intensity; normal component on top of the mean,
    # tangential through the boundary's imposed tangential velocity
    turb = ctx.setting("Turbulence")
    turb_u = vel + turb * ctx.density("SynthTX")
    extra = {
        "WVelocityTurbulent": lambda f: lbm.nebb_boundary(
            E, W, OPP, f, 0, +1, "velocity", turb_u,
            vt={1: turb * ctx.density("SynthTY"),
                2: turb * ctx.density("SynthTZ")}),
    }
    f = family.apply_boundaries(ctx, f, E, W, OPP, extra=extra)

    shape = f.shape[1:]
    # the buffer layer runs at the nubuffer viscosity (sponge)
    om_buffer = 1.0 / (3.0 * ctx.setting("nubuffer") + 0.5)
    om = torch.where(ctx.nt_is("Buffer"), om_buffer, ctx.setting("omega"))
    F = f.reshape((3, 3, 3) + shape)
    Fp, rho, (ux, uy, uz) = cumulant.collide_d3q27(
        F, om, ctx.setting("omega_bulk"), force=_force(ctx),
        correlated=True, galilean=ctx.setting("GalileanCorrection"))
    coll = ctx.nt_in_group("COLLISION")
    f = torch.where(coll[None], Fp.reshape((27,) + shape), f)
    ctx.add_global("Flux", ux, where=coll)

    # running averages accumulate every step; <Average> resets them
    return ctx.store({
        "f": f,
        "avg": ((rho - 1.0) / 3.0)[None] + ctx.group("avg"),
        "avgU": torch.stack([ux, uy, uz]) + ctx.group("avgU"),
    })


def init(ctx: NodeCtx) -> dict:
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    return family.standard_init(
        ctx, E, W,
        extra={"SynthT": torch.zeros((3,) + shape, dtype=dt, device=dev),
               "avg": torch.zeros((1,) + shape, dtype=dt, device=dev),
               "avgU": torch.zeros((3,) + shape, dtype=dt, device=dev)})


def get_p(ctx: NodeCtx) -> torch.Tensor:
    return (torch.sum(ctx.group("f"), dim=0) - 1.0) / 3.0


def get_avg_u(ctx: NodeCtx) -> torch.Tensor:
    # samples since the last <Average> reset
    return ctx.group("avgU") / ctx.avg_samples()


def get_avg_p(ctx: NodeCtx) -> torch.Tensor:
    return ctx.density("avgP") / ctx.avg_samples()


def build():
    q = family.make_getters(E, force_of=_force)
    q.update({"P": get_p, "avgU": get_avg_u, "averageP": get_avg_p})
    return _def().finalize().bind(run=run, init=init, quantities=q)
