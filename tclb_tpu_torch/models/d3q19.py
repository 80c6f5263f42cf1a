"""d3q19 — 3D MRT.

The port's counterpart of the JAX package's ``models/d3q19.py``: the
19-velocity MRT with velocity/pressure faces on W/E, N/S symmetry and a
body force.  The moment basis is built numerically by Gram-Schmidt over
the monomials (``lbm.gram_schmidt_basis``); the conserved moments are
untouched, the six stress moments relax with ``omega``, the higher ones
with ``S_high`` (``lbm.two_rate_relax``).  ``d3q19_adj`` takes its
velocity set, weights, bounce-back pairs and basis from here.  At f32 on
the card it runs on the z-slab kernels (``ops/d3q27_kernels.py``, built
for d3q19); the plain versions of those kernels share :func:`relax`.  The
JAX package's two ``lbm.pin`` seams only steer XLA's fusion and have no
counterpart.
"""

from __future__ import annotations

import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.models import family
from tclb_tpu_torch.ops import lbm

E = lbm.d3q19_velocities()
W = lbm.weights(E)
OPP = lbm.opposite(E)
M = lbm.gram_schmidt_basis(E)
STRESS = (4, 10)      # the rows of M that relax with omega


def _def():
    d = family.base_def("d3q19", E, "3D MRT", faces="WE", symmetries="NS")
    d.add_setting("S_high", default=1.0,
                  comment="relaxation rate of the higher moments")
    return d


def plane_sum(f: torch.Tensor) -> torch.Tensor:
    """``f[0] + f[1] + ...`` in plane order (the device header repeats
    this order)."""
    return lbm.edot([1.0] * len(f), f)


def macroscopic(f: torch.Tensor):
    """``rho`` and the velocity tuple of a population stack."""
    rho = plane_sum(f)
    return rho, tuple(lbm.edot(E[:, a], f) / rho for a in range(3))


def relax(f: torch.Tensor, omega, s_high, force) -> torch.Tensor:
    """Two-rate MRT: the stress moments relax with ``omega``, the rest
    with ``s_high``, then the equilibrium at the velocity shifted by
    ``force = (gx, gy, gz)``."""
    rho, u = macroscopic(f)
    feq = lbm.equilibrium(E, W, rho, u)
    fneq = [f[k] - feq[k] for k in range(19)]
    kept = lbm.two_rate_relax(M, *STRESS, fneq, 1.0 - omega, 1.0 - s_high)
    u2 = tuple(u[a] + force[a] for a in range(3))
    return kept + lbm.equilibrium(E, W, rho, u2)


def collide(ctx: NodeCtx, f: torch.Tensor) -> torch.Tensor:
    """:func:`relax` at the node's settings and gravity."""
    return relax(f, ctx.setting("omega"), ctx.setting("S_high"),
                 family.gravity_of(ctx))


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    f = family.apply_boundaries(ctx, f, E, W, OPP)
    family.add_flux_objectives(ctx, f, E)
    f = torch.where(ctx.nt_in_group("COLLISION")[None], collide(ctx, f), f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    return family.standard_init(ctx, E, W)


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities=family.make_getters(E, force_of=family.gravity_of))
