"""d2q9_new — raw-moment MRT with Smagorinsky LES and an entropic (KBC)
stabilizer.

The port's counterpart of the JAX package's ``models/d2q9_new.py``, op for
op on PyTorch tensors.  Monomial-moment MRT: moments of order <= 2 relax at
``gamma = 1 - omega``, higher ones at ``gamma2``; two optional per-node
modes:

* ``Smagorinsky`` (LES group): eddy viscosity from the second-order
  non-equilibrium moments, ``Q = 18 sqrt(max(sum m_neq,2^2, 0)) Smag``,
  ``tau = (tau0 + sqrt(tau0^2 + Q)) / 2``;
* ``Stab`` (ENTROPIC group): KBC-style ``gamma2 = -gamma a / b`` with
  ``a = ds.P.dh``, ``b = dh.P.dh`` in the H-norm metric
  ``P = Minv^T diag(1/w) Minv``, and ``-gamma (-1)`` where
  ``|b| <= 1e-30``; the ratio is the ``A`` quantity.

Shear-layer initialization (SL_* settings); d2q9's Zou/He faces with the
boundary density ``1 + 3 Pressure`` (the model has no Density setting); no
body force and no BC coupling planes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import NodeCtx
from tclb_tpu_torch.core.registry import ModelDef
from tclb_tpu_torch.models.d2q9 import E, _zou_he_x
from tclb_tpu_torch.ops import lbm

W = lbm.weights(E)
OPP = lbm.opposite(E)

# monomial moment basis m_pq = sum_i e_x^p e_y^q f_i, polynomial order p+q
POLYS = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2),
         (2, 1), (1, 2), (2, 2)]
ORDER = np.array([p + q for p, q in POLYS])
M = np.stack([E[:, 0].astype(np.float64) ** p
              * E[:, 1].astype(np.float64) ** q for p, q in POLYS])
MINV = np.linalg.inv(M)
# H-norm metric on moment perturbations: dm.P.dm = sum_i (df_i)^2 / w_i
P_MAT = MINV.T @ np.diag(1.0 / W) @ MINV


def _def() -> ModelDef:
    d = ModelDef("d2q9_new", ndim=2,
                 description="raw-moment MRT with LES + entropic stabilizer")
    d.add_densities("f", E)
    d.add_quantity("Rho", unit="kg/m3")
    d.add_quantity("U", unit="m/s", vector=True)
    d.add_quantity("A", unit="1", vector=True)
    d.add_setting("omega", comment="one over relaxation time")
    d.add_setting("nu", default=1 / 6,
                  derived={"omega": lambda nu: 1.0 / (3 * nu + 0.5)})
    d.add_setting("Velocity", default=0.0, zonal=True)
    d.add_setting("Pressure", default=0.0, zonal=True)
    d.add_setting("Smag", comment="Smagorinsky constant")
    d.add_setting("SL_U", comment="shear layer velocity")
    d.add_setting("SL_lambda", comment="shear layer steepness")
    d.add_setting("SL_delta", comment="shear layer disturbance")
    d.add_setting("SL_L", comment="shear layer length scale (0 = off)")
    d.add_global("PressureLoss", unit="1mPa")
    d.add_global("OutletFlux", unit="1m2/s")
    d.add_global("InletFlux", unit="1m2/s")
    d.add_node_type("Smagorinsky", "LES")
    d.add_node_type("Stab", "ENTROPIC")
    return d


def _moments(f):
    return [sum(float(M[r, i]) * f[i] for i in range(9) if M[r, i])
            for r in range(9)]


def _neq_split(f):
    m = _moments(f)
    rho = m[0]
    feq = lbm.equilibrium(E, W, rho, (m[1] / rho, m[2] / rho))
    meq = _moments(feq)
    neq = [m[r] - meq[r] for r in range(9)]
    return rho, meq, neq


def _hquad(u, v, rho):
    """u.P.v over moment vectors whose None entries are zero."""
    acc = None
    for r in range(9):
        if u[r] is None:
            continue
        for c in range(9):
            if v[c] is None or P_MAT[r, c] == 0.0:
                continue
            t = float(P_MAT[r, c]) * u[r] * v[c]
            acc = t if acc is None else acc + t
    return acc if acc is not None else torch.zeros_like(rho)


def _entropic_ab(neq, rho):
    ds = [neq[r] if ORDER[r] == 2 else None for r in range(9)]
    dh = [neq[r] if ORDER[r] > 2 else None for r in range(9)]
    return _hquad(ds, dh, rho), _hquad(dh, dh, rho)


def collision_core(f, omega, smag, smag_mask, stab_mask) -> torch.Tensor:
    """The raw-moment MRT with the per-node Smagorinsky mode and the
    entropic stabilizer, a function of planes and masks only: the eager
    model and the plain versions of the kernels share it."""
    rho, meq, neq = _neq_split(f)
    gamma = 1.0 - omega

    q2 = sum(neq[r] * neq[r] for r in range(9) if ORDER[r] == 2)
    qs = 18.0 * torch.sqrt(torch.clamp_min(q2, 0.0)) * smag
    tau0 = 1.0 / (1.0 - gamma)
    tau = 0.5 * (torch.sqrt(tau0 * tau0 + qs) + tau0)
    gamma_eff = torch.where(smag_mask, 1.0 - 1.0 / tau, gamma)

    a, b = _entropic_ab(neq, rho)
    big = torch.abs(b) > 1e-30
    safe_b = torch.where(big, b, torch.ones_like(b))
    gamma_ent = -gamma_eff * torch.where(big, a / safe_b,
                                         -torch.ones_like(b))
    gamma2 = torch.where(stab_mask, gamma_ent, gamma_eff)

    out_m = []
    for r in range(9):
        if ORDER[r] <= 1:
            out_m.append(meq[r])
        elif ORDER[r] == 2:
            out_m.append(meq[r] + gamma_eff * neq[r])
        else:
            out_m.append(meq[r] + gamma2 * neq[r])
    return torch.stack([
        sum(float(MINV[i, r]) * out_m[r] for r in range(9) if MINV[i, r])
        for i in range(9)])


def boundary_cases(vel, den) -> dict:
    """d2q9's explicit Zou/He list with bounce-back, in the model's order;
    ``den`` is the boundary density ``1 + 3 Pressure``."""
    return {
        ("Wall", "Solid"): lambda f: lbm.perm(f, OPP),
        "EVelocity": lambda f: _zou_he_x(f, vel, "velocity", "E"),
        "WPressure": lambda f: _zou_he_x(f, den, "pressure", "W"),
        "WVelocity": lambda f: _zou_he_x(f, vel, "velocity", "W"),
        "EPressure": lambda f: _zou_he_x(f, den, "pressure", "E"),
    }


def run(ctx: NodeCtx) -> dict:
    f = ctx.group("f")
    den = 1.0 + 3.0 * ctx.setting("Pressure")
    f = ctx.boundary_case(f, boundary_cases(ctx.setting("Velocity"), den))
    fc = collision_core(f, ctx.setting("omega"), ctx.setting("Smag"),
                        ctx.nt_is("Smagorinsky"), ctx.nt_is("Stab"))
    f = torch.where(ctx.nt_is("MRT")[None], fc, f)
    return ctx.store({"f": f})


def init(ctx: NodeCtx) -> dict:
    """Uniform or double-shear-layer equilibrium."""
    shape = tuple(ctx.flags.shape)
    dt, dev = ctx._fields.dtype, ctx._fields.device
    rho = torch.broadcast_to(
        torch.as_tensor(1.0 + 3.0 * ctx.setting("Pressure"), dtype=dt,
                        device=dev), shape)
    sl_l = ctx.setting("SL_L")
    y = torch.broadcast_to(
        torch.arange(shape[0], dtype=dt, device=dev)[:, None], shape)
    x = torch.broadcast_to(
        torch.arange(shape[1], dtype=dt, device=dev)[None, :], shape)
    on = sl_l > 0
    safe_l = torch.where(on, sl_l, torch.ones_like(sl_l))
    ux_sl = torch.where(
        y < safe_l / 2,
        ctx.setting("SL_U") * torch.tanh(
            ctx.setting("SL_lambda") * (y / safe_l - 0.25)),
        ctx.setting("SL_U") * torch.tanh(
            ctx.setting("SL_lambda") * (0.75 - y / safe_l)))
    uy_sl = (ctx.setting("SL_delta") * ctx.setting("SL_U")
             * torch.sin(2.0 * math.pi * (x / safe_l + 0.25)))
    zero = torch.zeros(shape, dtype=dt, device=dev)
    ux = torch.where(on, ux_sl, zero) + ctx.setting("Velocity")
    uy = torch.where(on, uy_sl, zero)
    return ctx.store({"f": lbm.equilibrium(E, W, rho, (ux, uy))})


def get_a(ctx: NodeCtx) -> torch.Tensor:
    """The entropic diagnostic (a/b, a, b)."""
    rho, _, neq = _neq_split(ctx.group("f"))
    a, b = _entropic_ab(neq, rho)
    safe = torch.where(torch.abs(b) > 1e-30, b, torch.ones_like(b))
    return torch.stack([a / safe, a, b])


def get_u(ctx: NodeCtx) -> torch.Tensor:
    f = ctx.group("f")
    rho = torch.sum(f, dim=0)
    ux = lbm.edot(E[:, 0], f) / rho
    uy = lbm.edot(E[:, 1], f) / rho
    return torch.stack([ux, uy, torch.zeros_like(ux)])


def build():
    return _def().finalize().bind(
        run=run, init=init,
        quantities={"Rho": lambda c: torch.sum(c.group("f"), dim=0),
                    "U": get_u, "A": get_a})
