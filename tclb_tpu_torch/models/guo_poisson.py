"""Guo's Poisson-equation LBM solver, as ``d2q9_npe_guo`` uses it.

The port's own copy of the JAX package's ``models/guo_poisson.py``
(reference src/d2q9_npe_guo/Dynamics.c.Rt:28-30): the solver population
``g`` relaxes toward ``wp_i psi`` with ``wp = (1/9 - 1, 1/9 x 8)`` (a
negative rest weight) and the source ``dt wps RD``, ``RD = -(2/3)(1/2 -
tau_psi) dt rho_e / epsilon`` (dt in both factors, as the reference has
it).  The potential reads back as ``psi = sum_{i>0} g_i / (1 - wp0)``.
"""

from __future__ import annotations

import numpy as np
import torch

WP0 = 1.0 / 9.0
WP = np.array([1.0 / 9.0 - 1.0] + [1.0 / 9.0] * 8)
WPS = np.array([0.0] + [1.0 / 8.0] * 8)


def psi_of(g) -> torch.Tensor:
    """The potential of the solver populations (reference getPsi)."""
    return sum(g[i] for i in range(1, 9)) / (1.0 - WP0)


def collide(g, psi, rho_e, tau_psi, dt, epsilon) -> torch.Tensor:
    """One Guo Poisson sweep: ``g' = g - (g - wp psi) / tau + dt wps RD``."""
    rd = -2.0 / 3.0 * (0.5 - tau_psi) * dt * rho_e / epsilon
    return torch.stack([
        g[i] - (g[i] - float(WP[i]) * psi) / tau_psi
        + (dt * float(WPS[i])) * rd if WPS[i]
        else g[i] - (g[i] - float(WP[i]) * psi) / tau_psi
        for i in range(9)])
