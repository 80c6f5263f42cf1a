"""Synthetic inflow turbulence: divergence-free random Fourier modes with a
von Karman spectrum.

The port's own copy of the JAX package's ``utils/turbulence.py`` (numpy
only, the same ``np.random.default_rng(seed)`` draws, so both packages
produce the same modes).  Each mode carries a unit wavevector ``k``, an
amplitude vector ``a`` orthogonal to ``k`` (so the field is
divergence-free) and a wavenumber ``w``; the fluctuation at ``x`` is
``sum_j sin(w k.x) a + cos(w k.x) (k x a)``.

The modes are drawn anew per handler segment (between callback events),
not per iteration, and the SynthT planes follow the variance-exact n-step
AR(1) update ``S' = k_aa^n S + sqrt(1 - k_aa^(2n)) u`` with ``k_aa =
exp(-1/TimeWN)`` (``control/solver.py:update_synthetic_turbulence``): the
same stationary variance and correlation time as a per-iteration update,
with a fluctuation that is constant within a segment.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

# von Karman spectrum constant
_VK_C = 0.9685081


class SyntheticTurbulence:
    """Host-side spectrum + mode generator (reference class of the same
    name).  Wavenumbers/amplitudes are set once by :meth:`set_von_karman`
    or :meth:`set_one_wave`; :meth:`generate` draws fresh random
    directions; :meth:`evaluate` renders the fluctuation field."""

    def __init__(self, seed: int = 0):
        self.wavenumbers = np.zeros(0)
        self.amplitudes = np.zeros(0)
        self.time_wn = 0.0
        self.energy_fraction = 0.0
        self.rng = np.random.default_rng(seed)

    @property
    def nmodes(self) -> int:
        return len(self.wavenumbers)

    def set_von_karman(self, main_wn: float, diff_wn: float,
                       min_wn: float, max_wn: float, nmodes: int = 100
                       ) -> float:
        """Even spread of ``nmodes`` wavenumbers over [min_wn, max_wn] with
        von Kármán amplitudes (reference setVonKarman,
        src/SyntheticTurbulence.cpp:96-118).  Returns the resolved energy
        fraction (the reference warns below 70/80%)."""
        dl = (max_wn - min_wn) / nmodes
        wn = min_wn + dl * (np.arange(nmodes) + 0.5)
        le, ld = main_wn, diff_wn
        e = (_VK_C / le * (wn / le) ** 4
             / (1.0 + (wn / le) ** 2) ** (17.0 / 6.0)
             * np.exp(-2.0 * (wn / ld) ** 2))
        self.wavenumbers = wn
        self.amplitudes = np.sqrt(e * dl)
        self.energy_fraction = float((self.amplitudes ** 2).sum())
        return self.energy_fraction

    def set_one_wave(self, wn: float) -> None:
        self.wavenumbers = np.array([wn])
        self.amplitudes = np.array([1.0])
        self.energy_fraction = 1.0

    def set_time_scale(self, time_wn: float) -> None:
        self.time_wn = float(time_wn)

    def ar1_factor(self, steps: int = 1) -> float:
        """AR(1) memory over ``steps`` iterations: k_aa^steps with
        ``k_aa = exp(-1/TimeWN)`` (reference WVelocityTurbulent)."""
        if self.time_wn <= 0:
            return 0.0
        return math.exp(-steps / self.time_wn)

    def generate(self) -> np.ndarray:
        """Fresh random mode set: rows (kx,ky,kz, ax,ay,az, wn) — the
        reference's Generate() (src/SyntheticTurbulence.cpp:47-68): k is a
        random unit vector, a is a random Gaussian vector orthogonalized
        against k and scaled to the mode amplitude."""
        n = self.nmodes
        k = self.rng.normal(size=(n, 3))
        k /= np.linalg.norm(k, axis=1, keepdims=True)
        a = self.rng.normal(size=(n, 3))
        a -= k * (a * k).sum(axis=1, keepdims=True)
        norm = np.linalg.norm(a, axis=1, keepdims=True)
        norm[norm == 0] = 1.0
        a *= self.amplitudes[:, None] / norm
        return np.concatenate([k, a, self.wavenumbers[:, None]], axis=1)

    def evaluate(self, shape, modes: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        """Fluctuation velocity field over a lattice of ``shape`` (index
        order z,y,x / y,x): (3, *shape) with components (ux, uy, uz) —
        the reference device evaluator ``calc()``
        (src/SyntheticTurbulence.h:90-108)."""
        if modes is None:
            modes = self.generate()
        shape = tuple(int(s) for s in shape)
        grids = np.meshgrid(*[np.arange(s, dtype=np.float64)
                              for s in shape], indexing="ij")
        # physical coords (x, y, z) from index order (..., y, x)
        coords = [grids[-1], grids[-2] if len(shape) > 1 else 0.0,
                  grids[-3] if len(shape) > 2 else 0.0]
        out = np.zeros((3,) + shape)
        for k1, k2, k3, a1, a2, a3, wn in modes:
            w = (k1 * coords[0] + k2 * coords[1] + k3 * coords[2]) * wn
            sw, cw = np.sin(w), np.cos(w)
            out[0] += sw * a1 + cw * (k2 * a3 - k3 * a2)
            out[1] += sw * a2 + cw * (k3 * a1 - k1 * a3)
            out[2] += sw * a3 + cw * (k1 * a2 - k2 * a1)
        return out
