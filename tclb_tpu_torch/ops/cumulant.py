"""Cumulant collision on PyTorch tensors — the port's counterpart of the
JAX package's ``ops/cumulant.py`` (``collide_d3q27`` and ``collide_d2q9``).

The populations of the tensor-product {-1,0,1}^d velocity set reshape to a
``(3,)*d + shape`` tensor (axes x, y[, z]).  Raw moments are 3-wide
contractions with the Vandermonde of (-1, 0, 1); the collision relaxes the
second-order central moments and rebuilds every higher one from the relaxed
covariance (all cumulants above second order vanish), then shifts back and
inverts the contractions.  Op for op the JAX package's arithmetic: the same
sparse first decentralize pass and the same reshape order.
"""

from __future__ import annotations

import numpy as np
import torch

# velocity per tensor index: index 0,1,2 -> c = -1,0,+1
C = np.array([-1.0, 0.0, 1.0])
# Vandermonde T[p, i] = C[i]**p  (p = moment order 0,1,2)
T = np.stack([C ** 0, C ** 1, C ** 2])
T_INV = np.linalg.inv(T)


def velocity_set(ndim: int) -> np.ndarray:
    """Tensor-product velocity set in this module's reshape order:
    index (i, j[, k]) -> velocity (C[i], C[j][, C[k]]), x-axis first."""
    if ndim == 2:
        return np.array([(int(cx), int(cy))
                         for cx in C for cy in C], dtype=np.int32)
    return np.array([(int(cx), int(cy), int(cz))
                     for cx in C for cy in C for cz in C], dtype=np.int32)


def _contract_axis(F: torch.Tensor, mat: np.ndarray, axis: int
                   ) -> torch.Tensor:
    """out[..., p, ...] = sum_i mat[p, i] * F[..., i, ...] along ``axis``,
    unrolled over the static 3x3 matrix (entries 0/±1/±0.5)."""
    parts = [F.select(axis, i) for i in range(3)]
    outs = []
    for p in range(3):
        acc = None
        for i in range(3):
            c = float(mat[p, i])
            if c == 0.0:
                continue
            t = parts[i] if c == 1.0 else \
                (-parts[i] if c == -1.0 else c * parts[i])
            acc = t if acc is None else acc + t
        outs.append(acc if acc is not None else torch.zeros_like(parts[0]))
    return torch.stack(outs, dim=axis)


def _raw_moments(F: torch.Tensor, ndim: int) -> torch.Tensor:
    """m[p, q(, r)] = sum_ijk C_i^p C_j^q C_k^r F[i, j(, k)]."""
    for ax in range(ndim):
        F = _contract_axis(F, T, ax)
    return F


def _from_raw_moments(m: torch.Tensor, ndim: int) -> torch.Tensor:
    for ax in range(ndim):
        m = _contract_axis(m, T_INV, ax)
    return m


def _centralize(m: torch.Tensor, u, axis: int) -> torch.Tensor:
    """Raw -> central along one tensor axis: k_0 = m_0; k_1 = m_1 - u m_0;
    k_2 = m_2 - 2u m_1 + u^2 m_0."""
    m0, m1, m2 = (m.select(axis, p) for p in range(3))
    k0 = m0
    k1 = m1 - u * m0
    k2 = m2 - 2.0 * u * m1 + u * u * m0
    return torch.stack([k0, k1, k2], dim=axis)


def _decentralize(k: torch.Tensor, u, axis: int) -> torch.Tensor:
    """Central -> raw along one tensor axis: m_0 = k_0; m_1 = k_1 + u k_0;
    m_2 = k_2 + 2u k_1 + u^2 k_0."""
    k0, k1, k2 = (k.select(axis, p) for p in range(3))
    m0 = k0
    m1 = k1 + u * k0
    m2 = k2 + 2.0 * u * k1 + u * u * k0
    return torch.stack([m0, m1, m2], dim=axis)


def _moment_tensor(entries: dict, like: torch.Tensor, ndim: int
                   ) -> torch.Tensor:
    """A (3,)*ndim moment tensor from sparse {index: plane} entries
    (missing indices are zero planes)."""
    z = torch.zeros_like(like)
    if ndim == 2:
        return torch.stack(
            [torch.stack([entries.get((p, q), z) for q in range(3)])
             for p in range(3)])
    return torch.stack(
        [torch.stack(
            [torch.stack([entries.get((p, q, r), z) for r in range(3)])
             for q in range(3)])
         for p in range(3)])


def _low_moments_d3(F: torch.Tensor):
    """rho, the first-moment numerators and the six second-order raw
    moments — the only forward moments the cumulant collision consumes.
    Returns (rho, (jx, jy, jz), dict of m_pqr)."""
    x0, x1, x2 = F[0], F[1], F[2]
    s0 = x0 + x1 + x2
    s1 = x2 - x0
    s2 = x2 + x0
    out = {}
    for p, sx in ((0, s0), (1, s1), (2, s2)):
        y0, y1, y2 = sx[0], sx[1], sx[2]
        t0 = y0 + y1 + y2
        t1 = y2 - y0
        t2 = y2 + y0
        for q, sy in ((0, t0), (1, t1), (2, t2)):
            if p + q > 2:
                continue
            z0, z1, z2 = sy[0], sy[1], sy[2]
            out[(p, q, 0)] = z0 + z1 + z2
            if p + q <= 1:
                out[(p, q, 1)] = z2 - z0
            if p + q == 0:
                out[(p, q, 2)] = z2 + z0
    rho = out[(0, 0, 0)]
    return rho, (out[(1, 0, 0)], out[(0, 1, 0)], out[(0, 0, 1)]), out


def collide_d3q27(F: torch.Tensor, omega, omega_bulk=1.0,
                  force=(0.0, 0.0, 0.0), correlated: bool = True,
                  galilean=None):
    """Cumulant (``correlated=True``) or cascaded central-moment
    (``correlated=False``) collision of the ``(3, 3, 3, *shape)``
    population tensor.  ``force`` is an acceleration applied as a velocity
    shift in the back-transform; ``galilean`` (0..1) weights Geier's
    Galilean-invariance correction of the diagonal second-order
    relaxation.  Returns (F', rho, (ux, uy, uz))."""
    rho, (jx, jy, jz), m = _low_moments_d3(F)
    inv = 1.0 / rho
    ux = jx * inv
    uy = jy * inv
    uz = jz * inv

    # second-order central moments: mu_ab = m_ab - rho u_a u_b
    kxx = m[(2, 0, 0)] - jx * ux
    kyy = m[(0, 2, 0)] - jy * uy
    kzz = m[(0, 0, 2)] - jz * uz
    kxy = m[(1, 1, 0)] - jx * uy
    kxz = m[(1, 0, 1)] - jx * uz
    kyz = m[(0, 1, 1)] - jy * uz

    # relax: trace with omega_bulk, deviatoric + off-diagonal with omega,
    # through the a/b/cc combinations the Galilean correction acts on
    cxx, cyy, czz = kxx * inv, kyy * inv, kzz * inv
    a_c = (1.0 - omega) * (cxx - cyy)
    b_c = (1.0 - omega) * (cxx - czz)
    cc_c = omega_bulk + (1.0 - omega_bulk) * (cxx + cyy + czz)
    if galilean is not None:
        uxh = ux + 0.5 * force[0]
        uyh = uy + 0.5 * force[1]
        uzh = uz + 0.5 * force[2]
        dxu = -0.5 * omega * (2.0 * cxx - cyy - czz) \
            - 0.5 * omega_bulk * (cxx + cyy + czz - 1.0)
        dyv = dxu + 1.5 * omega * (cxx - cyy)
        dzw = dxu + 1.5 * omega * (cxx - czz)
        gc1 = 3.0 * (1.0 - 0.5 * omega) * (uxh * uxh * dxu
                                           - uyh * uyh * dyv)
        gc2 = 3.0 * (1.0 - 0.5 * omega) * (uxh * uxh * dxu
                                           - uzh * uzh * dzw)
        gc3 = 3.0 * (1.0 - 0.5 * omega_bulk) * (uxh * uxh * dxu
                                                + uyh * uyh * dyv
                                                + uzh * uzh * dzw)
        a_c = a_c - gc1 * galilean
        b_c = b_c - gc2 * galilean
        cc_c = cc_c - gc3 * galilean
    kxx_p = rho * (a_c + b_c + cc_c) / 3.0
    kyy_p = rho * (cc_c - 2.0 * a_c + b_c) / 3.0
    kzz_p = rho * (cc_c - 2.0 * b_c + a_c) / 3.0
    one_m = 1.0 - omega
    kxy_p, kxz_p, kyz_p = one_m * kxy, one_m * kxz, one_m * kyz

    z = torch.zeros_like(rho)
    if not correlated:
        # factorized equilibrium: higher moments of the uncorrelated
        # Gaussian (the cascaded central-moment MRT)
        g220 = kxx_p * kyy_p * inv
        g202 = kxx_p * kzz_p * inv
        g022 = kyy_p * kzz_p * inv
        g211 = z
        g121 = z
        g112 = z
        g222 = kxx_p * kyy_p * kzz_p * inv * inv
    else:
        # Isserlis closure on the full covariance
        g220 = (kxx_p * kyy_p + 2.0 * kxy_p * kxy_p) * inv
        g202 = (kxx_p * kzz_p + 2.0 * kxz_p * kxz_p) * inv
        g022 = (kyy_p * kzz_p + 2.0 * kyz_p * kyz_p) * inv
        g211 = (kxx_p * kyz_p + 2.0 * kxy_p * kxz_p) * inv
        g121 = (kyy_p * kxz_p + 2.0 * kxy_p * kyz_p) * inv
        g112 = (kzz_p * kxy_p + 2.0 * kxz_p * kyz_p) * inv
        g222 = (kxx_p * kyy_p * kzz_p
                + 2.0 * (kxx_p * kyz_p * kyz_p
                         + kyy_p * kxz_p * kxz_p
                         + kzz_p * kxy_p * kxy_p)
                + 8.0 * kxy_p * kxz_p * kyz_p) * inv * inv

    ux2 = ux + force[0]
    uy2 = uy + force[1]
    uz2 = uz + force[2]
    # first (x-axis) decentralize pass on the 14 nonzero post-collision
    # central moments only (odd axis powers of a zero-mean Gaussian vanish)
    u, uu = ux2, ux2 * ux2
    mx = {
        (0, 0, 0): rho, (1, 0, 0): u * rho,
        (2, 0, 0): kxx_p + uu * rho,
        (1, 1, 0): kxy_p, (2, 1, 0): 2.0 * u * kxy_p,
        (1, 0, 1): kxz_p, (2, 0, 1): 2.0 * u * kxz_p,
        (0, 1, 1): kyz_p, (1, 1, 1): u * kyz_p,
        (2, 1, 1): g211 + uu * kyz_p,
        (0, 2, 0): kyy_p, (1, 2, 0): u * kyy_p,
        (2, 2, 0): g220 + uu * kyy_p,
        (0, 0, 2): kzz_p, (1, 0, 2): u * kzz_p,
        (2, 0, 2): g202 + uu * kzz_p,
        (1, 2, 1): g121, (2, 2, 1): 2.0 * u * g121,
        (1, 1, 2): g112, (2, 1, 2): 2.0 * u * g112,
        (0, 2, 2): g022, (1, 2, 2): u * g022,
        (2, 2, 2): g222 + uu * g022,
    }
    mp = _moment_tensor(mx, rho, 3)
    mp = _decentralize(mp, uy2, 1)
    mp = _decentralize(mp, uz2, 2)
    return _from_raw_moments(mp, 3), rho, (ux, uy, uz)


def collide_d2q9(F: torch.Tensor, omega, omega_bulk=1.0,
                 force=(0.0, 0.0), correlated: bool = True):
    """The 2D cumulant collision of the ``(3, 3, *shape)`` population
    tensor (axes x, y): the trace relaxes with ``omega_bulk`` toward
    ``2 rho / 3``, the deviator and ``k_xy`` with ``omega``, ``k_22`` is the
    Isserlis closure of the relaxed covariance (``correlated``) or the
    product of its diagonal, and the back-shift uses ``u + force``.
    Returns (F', rho, (ux, uy))."""
    m = _raw_moments(F, 2)
    rho = m[0, 0]
    inv = 1.0 / rho
    ux = m[1, 0] * inv
    uy = m[0, 1] * inv

    k = _centralize(m, ux, 0)
    k = _centralize(k, uy, 1)

    kxx, kyy, kxy = k[2, 0], k[0, 2], k[1, 1]
    tr = kxx + kyy
    tr_p = tr + omega_bulk * (2.0 * rho / 3.0 - tr)
    d = (1.0 - omega) * (kxx - kyy) / 2.0
    kxx_p = tr_p / 2.0 + d
    kyy_p = tr_p / 2.0 - d
    kxy_p = (1.0 - omega) * kxy

    if correlated:
        g22 = (kxx_p * kyy_p + 2.0 * kxy_p * kxy_p) * inv
    else:
        g22 = kxx_p * kyy_p * inv

    kp = _moment_tensor({
        (0, 0): rho, (2, 0): kxx_p, (0, 2): kyy_p,
        (1, 1): kxy_p, (2, 2): g22,
    }, rho, 2)

    mp = _decentralize(kp, ux + force[0], 0)
    mp = _decentralize(mp, uy + force[1], 1)
    return _from_raw_moments(mp, 2), rho, (ux, uy)
