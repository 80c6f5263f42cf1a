"""Shared LBM math on PyTorch tensors — the port's counterpart of the JAX
package's ``ops/lbm.py``, restricted to what the ported models (``d2q9``
and its family, the z-slab family, ``d2q9_kuper``, ``d2q9_heat_adj``,
``d3q19_adj``, the 3D models of the generic engine) use.

Constants (velocity sets, weights, moment bases) are numpy arrays built on
the host; everything that touches lattice planes is a plain function on
tensors.  The JAX package's ``pin``/``optimization_barrier`` seams have no
counterpart: they exist only to make XLA's fusion choices reproducible.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

CS2 = 1.0 / 3.0  # lattice speed of sound squared


def present_types(model, flags: np.ndarray) -> set:
    """Node-type names actually present in a host flag field (the eager
    engine skips absent boundary cases, as the reference specializes its
    generated kernels on the model's boundary set)."""
    flags = np.asarray(flags)
    out = set()
    for name, t in model.node_types.items():
        if ((flags & np.uint16(t.mask)) == np.uint16(t.value)).any():
            out.add(name)
    return out


def opposite(E: np.ndarray) -> np.ndarray:
    """Index i -> index of -e_i (bounce-back pairing)."""
    opp = np.zeros(len(E), dtype=np.int32)
    for i, e in enumerate(E):
        (j,) = np.where((E == -e).all(axis=1))
        opp[i] = j[0]
    return opp


def weights(E: np.ndarray) -> np.ndarray:
    """Standard lattice weights by speed shell."""
    q, d = E.shape
    table = {
        (9, 2): {0: 4 / 9, 1: 1 / 9, 2: 1 / 36},
        (19, 3): {0: 1 / 3, 1: 1 / 18, 2: 1 / 36},
        (27, 3): {0: 8 / 27, 1: 2 / 27, 2: 1 / 54, 3: 1 / 216},
        (5, 2): {0: 1 / 3, 1: 1 / 6},
        (7, 3): {0: 1 / 4, 1: 1 / 8},
    }[(q, d)]
    return np.array([table[int((e * e).sum())] for e in E])


def edot(vec, stack: torch.Tensor) -> torch.Tensor:
    """``sum_i vec[i] * stack[i]`` over the leading (population) axis with
    scalar coefficients, exact-zero terms skipped."""
    acc = None
    for i, v in enumerate(np.asarray(vec)):
        v = float(v)
        if v == 0.0:
            continue
        t = stack[i] if v == 1.0 else (-stack[i] if v == -1.0
                                       else v * stack[i])
        acc = t if acc is None else acc + t
    return acc if acc is not None else torch.zeros_like(stack[0])


def perm(stack: torch.Tensor, idx) -> torch.Tensor:
    """Reorder the leading (population) axis by a constant permutation."""
    return torch.stack([stack[int(k)] for k in np.asarray(idx)])


def wstack(w, value) -> torch.Tensor:
    """``(q, *shape)`` stack of ``w[i] * value`` with scalar weight
    coefficients; ``value`` may be a plane or a 0-d tensor."""
    return torch.stack([float(wi) * value for wi in np.asarray(w)])


def equilibrium(E: np.ndarray, W: np.ndarray, rho: torch.Tensor, u):
    """Second-order Maxwell equilibrium
    f_i = w_i rho (1 + e.u/cs2 + (e.u)^2/(2 cs4) - u^2/(2 cs2)).

    ``u`` is a tuple of velocity planes; returns a (Q, *shape) stack."""
    usq = sum(c * c for c in u)
    out = []
    for i in range(len(E)):
        eu = sum(float(E[i, a]) * u[a] for a in range(len(u)) if E[i, a])
        if isinstance(eu, int):  # rest population: e.u == 0
            common = 1.0 - usq / (2 * CS2)
        else:
            common = 1.0 + eu / CS2 + eu * eu / (2 * CS2 * CS2) \
                - usq / (2 * CS2)
        out.append(float(W[i]) * rho * common)
    return torch.stack(out)


def bgk_collide(E: np.ndarray, W: np.ndarray, f: torch.Tensor, omega,
                force=None):
    """Plain BGK with the velocity-shift (exact-difference) body force.
    Returns ``(f', rho, u)`` with ``u`` a tuple of velocity planes."""
    rho = torch.sum(f, dim=0)
    d = E.shape[1]
    u = tuple(edot(E[:, a], f) / rho for a in range(d))
    feq = equilibrium(E, W, rho, u)
    out = f + omega * (feq - f)
    if force is not None:
        u2 = tuple(u[a] + force[a] for a in range(d))
        out = out + (equilibrium(E, W, rho, u2) - feq)
    return out, rho, u


def smagorinsky_omega_unrolled(E: np.ndarray, f, feq, rho, omega0, smag):
    """Smagorinsky eddy-viscosity relaxation rate (Hou et al.):
    ``tau_eff = (tau0 + sqrt(tau0^2 + 18 sqrt(2) Cs^2 |Pi| / rho)) / 2``
    with ``|Pi|`` the Frobenius norm of the non-equilibrium momentum flux,
    contracted with scalar coefficients (2D and 3D)."""
    d = E.shape[1]
    pi2 = None
    for a in range(d):
        for b in range(a, d):
            ks = [k for k in range(len(E)) if E[k, a] * E[k, b]]
            if not ks:
                continue
            pab = sum(float(E[k, a] * E[k, b]) * (f[k] - feq[k])
                      for k in ks)
            term = pab * pab * (1.0 if a == b else 2.0)
            pi2 = term if pi2 is None else pi2 + term
    tau0 = 1.0 / omega0
    tau_eff = 0.5 * (tau0 + torch.sqrt(
        tau0 * tau0 + 18.0 * math.sqrt(2.0) * smag * smag
        * torch.sqrt(pi2) / rho))
    return 1.0 / tau_eff


def mrt_basis_d2q9(E: np.ndarray) -> np.ndarray:
    """Orthogonal d2q9 moment basis of Lallemand & Luo: rows = (rho, jx,
    jy, e, eps, qx, qy, pxx, pxy) as integer polynomials of the velocity
    set."""
    ex, ey = E[:, 0].astype(np.float64), E[:, 1].astype(np.float64)
    e2 = ex * ex + ey * ey
    M = np.stack([
        np.ones_like(ex),               # rho
        ex,                             # jx
        ey,                             # jy
        3.0 * e2 - 4.0,                 # e (energy)
        4.5 * e2 * e2 - 10.5 * e2 + 4.0,  # eps (energy squared)
        (3.0 * e2 - 5.0) * ex,          # qx (energy flux)
        (3.0 * e2 - 5.0) * ey,          # qy
        ex * ex - ey * ey,              # pxx
        ex * ey,                        # pxy
    ])
    g = M @ M.T
    if not np.allclose(g - np.diag(np.diag(g)), 0.0):
        raise ValueError("d2q9 moment basis is not orthogonal")
    return M


def d3q19_velocities() -> np.ndarray:
    """Standard 19-velocity set: rest, 6 axis, 12 edge vectors,
    shell-ordered (the JAX package's order)."""
    E = [(0, 0, 0)]
    for a in range(3):
        for s in (1, -1):
            v = [0, 0, 0]
            v[a] = s
            E.append(tuple(v))
    for a in range(3):
        for b in range(a + 1, 3):
            for sa in (1, -1):
                for sb in (1, -1):
                    v = [0, 0, 0]
                    v[a], v[b] = sa, sb
                    E.append(tuple(v))
    return np.array(E, dtype=np.int32)


def gram_schmidt_basis(E: np.ndarray) -> np.ndarray:
    """Orthogonal moment basis over a velocity set by Gram-Schmidt on the
    monomials 1, ex, ey[, ez], exey, ... in graded order.  Rows are
    ordered by total degree; the first 1 + d rows are the conserved
    (rho, j) moments."""
    q, d = E.shape
    polys = []
    for total in range(0, 3 * d + 1):
        for px in range(total + 1):
            for py in range(total - px + 1):
                pz = total - px - py
                if d == 2 and pz:
                    continue
                p = (px, py) if d == 2 else (px, py, pz)
                if max(p) > 2:   # velocities in {-1,0,1}: e^3 == e
                    continue
                polys.append(p)
    M: list = []
    for p in polys:
        row = np.ones(q)
        for a, pw in enumerate(p):
            row = row * E[:, a].astype(np.float64) ** pw
        for r in M:
            row = row - r * (row @ r) / (r @ r)
        if (np.abs(row) > 1e-9).any():
            M.append(row)
        if len(M) == q:
            break
    if len(M) != q:
        raise ValueError(f"moment basis incomplete: {len(M)}/{q}")
    return np.stack(M)


def inverse_basis(M: np.ndarray) -> np.ndarray:
    """Inverse of an orthogonal (row) basis: ``(M / |row|^2).T``."""
    norm = (M * M).sum(axis=1)
    return (M / norm[:, None]).T


def unrolled_matvec(mat: np.ndarray, f) -> torch.Tensor:
    """``mat @ f`` over the leading axis, unrolled with scalar coefficients
    (the matrices are tiny, with many 0/±1 entries)."""
    rows = []
    for row in np.asarray(mat):
        acc = None
        for c, p in zip(row, f):
            c = float(c)
            if c == 0.0:
                continue
            t = p if c == 1.0 else (-p if c == -1.0 else c * p)
            acc = t if acc is None else acc + t
        rows.append(acc if acc is not None else torch.zeros_like(f[0]))
    return torch.stack(rows)


def moments(M: np.ndarray, f: torch.Tensor) -> torch.Tensor:
    """m = M f over the leading (population) axis."""
    return unrolled_matvec(M, f)


def from_moments(M: np.ndarray, m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`moments` for an orthogonal (row) basis."""
    return unrolled_matvec(inverse_basis(M), m)


def two_rate_relax(M: np.ndarray, lo: int, hi: int, fneq,
                   keep_stress, keep_high) -> torch.Tensor:
    """Relaxed non-equilibrium of a two-rate MRT: rows ``lo:hi`` of the
    orthogonal basis ``M`` (the stress group) keep ``keep_stress``, every
    higher row keeps ``keep_high``, the conserved rows (0:lo) drop out.

    Uses the projection identity ``Minv @ (keep * M @ fneq) == keep_high
    * fneq + (keep_stress - keep_high) * P_s @ fneq`` (the conserved
    moments of ``fneq = f - feq`` vanish), so only the ``hi - lo`` stress
    projections are computed: ``mn = M[lo:hi] fneq``, ``back = (M[lo:hi]
    / |row|^2)^T mn``, ``keep_high fneq_k + d back_k``."""
    norms = (M * M).sum(axis=1)
    mn = unrolled_matvec(M[lo:hi], fneq)
    back = unrolled_matvec((M[lo:hi] / norms[lo:hi, None]).T, mn)
    d = keep_stress - keep_high
    return torch.stack([keep_high * fneq[k] + d * back[k]
                        for k in range(len(M))])


def nebb_boundary(E: np.ndarray, W: np.ndarray, OPP: np.ndarray,
                  f: torch.Tensor, axis: int, side: int, kind: str, value,
                  vt: Optional[dict] = None) -> torch.Tensor:
    """Straight-wall velocity/pressure boundary by non-equilibrium
    bounce-back: Zou & He's closure generalized to any face of any velocity
    set (the JAX package's ``ops/lbm.py:nebb_boundary``, op for op).

    ``axis``: face normal axis (0=x, 1=y, 2=z); ``side``: +1 if the fluid
    lies toward +axis (a low face), -1 for a high face; ``kind``:
    'velocity' (``value`` = signed +axis velocity component) or 'pressure'
    (``value`` = density).  Unknown populations (e.axis == side) get
    ``f_opp + 6 w rho (e.u)`` for the normal velocity plus, per tangential
    axis, ``6 w e_t J_t`` with ``J_t = -3 q_t`` (``q_t`` the tangential
    momentum of the wall-parallel populations) and, where ``vt`` imposes
    a tangential velocity ``{axis: value}``, ``+ 3 rho v_t``."""
    q = len(E)
    en = E[:, axis].astype(np.int64)
    tang_k = [k for k in range(q) if en[k] == 0]
    out_k = [k for k in range(q) if en[k] == -side]   # known, entering wall
    s_t = sum(f[k] for k in tang_k)
    s_o = sum(f[k] for k in out_k)
    if kind == "velocity":
        un = value
        rho = (s_t + 2.0 * s_o) / (1.0 - side * un)
    else:
        rho = value
        un = side * (1.0 - (s_t + 2.0 * s_o) / rho)
    corr = [6.0 * float(W[k]) * float(en[k]) * rho * un
            if en[k] else None for k in range(q)]
    for t_ax in range(E.shape[1]):
        if t_ax == axis:
            continue
        et = E[:, t_ax].astype(np.int64)
        if not et.any():
            continue
        q_t = sum(float(et[k]) * f[k] for k in tang_k if et[k])
        j_t = -3.0 * q_t
        if vt and t_ax in vt:
            j_t = j_t + 3.0 * rho * vt[t_ax]
        for k in range(q):
            if en[k] == side and et[k]:
                add = 6.0 * float(W[k]) * float(et[k]) * j_t
                corr[k] = add if corr[k] is None else corr[k] + add
    return torch.stack([
        f[int(OPP[k])] + (corr[k] if corr[k] is not None
                          else torch.zeros_like(rho))
        if en[k] == side else f[k]
        for k in range(q)])
