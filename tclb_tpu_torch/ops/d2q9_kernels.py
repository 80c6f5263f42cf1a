"""Hand-written CUDA kernels for the d2q9 collide-stream step, their plain
PyTorch versions, and the engines ``Lattice`` builds from them.

Three kernels live in ``tclb_tpu_torch/csrc/d2q9.cu``; each wrapper below
launches its kernel for a CUDA tensor (or raises) and runs the plain
version for a CPU tensor, and counts its launches in ``LAUNCHES``:

``step`` (``d2q9_step``) replaces ``tclb_tpu/ops/pallas_d2q9.py:
    make_pallas_iterate`` (the single-step ``call``).  One thread per node
    pulls its 9 populations straight from device memory with periodic
    indices.  Bound by bytes on this card (each node reads 14 planes and
    writes 11 for 267 flops; see ``node_step_flops``); the design reads
    each plane with neighbouring threads on neighbouring addresses and
    keeps every population in registers.
``step2`` (``d2q9_step2``) replaces ``make_pallas_iterate``'s fused
    ``call2``.  A 32x8 tile stages its populations plus a two-node ring and
    its statics plus a one-node ring in shared memory and runs two steps:
    step 1 on the tile extended by one node, step 2 on the tile.  Bound by
    bytes; the design halves the device-memory traffic per step at the cost
    of recomputing the ring (~27% more node updates at 32x8).
``resident8`` (``d2q9_resident8``) replaces ``make_resident_iterate``.  One
    cooperative launch runs 8 steps with a grid-wide barrier between them,
    ping-ponging two global buffers that, at karman.xml's 1024x100
    (~10 MB), stay in the 50 MB L2: device memory sees one read and one
    write per 8 steps.  Its bound is set by operations, by a few percent
    (8 x 267 flops per MRT node against 100 bytes, just above the card's
    20 flops a byte); the grid barriers and the L2 bandwidth are what its
    time shows.

The same three kernels run the d2q9 family (``FAMILY``: ``d2q9_SRT``,
``d2q9_les``, ``d2q9_inc``, ``d2q9_cumulant``, ``d2q9_new``; the
reference's ``_FAMILY_2D``, ``pallas_d2q9.py:136``): ``csrc/d2q9.cu`` is
built once per model with ``-DD2Q9_MODEL=<id>``, which compiles in that
model's velocity order, boundary set and collision (the branches of
``pallas_d2q9.py:_lbm_step_family``); ``d2q9`` itself builds without it,
to the code it always had.  A family model has no BC coupling planes
(9 storage planes: 84 B a node), so all three kernels are bound by bytes
for it, the resident one too (8 steps of 118 to 243 flops a node fall
just under the card's 20 flops a byte).  Launches are counted per kernel
and model (``launch_key``).

The TPU engines' ghost-row padding and (8,128) alignment are not carried
over: the kernels wrap periodically at any ``ny``, ``nx`` and mask the
ragged edge.  Like the TPU kernels they compute no globals (the engine's
trailing eager step does); d2q9's kernels copy the BC planes through.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Callable

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import LatticeState, SimParams
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.models import (d2q9, d2q9_inc, d2q9_les, d2q9_new,
                                   family, get_model)
from tclb_tpu_torch.ops import _cuda_build, cumulant, lbm

KERNELS = ("d2q9_step", "d2q9_step2", "d2q9_resident8")
# the family models and their csrc/d2q9.cu D2Q9_MODEL ids (d2q9 is 0)
FAMILY = ("d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_cumulant", "d2q9_new")
MODEL_ID = {"d2q9": 0, **{m: i + 1 for i, m in enumerate(FAMILY)}}


def launch_key(name: str, model: str) -> str:
    """A kernel's key in ``LAUNCHES``: d2q9's own under its name, a family
    model's branch as ``name[model]``."""
    return name if model == "d2q9" else f"{name}[{model}]"


# launches per kernel and model; a wrapper adds one where it launches,
# nowhere else
LAUNCHES = {launch_key(name, m): 0 for m in MODEL_ID for name in KERNELS}

RESIDENT_FUSE = 8               # steps per d2q9_resident8 launch
L2_BYTES = 50 * 1024 * 1024     # H100 L2
# boundary cases (csrc/d2q9.cu CASE_*); a type the model lacks never
# matches.  d2q9 and d2q9_new apply them in this order, the family
# through family.boundary_cases; a node matches at most one
CASES = ("Wall", "Solid", "EVelocity", "WPressure", "WVelocity",
         "EPressure", "TopSymmetry", "BottomSymmetry")
NEVER = (0, 1)                  # (mask, value) no flag matches


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# Arguments: everything a kernel reads besides the planes
# --------------------------------------------------------------------------- #


class _CArgs(ctypes.Structure):
    """Mirror of ``struct D2q9Args`` in csrc/d2q9.cu (field for field)."""

    _fields_ = [
        ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("n_storage", ctypes.c_int), ("bc", ctypes.c_int * 2),
        ("ex", ctypes.c_int * 9), ("ey", ctypes.c_int * 9),
        ("opp", ctypes.c_int * 9), ("w", ctypes.c_float * 9),
        ("m", (ctypes.c_float * 9) * 6), ("minv", (ctypes.c_float * 6) * 9),
        ("rate", ctypes.c_float * 6), ("gx", ctypes.c_float),
        ("gy", ctypes.c_float),
        ("case_mask", ctypes.c_int * len(CASES)),
        ("case_val", ctypes.c_int * len(CASES)),
        ("mrt_mask", ctypes.c_int), ("mrt_val", ctypes.c_int),
        ("omega", ctypes.c_float), ("smag", ctypes.c_float),
        ("omega_bulk", ctypes.c_float), ("coll_mask", ctypes.c_int),
        ("smag_mask", ctypes.c_int), ("smag_val", ctypes.c_int),
        ("stab_mask", ctypes.c_int), ("stab_val", ctypes.c_int),
        ("minv_new", (ctypes.c_float * 9) * 9),
        ("p_sh", (ctypes.c_float * 3) * 3), ("p_hh", (ctypes.c_float * 3) * 3),
    ]


@dataclasses.dataclass(frozen=True)
class StepArgs:
    """A d2q9-family step's constants, from the registry and the settings
    (the fields a model does not use are zero)."""

    model: str
    ny: int
    nx: int
    n_storage: int
    bc: tuple          # planes of BC[0], BC[1] (d2q9)
    ex: tuple
    ey: tuple
    opp: tuple
    w: tuple
    m: np.ndarray      # (6, 9) MRT basis rows 3..8 (d2q9)
    minv: np.ndarray   # (9, 6) inverse-basis columns 3..8 (d2q9)
    rate: tuple        # S3, S4, S56, S56, S78, S78 (d2q9)
    gx: float
    gy: float
    cases: tuple       # (mask, value) per CASES entry
    mrt: tuple         # (mask, value) of MRT
    omega: float = 0.0
    smag: float = 0.0
    omega_bulk: float = 0.0
    coll_mask: int = 0                 # the COLLISION group
    smag_type: tuple = NEVER           # d2q9_new's Smagorinsky (LES)
    stab_type: tuple = NEVER           # d2q9_new's Stab (ENTROPIC)

    @functools.cached_property
    def c_struct(self) -> _CArgs:
        """The ``struct D2q9Args`` the kernels take (built once)."""
        c = _CArgs()
        c.ny, c.nx, c.n_storage = self.ny, self.nx, self.n_storage
        c.bc[:] = list(self.bc)
        c.ex[:], c.ey[:], c.opp[:] = list(self.ex), list(self.ey), \
            list(self.opp)
        c.w[:] = list(self.w)
        for i in range(6):
            c.m[i][:] = [float(v) for v in self.m[i]]
        for k in range(9):
            c.minv[k][:] = [float(v) for v in self.minv[k]]
        c.rate[:] = list(self.rate)
        c.gx, c.gy = self.gx, self.gy
        c.case_mask[:] = [mv[0] for mv in self.cases]
        c.case_val[:] = [mv[1] for mv in self.cases]
        c.mrt_mask, c.mrt_val = self.mrt
        c.omega, c.smag, c.omega_bulk = self.omega, self.smag, \
            self.omega_bulk
        c.coll_mask = self.coll_mask
        c.smag_mask, c.smag_val = self.smag_type
        c.stab_mask, c.stab_val = self.stab_type
        if self.model == "d2q9_new":
            # the same float32 coefficients the plain version multiplies by
            P = d2q9_new.P_MAT
            for i in range(9):
                c.minv_new[i][:] = [float(v) for v in d2q9_new.MINV[i]]
            for r in range(3):
                c.p_sh[r][:] = [float(v) for v in P[3 + r, 6:9]]
                c.p_hh[r][:] = [float(v) for v in P[6 + r, 6:9]]
        return c


def _type(model: Model, name: str) -> tuple:
    t = model.node_types.get(name)
    return NEVER if t is None else (int(t.mask), int(t.value))


def step_args(model: Model, shape, settings: np.ndarray) -> StepArgs:
    """Kernel constants for ``model`` at ``shape`` with the settings
    vector ``settings`` (registry order)."""
    si = model.setting_index

    def setting(name):
        return float(settings[si[name]]) if name in si else 0.0

    E = model.ei[:9, :2]
    common = dict(
        model=model.name, ny=int(shape[0]), nx=int(shape[1]),
        n_storage=model.n_storage,
        ex=tuple(int(v) for v in E[:, 0]), ey=tuple(int(v) for v in E[:, 1]),
        opp=tuple(int(v) for v in lbm.opposite(E)),
        w=tuple(float(v) for v in lbm.weights(E)),
        gx=setting("GravitationX"), gy=setting("GravitationY"),
        cases=tuple(_type(model, n) for n in CASES),
        mrt=_type(model, "MRT"))
    if model.name != "d2q9":
        return StepArgs(
            bc=(0, 0), m=np.zeros((6, 9)), minv=np.zeros((9, 6)),
            rate=(0.0,) * 6, omega=setting("omega"), smag=setting("Smag"),
            omega_bulk=setting("omega_bulk"),
            coll_mask=int(model.group_masks["COLLISION"]),
            smag_type=_type(model, "Smagorinsky"),
            stab_type=_type(model, "Stab"), **common)
    M = d2q9.M
    minv = lbm.inverse_basis(M)
    s = [setting(n) for n in ("S3", "S4", "S56", "S78")]
    return StepArgs(
        bc=tuple(int(i) for i in model.groups["BC"]),
        m=M[3:].copy(), minv=minv[:, 3:].copy(),
        rate=(s[0], s[1], s[2], s[2], s[3], s[3]), **common)


def _combo_flops(coef, onto: bool = False) -> int:
    """Operations of ``sum_k coef[k] * x[k]`` (added onto a value when
    ``onto``): an add for every nonzero term past the first (every term
    when ``onto``), a multiply for every coefficient other than 0 and +-1."""
    c = np.abs(np.asarray(coef, dtype=np.float64))
    nonzero = ~np.isclose(c, 0.0)
    muls = int((nonzero & ~np.isclose(c, 1.0)).sum())
    return max(int(nonzero.sum()) - 1 + int(onto), 0) + muls


def _equilibrium_flops(E: np.ndarray, W: np.ndarray) -> int:
    """Operations of one ``equilibrium``: |u|^2 (3), 1 - 1.5|u|^2 (2), w*rho
    once per distinct weight; per direction e.u, then 4.5 e.u + 3, times
    e.u, plus the base and times w*rho (5), or base times w*rho where
    e = 0 (1)."""
    n = 5 + len(np.unique(W))
    for e in E:
        n += _combo_flops(e) + 5 if e.any() else 1
    return n


def _nebb_flops() -> int:
    """Operations of one 2D non-equilibrium bounce-back face
    (``lbm.nebb_boundary``): the wall-parallel and the outgoing sums (2 +
    2), rho or the normal velocity (4), rho u_n and the two distinct
    weights times it (3), the tangential momentum, -3 q_t and the weight
    times it (3), the two diagonal corrections added (2), each unknown's
    partner plus its correction (3): 19."""
    return 2 + 2 + 4 + 3 + 3 + 2 + 3


def _bgk_flops(eq: int, n: int = 9) -> int:
    """rho (8), j (5 + 5), u (2), two equilibria, ``f + omega (feq - f)``
    (3 a population), ``u + g`` (2), ``+ (feq2 - feq)`` (2 a
    population)."""
    return 8 + 10 + 2 + 2 * eq + 3 * n + 2 + 2 * n


def _smagorinsky_flops() -> int:
    """``lbm.smagorinsky_omega_unrolled`` in 2D: f - feq of the 8 moving
    populations, Pi_xx and Pi_yy over 6 terms each (5 + 5), Pi_xy over 4
    (3), |Pi|^2 (6), then the square root, the constant, / rho, + tau0^2,
    the square root, + tau0, / 2 and 1 / tau (8): 35."""
    return 8 + 5 + 5 + 3 + 6 + 8


def _cumulant_flops() -> int:
    """``cumulant.collide_d2q9`` over what its result needs: the raw
    moments up to second order (12 along x, 9 along y), 1/rho and u (3),
    the three second-order central moments (6), the relaxation (tr 1,
    tr' 5, d 3, kxx' kyy' 3, kxy' 1), k22 (5), the back-shift along x
    (u + g, u^2, 2u and seven terms: 10) and along y (18), and the
    inverse Vandermonde along both axes (2 x 3 x 7): 118."""
    return 21 + 3 + 6 + 13 + 5 + 10 + 18 + 42


def _new_flops() -> tuple[int, int, int]:
    """``d2q9_new.collision_core`` at an MRT node, and what its
    Smagorinsky and Stab modes add: the monomial moments of f and of feq
    (over the nonzeros of ``M``, twice), u (2), one equilibrium, the six
    non-equilibrium moments of order >= 2, their relaxation (2 each), the
    inverse basis over its nonzeros; Smagorinsky: q2 (5), the eddy term
    (4), tau and 1 - 1/tau (6); Stab: ``a`` and ``b`` over the nonzero
    blocks of the H-norm metric, the guarded ratio and ``-gamma a/b``
    (3)."""
    def quad(block):
        nz = int((~np.isclose(block, 0.0)).sum())
        return 2 * nz + max(nz - 1, 0)

    moments = sum(_combo_flops(row) for row in d2q9_new.M)
    minv = sum(_combo_flops(row) for row in d2q9_new.MINV)
    eq = _equilibrium_flops(d2q9_new.E, d2q9_new.W)
    P = d2q9_new.P_MAT
    base = 2 * moments + 2 + eq + 6 + 2 * 6 + minv
    return base, 5 + 4 + 6, quad(P[3:6, 6:9]) + quad(P[6:9, 6:9]) + 3


def _inc_equilibrium_flops() -> int:
    """``d2q9_inc.inc_equilibrium``: |u|^2 (3) and 1.5 |u|^2 (1) once; a
    moving direction e.u, 3 e.u, (e.u)^2, 4.5 times it, the two adds, rho
    plus and times w (7 beyond e.u; rho0 = 1); the rest population rho -
    1.5 |u|^2 times w (2)."""
    E = d2q9_inc.E
    n = 4 + 2
    for e in E:
        if e.any():
            n += _combo_flops(e) + 7
    return n


def node_step_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations one step of a d2q9-family model needs
    over a flag field: what the function takes, not what csrc/d2q9.cu
    executes (it also multiplies by the basis' zeros and by the unit
    streaming components).

    d2q9, an MRT node: rho and j (8 + 5 + 5), two divisions, two equilibria
    (2 x 53), f - feq (9), the moment rows 3..8 of ``M`` over their
    nonzeros (46), the six rates, four force adds, and the inverse-basis
    columns 3..8 over their nonzeros onto the post-force equilibrium (76):
    267 in all, derived below from the same ``E``, ``W`` and ``M`` the
    kernels take.  A Zou/He node adds 21; bounce-back and symmetry only
    move values.  The family, at a collision node: d2q9_SRT 173, d2q9_les
    208 (the Smagorinsky rate adds 35), d2q9_inc 197, d2q9_cumulant 118,
    d2q9_new 212 (+15 at a Smagorinsky node, +16 at a Stab node); a
    non-equilibrium bounce-back face adds 19 (d2q9_new's Zou/He 21)."""
    flags = np.asarray(flags).astype(np.int64)
    nt = model.node_types

    def count(name, extra=None):
        if name not in nt:
            return 0
        t = nt[name]
        hit = (flags & t.mask) == t.value
        if extra is not None:
            hit &= extra
        return int(hit.sum())

    faces = sum(count(n) for n in ("EVelocity", "WPressure", "WVelocity",
                                   "EPressure"))
    if model.name in ("d2q9", "d2q9_new"):
        mrt = (flags & nt["MRT"].mask) == nt["MRT"].value
        if model.name == "d2q9_new":
            base, smag, stab = _new_flops()
            return (base * int(mrt.sum()) + smag * count("Smagorinsky", mrt)
                    + stab * count("Stab", mrt) + 21 * faces)
        E, W, M = d2q9.E, d2q9.W, d2q9.M
        minv = lbm.inverse_basis(M)
        eq = _equilibrium_flops(E, W)
        mrt_flops = (_combo_flops(np.ones(len(W))) + _combo_flops(E[:, 0])
                     + _combo_flops(E[:, 1]) + 2 + 2 * eq + len(W)
                     + sum(_combo_flops(row) for row in M[3:]) + len(M) - 3
                     + 4 + sum(_combo_flops(row, onto=True)
                               for row in minv[:, 3:]))
        return mrt_flops * int(mrt.sum()) + 21 * faces
    coll = int(((flags & model.group_masks["COLLISION"]) != 0).sum())
    E = model.ei[:9, :2]
    eq = _equilibrium_flops(E, lbm.weights(E))
    per_node = {"d2q9_SRT": _bgk_flops(eq),
                "d2q9_les": _bgk_flops(eq) + _smagorinsky_flops(),
                "d2q9_inc": _bgk_flops(_inc_equilibrium_flops()) - 2,
                "d2q9_cumulant": _cumulant_flops()}[model.name]
    return per_node * coll + _nebb_flops() * faces


def launch_bytes(model: Model, shape) -> int:
    """Device-memory bytes one launch of any of the three kernels must
    move: the field stack, the int32 flags and the two zonal planes read
    once, the field stack written once."""
    n = int(np.prod(shape))
    return (2 * model.n_storage + 3) * 4 * n


# --------------------------------------------------------------------------- #
# Plain PyTorch version (the kernels' arithmetic, whole-lattice tensor ops)
# --------------------------------------------------------------------------- #


def _plain_step(fields, flags, vel, den, a: StepArgs) -> torch.Tensor:
    """One NoGlobals d2q9 step on the whole lattice, exact periodic wrap,
    from the same constants the kernels take."""
    f = torch.stack([torch.roll(fields[k], (a.ey[k], a.ex[k]), (0, 1))
                     for k in range(9)])

    def hit(name):
        mask, val = a.cases[CASES.index(name)]
        return (flags & mask) == val

    f = torch.where(hit("Wall") | hit("Solid"), f[list(a.opp)], f)
    for name, value, kind, side in (
            ("EVelocity", vel, "velocity", "E"),
            ("WPressure", den, "pressure", "W"),
            ("WVelocity", vel, "velocity", "W"),
            ("EPressure", den, "pressure", "E")):
        f = torch.where(hit(name), d2q9._zou_he_x(f, value, kind, side), f)
    f = torch.where(hit("TopSymmetry"), d2q9._symmetry(f, top=True), f)
    f = torch.where(hit("BottomSymmetry"), d2q9._symmetry(f, top=False), f)

    E, W = np.stack([a.ex, a.ey], axis=1), np.asarray(a.w)
    rho = sum(f[1:], f[0])
    ux = lbm.edot(a.ex, f) / rho
    uy = lbm.edot(a.ey, f) / rho
    m_neq = lbm.unrolled_matvec(a.m, f - lbm.equilibrium(E, W, rho, (ux, uy)))
    m_neq = m_neq * torch.tensor(a.rate, dtype=f.dtype,
                                 device=f.device)[:, None, None]
    feq2 = lbm.equilibrium(E, W, rho, (ux + a.gx + fields[a.bc[0]],
                                       uy + a.gy + fields[a.bc[1]]))
    mrt = (flags & a.mrt[0]) == a.mrt[1]
    out = fields.clone()
    out[:9] = torch.where(mrt, lbm.unrolled_matvec(a.minv, m_neq) + feq2, f)
    return out


def _plain_family_step(fields, flags, vel, den, a: StepArgs
                       ) -> torch.Tensor:
    """One NoGlobals step of a family model on the whole lattice, op for
    op the reference's ``pallas_d2q9.py:_lbm_step_family``: the model's
    boundary dispatch, then its collision where it collides."""
    model = get_model(a.model)
    f = torch.stack([torch.roll(fields[k], (a.ey[k], a.ex[k]), (0, 1))
                     for k in range(9)])

    def hit(name):
        t = model.node_types[name]
        return (flags & t.mask) == t.value

    def setting(value):
        return torch.tensor(value, dtype=f.dtype, device=f.device)

    omega = setting(a.omega)
    if a.model == "d2q9_new":
        f = family.dispatch_boundary_cases(
            d2q9_new.boundary_cases(vel, den), f, hit)
        fc = d2q9_new.collision_core(f, omega, setting(a.smag),
                                     hit("Smagorinsky"), hit("Stab"))
        return torch.where(hit("MRT")[None], fc, f)
    E = np.stack([a.ex, a.ey], axis=1)
    W, OPP = np.asarray(a.w), np.asarray(a.opp)
    f = family.dispatch_boundary_cases(
        family.boundary_cases(model, E, W, OPP, vel, den), f, hit)
    force = (setting(a.gx), setting(a.gy))
    if a.model == "d2q9_SRT":
        fc, _, _ = lbm.bgk_collide(E, W, f, omega, force=force)
    elif a.model == "d2q9_les":
        fc = d2q9_les.collide(f, omega, setting(a.smag), force)
    elif a.model == "d2q9_inc":
        fc = d2q9_inc.collide(f, omega, force)
    else:
        Fp, _, _ = cumulant.collide_d2q9(
            f.reshape((3, 3) + f.shape[1:]), omega, setting(a.omega_bulk),
            force=force)
        fc = Fp.reshape(f.shape)
    return torch.where(((flags & a.coll_mask) != 0)[None], fc, f)


def plain_steps(fields, flags, vel, den, a: StepArgs, n: int
                ) -> torch.Tensor:
    """``n`` NoGlobals steps of ``a.model`` on the whole lattice: what
    ``step`` (n=1), ``step2`` (n=2) and ``resident8`` (n=8) compute."""
    one = _plain_step if a.model == "d2q9" else _plain_family_step
    with torch.no_grad():
        for _ in range(n):
            fields = one(fields, flags, vel, den, a)
    return fields


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

_LIB: dict = {}    # the loaded libraries, once per process and model
# the family's libraries keep every multiply and add apart, as the plain
# PyTorch versions compute them
FAMILY_FLAGS = ("--fmad=false",)


def build(model: str = "d2q9") -> tuple[pathlib.Path, str]:
    """Compile csrc/d2q9.cu for sm_90a into build/tclb_tpu_torch/ (once per
    source content and model): ``d2q9`` as it is, a family model with
    ``-DD2Q9_MODEL=<id>``.  Returns the library path and the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills per
    kernel)."""
    if model == "d2q9":
        return _cuda_build.build("d2q9")
    return _cuda_build.build(
        "d2q9", variant=(model, (f"-DD2Q9_MODEL={MODEL_ID[model]}",)
                         + FAMILY_FLAGS))


def _lib(model: str = "d2q9") -> ctypes.CDLL:
    if model not in _LIB:
        path, _ = build(model)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        argp = ctypes.POINTER(_CArgs)
        for name in ("d2q9_step", "d2q9_step2"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, argp, i, p]
            fn.restype = i
        lib.d2q9_resident8.argtypes = [p, p, p, p, p, p, argp, i, i, p]
        lib.d2q9_resident8.restype = i
        lib.d2q9_resident8_capacity.argtypes = [
            i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.d2q9_resident8_capacity.restype = i
        lib.d2q9_error_string.argtypes = [i]
        lib.d2q9_error_string.restype = ctypes.c_char_p
        lib.d2q9_velocity_set.argtypes = [ctypes.POINTER(i)] * 3
        lib.d2q9_velocity_set.restype = None
        _check_velocity_set(lib, model)
        _LIB[model] = lib
    return _LIB[model]


def _check_velocity_set(lib, model: str) -> None:
    """The library was compiled for ``model``: its model id and velocity
    order are the registry's."""
    ex, ey, mid = (ctypes.c_int * 9)(), (ctypes.c_int * 9)(), ctypes.c_int()
    lib.d2q9_velocity_set(ex, ey, ctypes.byref(mid))
    E = get_model(model).ei[:9, :2]
    if mid.value != MODEL_ID[model] or list(ex) != E[:, 0].tolist() \
            or list(ey) != E[:, 1].tolist():
        raise RuntimeError(
            f"csrc/d2q9.cu built as model {mid.value} with velocities "
            f"{list(zip(ex, ey))}; {model} needs {MODEL_ID[model]} and "
            f"{E.tolist()}")


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.d2q9_error_string(rc).decode()})")


def _validate(fields, flags, vel, den, a: StepArgs) -> None:
    if a.model != "d2q9" and a.n_storage != 9:
        raise ValueError(f"{a.model}: the family kernels take 9 storage "
                         f"planes, not {a.n_storage}")
    shape = (a.ny, a.nx)
    want = ((fields, torch.float32, (a.n_storage,) + shape),
            (flags, torch.int32, shape), (vel, torch.float32, shape),
            (den, torch.float32, shape))
    for t, dtype, sh in want:
        if t.device != fields.device or t.dtype != dtype \
                or tuple(t.shape) != sh or not t.is_contiguous():
            raise ValueError(
                f"d2q9 kernel input {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: needs contiguous {sh} {dtype} on "
                f"{fields.device}")


def _device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _launch_single(name: str, fields, flags, vel, den, a: StepArgs
                   ) -> torch.Tensor:
    _validate(fields, flags, vel, den, a)
    lib = _lib(a.model)
    out = torch.empty_like(fields)
    dev, stream = _device_and_stream(fields)
    rc = getattr(lib, name)(fields.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), vel.data_ptr(), den.data_ptr(),
                            ctypes.byref(a.c_struct), dev, stream)
    _check(lib, rc, name)
    LAUNCHES[launch_key(name, a.model)] += 1
    return out


def step(fields, flags, vel, den, a: StepArgs) -> torch.Tensor:
    """One step (kernel ``d2q9_step``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, vel, den, a, 1)
    return _launch_single("d2q9_step", fields, flags, vel, den, a)


def step2(fields, flags, vel, den, a: StepArgs) -> torch.Tensor:
    """Two fused steps (kernel ``d2q9_step2``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, vel, den, a, 2)
    return _launch_single("d2q9_step2", fields, flags, vel, den, a)


def resident_grid(device: int, nodes: int, model: str = "d2q9") -> int:
    """Blocks of one cooperative ``d2q9_resident8`` launch of ``model``'s
    library: as many as the device holds at once, no more than the
    lattice needs.  Raises when the device cannot launch cooperative
    kernels."""
    key = ("capacity", device, model)
    if key not in _LIB:
        lib = _lib(model)
        coop, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _check(lib, lib.d2q9_resident8_capacity(device, ctypes.byref(coop),
                                                ctypes.byref(blocks)),
               "d2q9_resident8 capacity query")
        if not coop.value:
            raise RuntimeError(f"CUDA device {device} cannot launch "
                               "cooperative kernels (cudaDevAttr"
                               "CooperativeLaunch is 0)")
        if blocks.value < 1:
            raise RuntimeError("d2q9_resident8 fits no block on device "
                               f"{device}")
        _LIB[key] = blocks.value
    return min(_LIB[key], (nodes + 255) // 256)


def resident8(fields, flags, vel, den, a: StepArgs) -> torch.Tensor:
    """Eight steps in one cooperative launch (kernel ``d2q9_resident8``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, vel, den, a, RESIDENT_FUSE)
    _validate(fields, flags, vel, den, a)
    lib = _lib(a.model)
    dev, stream = _device_and_stream(fields)
    blocks = resident_grid(dev, a.ny * a.nx, a.model)
    out = torch.empty_like(fields)
    scratch = torch.empty((9, a.ny, a.nx), dtype=fields.dtype,
                          device=fields.device)
    rc = lib.d2q9_resident8(fields.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), flags.data_ptr(),
                            vel.data_ptr(), den.data_ptr(),
                            ctypes.byref(a.c_struct), blocks, dev, stream)
    _check(lib, rc, "d2q9_resident8")
    LAUNCHES[launch_key("d2q9_resident8", a.model)] += 1
    return out


# kernel name -> (wrapper, steps one launch takes)
WRAPPERS = {"d2q9_step": (step, 1), "d2q9_step2": (step2, 2),
            "d2q9_resident8": (resident8, RESIDENT_FUSE)}


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #


def supports(model: Model, shape, dtype) -> bool:
    """Whether the kernels run this configuration: ``d2q9``, or a family
    model with its 9 storage planes; 2D, f32."""
    ours = model.name == "d2q9" or (model.name in FAMILY
                                    and model.n_storage == 9)
    return (ours and len(shape) == 2 and dtype == torch.float32
            and min(int(s) for s in shape) >= 1)


def supports_resident(model: Model, shape, dtype) -> bool:
    """Whether the resident engine fits: the two ping-pong stacks plus
    the static planes within half of the L2."""
    if not supports(model, shape, dtype):
        return False
    return launch_bytes(model, shape) <= L2_BYTES // 2


def kernel_inputs(model: Model, state: LatticeState, params: SimParams
                  ) -> tuple:
    """``(fields, flags, vel, den, args)`` as the engines hand them to a
    kernel wrapper, once per ``iterate`` call: the field stack, the int32
    flags, the zonal Velocity and Density (``1 + 3 Pressure`` for
    ``d2q9_new``) planes gathered through the zone bits, and the
    constants."""
    flags = state.flags.contiguous()
    zones = (flags >> model.zone_shift).long()
    si = model.setting_index
    vel = params.zone_table[si["Velocity"]][zones].contiguous()
    if "Density" in si:
        den = params.zone_table[si["Density"]][zones].contiguous()
    else:   # d2q9_new: the boundary density from the zonal Pressure
        den = (1.0 + 3.0 * params.zone_table[si["Pressure"]][zones]
               ).contiguous()
    a = step_args(model, tuple(flags.shape),
                  params.settings.cpu().numpy())
    return state.fields.contiguous(), flags, vel, den, a


def _advanced(state: LatticeState, fields, niter: int) -> LatticeState:
    return dataclasses.replace(state, fields=fields,
                               globals_=torch.zeros_like(state.globals_),
                               iteration=state.iteration + niter)


def make_resident_iterate(model: Model, shape) -> Callable:
    """``iterate(state, params, niter)``: ``niter // 8`` resident launches,
    then ``niter % 8`` single steps.  Globals come back zeroed."""
    if not supports_resident(model, shape, torch.float32):
        raise ValueError(f"resident engine unsupported: {model.name} {shape}")

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        f, flags, vel, den, a = kernel_inputs(model, state, params)
        for _ in range(niter // RESIDENT_FUSE):
            f = resident8(f, flags, vel, den, a)
        for _ in range(niter % RESIDENT_FUSE):
            f = step(f, flags, vel, den, a)
        return _advanced(state, f, niter)

    return iterate


def make_band_iterate(model: Model, shape, fuse: int = 2) -> Callable:
    """``iterate(state, params, niter)`` on the tiled kernels: with
    ``fuse=2`` pairs of steps through ``step2`` and an odd last step through
    ``step``; with ``fuse=1`` every step through ``step``."""
    if not supports(model, shape, torch.float32):
        raise ValueError(f"d2q9 kernels unsupported: {model.name} {shape}")
    if fuse not in (1, 2):
        raise ValueError(f"fuse={fuse}: only 1 and 2 exist")

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        f, flags, vel, den, a = kernel_inputs(model, state, params)
        pairs = niter // 2 if fuse == 2 else 0
        for _ in range(pairs):
            f = step2(f, flags, vel, den, a)
        for _ in range(niter - 2 * pairs):
            f = step(f, flags, vel, den, a)
        return _advanced(state, f, niter)

    return iterate


def select_engine(model: Model, shape, dtype, series: bool = False
                  ) -> tuple:
    """``(iterate, tag)`` of the kernel engine ``supports()`` picks for
    this configuration, or ``(None, None)``: resident where it fits, else
    the band engine at fuse 2.  A <Control> time series (``series``) is
    rejected: these kernels read the zone table, not a per-step value."""
    if series:
        return None, None
    if supports_resident(model, shape, dtype):
        return (make_resident_iterate(model, shape),
                f"cuda_d2q9_resident[{model.name},fuse={RESIDENT_FUSE}]")
    if supports(model, shape, dtype):
        return (make_band_iterate(model, shape, fuse=2),
                f"cuda_d2q9_band[{model.name},fuse=2]")
    return None, None
