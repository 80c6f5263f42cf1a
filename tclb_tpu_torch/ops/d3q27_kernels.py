"""Hand-written CUDA kernels for the z-slab collide-stream step of the
d3q27/d3q19 family, their plain PyTorch versions, and the engine
``Lattice`` builds from them.

Two kernels live in ``tclb_tpu_torch/csrc/d3q27.cu``; each wrapper below
launches its kernel for a CUDA tensor (or raises) and runs the plain
version for a CPU tensor, and counts its launches in ``LAUNCHES``:

``step`` (``d3q27_step``) replaces ``tclb_tpu/ops/pallas_d3q.py:
    make_pallas_iterate``'s single-step kernels (the ring kernel, and the
    block kernel that computes the same function).  One thread per node
    pulls its populations straight from device memory with periodic
    indices.  Bound by bytes on this card: a d3q27_cumulant node reads 34
    planes and its flag and writes 34 planes (276 B) for about 540 flops
    (see ``node_step_flops``); neighbouring threads read neighbouring x.
``step2`` (``d3q27_step2``) replaces ``make_pallas_iterate``'s fused
    kernel at K=2.  A block owns a 32x8 (x, y) column over a run of z
    planes and marches up z, keeping a ring of three step-1 planes (the
    column extended by one node in x and y) in shared memory; step 2 of
    each plane reads that ring.  Bound by bytes, at the same bytes per
    launch as ``step`` for two steps; it recomputes the one-node ring of
    step 1 (34x10 for 32x8, 1.33x) and two extra planes per z run.

The same two kernels run the reference's whole z-slab family
(``MODELS``, the reference's ``_SUPPORTED``, ``pallas_d3q.py:58``):
``csrc/d3q27.cu`` is built once per model with ``-DD3Q_MODEL=<id>``,
which compiles in that model's velocity set (the tensor-product order for
the 27-velocity models, ``lbm.d3q19_velocities()``'s shell order for
d3q19), storage stack, boundary cases and collision (the branches of
``pallas_d3q.py:_step``, :361-436); ``d3q27_cumulant`` is id 0 and builds
without it, to the code it always had.  Each model's build is checked
against the registry at load (``d3q27_model_info``).

All compute what ``pallas_d3q.py``'s ``_step`` computes, minus globals:
the periodic pull, the ``family.boundary_cases`` dispatch, the collision
where the COLLISION group is set (d3q27_cumulant: the cumulant with force
and Galilean correction at the Buffer layer's omega, SynthT copied
through and the avgP/avgU running averages; d3q27_BGK and galcor: BGK with
the second- or third-order equilibrium; d3q19: the two-rate MRT; d3q19_les:
BGK at the Smagorinsky rate; each with the body-force equilibrium
difference).  Zonal Velocity/Density (and the cumulant's Turbulence) come
from the zone table through the flag's zone bits, as the TPU's fused
kernel rebuilds them.  f32 only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import pathlib
from typing import Callable

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import LatticeState, SimParams, pull_stream
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.models import d3q19, d3q19_les, d3q27_bgk, family
from tclb_tpu_torch.models import d3q27_cumulant as d3q
from tclb_tpu_torch.ops import _cuda_build, cumulant, lbm

KERNELS = ("d3q27_step", "d3q27_step2")
MODEL = "d3q27_cumulant"
# the family and their csrc/d3q27.cu D3Q_MODEL ids (d3q27_cumulant is 0)
MODELS = (MODEL, "d3q27_BGK", "d3q27_BGK_galcor", "d3q19", "d3q19_les")
MODEL_ID = {m: i for i, m in enumerate(MODELS)}


def launch_key(name: str, model: str) -> str:
    """A kernel's key in ``LAUNCHES``: d3q27_cumulant's under the kernel's
    name, another model's branch as ``name[model]``."""
    return name if model == MODEL else f"{name}[{model}]"


# launches per kernel and model; a wrapper adds one where it launches,
# nowhere else
LAUNCHES = {launch_key(name, m): 0 for m in MODELS for name in KERNELS}

# boundary cases in the order each model lists them (csrc/d3q27.cu CASE_*)
_FAMILY_CASES = ("Wall", "Solid", "WVelocity", "WPressure", "EVelocity",
                 "EPressure", "SSymmetry", "NSymmetry")
CASES = {m: _FAMILY_CASES for m in MODELS[1:]}
CASES[MODEL] = ("Wall", "Solid", "WVelocity", "WPressure", "EVelocity",
                "EPressure", "SVelocity", "SPressure", "SSymmetry",
                "NVelocity", "NPressure", "NSymmetry", "WVelocityTurbulent")
MAX_CASES = 13            # the case arrays' length in D3q27Args
NEVER = (0, 1)            # (mask, value) no flag matches
# rows of the zone table (pallas_d3q.py:_n_zonal)
ZONAL = {m: ("Velocity", "Density") for m in MODELS[1:]}
ZONAL[MODEL] = ("Velocity", "Density", "Turbulence")
# the storage stack the kernels index by plane (csrc/d3q27.cu P_*)
STORAGE = {m: tuple(f"f[{k}]" for k in range(27)) for m in MODELS[1:3]}
STORAGE.update({m: tuple(f"f[{k}]" for k in range(19))
                for m in MODELS[3:]})
STORAGE[MODEL] = tuple(f"f[{k}]" for k in range(27)) + (
    "SynthTX", "SynthTY", "SynthTZ", "avgP", "avgUX", "avgUY", "avgUZ")
# each model's velocity set, weights and bounce-back pairs
_SETS = {MODEL: (d3q.E, d3q.W, d3q.OPP),
         "d3q27_BGK": (d3q27_bgk.E, d3q27_bgk.W, d3q27_bgk.OPP),
         "d3q27_BGK_galcor": (d3q27_bgk.E, d3q27_bgk.W, d3q27_bgk.OPP),
         "d3q19": (d3q19.E, d3q19.W, d3q19.OPP),
         "d3q19_les": (d3q19.E, d3q19.W, d3q19.OPP)}


def q_of(model: str) -> int:
    return len(_SETS[model][0])


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# Arguments: everything a kernel reads besides the planes and the zone table
# --------------------------------------------------------------------------- #


class _CArgs(ctypes.Structure):
    """Mirror of ``struct D3q27Args`` in csrc/d3q27.cu (field for field)."""

    _fields_ = [
        ("nz", ctypes.c_int), ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("zc", ctypes.c_int),
        ("case_mask", ctypes.c_int * MAX_CASES),
        ("case_val", ctypes.c_int * MAX_CASES),
        ("coll_mask", ctypes.c_int),
        ("buffer_mask", ctypes.c_int), ("buffer_val", ctypes.c_int),
        ("zone_shift", ctypes.c_int), ("zone_max", ctypes.c_int),
        ("omega", ctypes.c_float), ("omega_buffer", ctypes.c_float),
        ("omega_bulk", ctypes.c_float), ("galilean", ctypes.c_float),
        ("force", ctypes.c_float * 3),
        ("s_high", ctypes.c_float), ("smag", ctypes.c_float),
        ("m_stress", (ctypes.c_float * 19) * 6),
        ("m_back", (ctypes.c_float * 6) * 19),
    ]


@dataclasses.dataclass(frozen=True)
class StepArgs:
    """A z-slab model's step constants, from the registry and the settings
    vector (registry order, at the lattice's precision)."""

    model: str
    nz: int
    ny: int
    nx: int
    settings: tuple
    cases: tuple       # (mask, value) per CASES[model] entry
    coll_mask: int
    buffer: tuple      # (mask, value) of Buffer (the cumulant's)
    zone_shift: int
    zone_max: int

    def _f32(self, name: str) -> np.float32:
        si = _model(self.model).setting_index
        return np.float32(self.settings[si[name]] if name in si else 0.0)

    def c_struct(self, zc: int = 1) -> _CArgs:
        """The ``struct D3q27Args`` the kernels take, with ``zc`` z planes
        per ``d3q27_step2`` block (built once per ``zc``)."""
        cache = self.__dict__.setdefault("_c_structs", {})
        if zc not in cache:
            c = _CArgs()
            c.nz, c.ny, c.nx, c.zc = self.nz, self.ny, self.nx, zc
            cases = list(self.cases) + [NEVER] * (MAX_CASES - len(self.cases))
            c.case_mask[:] = [mv[0] for mv in cases]
            c.case_val[:] = [mv[1] for mv in cases]
            c.coll_mask = self.coll_mask
            c.buffer_mask, c.buffer_val = self.buffer
            c.zone_shift, c.zone_max = self.zone_shift, self.zone_max
            # the f32 arithmetic of the model's own expressions
            c.omega = self._f32("omega")
            c.force[:] = [float(self._f32(f"Force{a}")
                                + self._f32(f"Gravitation{a}"))
                          if self.model == MODEL
                          else float(self._f32(f"Gravitation{a}"))
                          for a in "XYZ"]
            if self.model == MODEL:
                c.omega_buffer = np.float32(1.0) / (
                    np.float32(3.0) * self._f32("nubuffer")
                    + np.float32(0.5))
                c.omega_bulk = self._f32("omega_bulk")
                c.galilean = self._f32("GalileanCorrection")
            c.s_high, c.smag = self._f32("S_high"), self._f32("Smag")
            if self.model == "d3q19":
                # the float32 coefficients lbm.two_rate_relax multiplies by
                stress, back = stress_rows()
                for r in range(6):
                    c.m_stress[r][:] = [float(v) for v in stress[r]]
                for k in range(19):
                    c.m_back[k][:] = [float(v) for v in back[k]]
            cache[zc] = c
        return cache[zc]


def stress_rows() -> tuple[np.ndarray, np.ndarray]:
    """d3q19's stress rows ``M[4:10]`` and ``(M[4:10] / |row|^2)^T``, the
    two matrices ``lbm.two_rate_relax`` applies."""
    lo, hi = d3q19.STRESS
    M = d3q19.M
    norms = (M * M).sum(axis=1)
    return M[lo:hi], (M[lo:hi] / norms[lo:hi, None]).T


def _model(name: str) -> Model:
    from tclb_tpu_torch.models import get_model
    return get_model(name)


def _type(model: Model, name: str) -> tuple:
    t = model.node_types.get(name)
    return NEVER if t is None else (int(t.mask), int(t.value))


def check_layout(model: Model) -> None:
    """The kernels' fixed population order and plane layout must be the
    model's (raises otherwise)."""
    want = STORAGE.get(model.name)
    if tuple(model.storage_names) != want:
        raise ValueError(f"{model.name}: storage {model.storage_names} is "
                         f"not one the d3q27 kernels take ({MODELS})")
    E = _SETS[model.name][0]
    if not np.array_equal(model.ei[:len(E)], E):
        raise ValueError(f"{model.name}: f planes are not in the order of "
                         "the velocity set csrc/d3q27.cu compiles in")


def step_args(model: Model, shape, settings: np.ndarray) -> StepArgs:
    """Kernel constants for ``model`` at ``shape`` with the settings
    vector ``settings`` (registry order)."""
    check_layout(model)
    return StepArgs(
        model=model.name,
        nz=int(shape[0]), ny=int(shape[1]), nx=int(shape[2]),
        settings=tuple(float(v) for v in settings),
        cases=tuple(_type(model, n) for n in CASES[model.name]),
        coll_mask=int(model.group_masks["COLLISION"]),
        buffer=_type(model, "Buffer"),
        zone_shift=int(model.zone_shift), zone_max=int(model.zone_max))


# --------------------------------------------------------------------------- #
# Bounds: operations and bytes
# --------------------------------------------------------------------------- #

# Operations of one d3q27_cumulant node, counted on the arithmetic of
# ops/cumulant.py and ops/lbm.py (an add or a multiply each; multiplies by 0
# and +-1 are not operations, and neither are products of settings alone):
#   every node: the forward moments of order <= 2 (x pass 36, y pass 27,
#     z pass 16), 1 / rho and u (4), and the averages' increments ((rho - 1)
#     / 3 and four adds: 6) -- 89;
#   a collision node besides: the six second-order central moments (12),
#     their scaled diagonal (3), the a/b/cc relaxation (9), the Galilean
#     correction (38), the relaxed diagonal (14) and off-diagonal (3), the
#     Isserlis closure (44), the forced velocity (3), the sparse x shift
#     (21), the dense y and z shifts (56 each) and the inverse Vandermonde
#     on three axes (189) -- 448;
#   a velocity or pressure face (nebb_boundary): see ``_nebb_flops``.
NODE_FLOPS = 89
COLLISION_FLOPS = 448


def _nebb_flops(axis: int, turbulent: bool = False, model: str = MODEL
                ) -> int:
    """Operations of one ``lbm.nebb_boundary`` node on a face of
    ``model``'s velocity set: the tangential and outgoing sums, rho or un (4),
    the normal correction (rho un, then one multiply per unknown), per
    tangential axis its momentum sum, ``-3 q_t``, and a multiply-add per
    unknown that moves along it (plus ``3 rho v_t`` where a tangential
    velocity is imposed), and the unknowns' bounce-back adds; velocity and
    pressure faces count the same.  The turbulent inlet also forms its
    normal velocity and two tangential velocities (4)."""
    E = _SETS[model][0]
    q = len(E)
    en = E[:, axis]
    unknown = [k for k in range(q) if en[k] == 1]   # either side
    tang = [k for k in range(q) if en[k] == 0]
    n = (len(tang) - 1) + (len(unknown) - 1) + 4 + 1 + len(unknown)
    for t in range(3):
        if t == axis:
            continue
        n += (sum(1 for k in tang if E[k, t]) - 1) + 1
        n += 2 * sum(1 for k in unknown if E[k, t])
        n += 3 if turbulent else 0
    n += len(unknown)
    return n + (4 if turbulent else 0)


def collision_flops(name: str) -> int:
    """Operations of one collision node of a model other than the
    cumulant, counted like ``NODE_FLOPS``: rho (q - 1), j over the nonzero
    velocity components, u (3), each equilibrium (``generic3d_kernels.
    equilibrium_flops``; galcor adds (e.u)^2 e.u, e.u |u|^2, their two
    4.5 factors, the difference and the add, 6 a moving population), and
    then: BGK ``f + omega (feq - f)`` (3 a population); d3q19's ``f -
    feq``, the stress moments and their projection over the rows'
    nonzeros, the keep factors (3) and ``kh fneq + d back`` (3 a
    population); d3q19_les's Smagorinsky rate (``f - feq`` of the moving
    populations, the six flux sums, |Pi|^2 (14) and the rate: sqrt, times
    the constant, / rho, + tau0^2, sqrt, + tau0, / 2 and 1 / tau (8)) and
    BGK; every model ``u + g`` (3) and the force difference (2 a
    population, 1 for d3q19's ``+ feq2``)."""
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    from tclb_tpu_torch.ops.generic3d_kernels import equilibrium_flops
    E, W, _ = _SETS[name]
    q = len(E)
    eq = equilibrium_flops(E, W)
    if name == "d3q27_BGK_galcor":
        eq += 6 * (q - 1)
    n = (q - 1) + sum(_combo_flops(E[:, a]) for a in range(3)) + 3 + 2 * eq
    n += 3
    if name == "d3q19":
        stress, back = stress_rows()
        return (n + q + sum(_combo_flops(r) for r in stress)
                + sum(_combo_flops(r) for r in back) + 3 + 3 * q + q)
    if name == "d3q19_les":
        pairs = [(a, b) for a in range(3) for b in range(a, 3)]
        sums = sum(int((E[:, a] * E[:, b] != 0).sum()) - 1 for a, b in pairs)
        n += (q - 1) + sums + 14 + 8
    return n + 3 * q + 2 * q


def node_step_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations one step of a z-slab model needs over a
    flag field (what the function takes, not what csrc/d3q27.cu
    executes)."""
    flags = np.asarray(flags).astype(np.int64)
    nt = model.node_types

    def count(name):
        if name not in nt:
            return 0
        t = nt[name]
        return int(((flags & t.mask) == t.value).sum())

    coll = int(((flags & model.group_masks["COLLISION"]) != 0).sum())
    if model.name == MODEL:
        n = NODE_FLOPS * flags.size + COLLISION_FLOPS * coll
    else:
        n = collision_flops(model.name) * coll
    for face, axis in (("W", 0), ("E", 0), ("S", 1), ("N", 1)):
        n += _nebb_flops(axis, model=model.name) * (
            count(face + "Velocity") + count(face + "Pressure"))
    n += _nebb_flops(0, turbulent=True) * count("WVelocityTurbulent")
    return n


def launch_bytes(model: Model, shape) -> int:
    """Device-memory bytes one launch of either kernel must move: the
    field stack and the int32 flags read once, the zone table read once,
    the field stack written once."""
    n = int(np.prod(shape))
    return ((2 * model.n_storage + 1) * 4 * n
            + len(ZONAL[model.name]) * model.zone_max * 4)


# --------------------------------------------------------------------------- #
# Plain PyTorch version (the kernels' function, whole-lattice tensor ops)
# --------------------------------------------------------------------------- #


def _plain_step(fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    """One NoGlobals step of ``a.model`` on the whole lattice, exact
    periodic wrap: pallas_d3q.py's ``_step`` on the model's own pieces."""
    m = _model(a.model)
    si = m.setting_index
    nt = m.node_types
    E, W, OPP = _SETS[a.model]
    q = len(E)
    sett = torch.tensor(a.settings, dtype=fields.dtype, device=fields.device)
    f = pull_stream(m, fields)[:q]
    zones = (flags >> a.zone_shift).long()
    vel, den = ztab[0][zones], ztab[1][zones]
    extra = None
    if a.model == MODEL:
        turb = ztab[2][zones]
        synth = fields[27:30]
        turb_u = vel + turb * synth[0]
        extra = {"WVelocityTurbulent": lambda f: lbm.nebb_boundary(
            E, W, OPP, f, 0, +1, "velocity", turb_u,
            vt={1: turb * synth[1], 2: turb * synth[2]})}
    cases = family.boundary_cases(m, E, W, OPP, vel, den, extra)

    def is_type(name):
        return (flags & nt[name].mask) == nt[name].value

    f = family.dispatch_boundary_cases(cases, f, is_type)
    coll = (flags & a.coll_mask) != 0
    out = fields.clone()
    if a.model != MODEL:
        g = tuple(sett[si[f"Gravitation{x}"]] for x in "XYZ")
        omega = sett[si["omega"]]
        if a.model == "d3q19":
            fc = d3q19.relax(f, omega, sett[si["S_high"]], g)
        elif a.model == "d3q19_les":
            fc = d3q19_les.collide(f, omega, sett[si["Smag"]], g)
        else:
            fc = d3q27_bgk.collide(f, omega, g,
                                   galcor=a.model == "d3q27_BGK_galcor")
        out[:q] = torch.where(coll[None], fc, f)
        return out
    om = torch.where(is_type("Buffer"),
                     1.0 / (3.0 * sett[si["nubuffer"]] + 0.5),
                     sett[si["omega"]])
    force = tuple(sett[si[f"Force{x}"]] + sett[si[f"Gravitation{x}"]]
                  for x in "XYZ")
    Fp, rho, (ux, uy, uz) = cumulant.collide_d3q27(
        f.reshape((3, 3, 3) + f.shape[1:]), om, sett[si["omega_bulk"]],
        force=force, correlated=True,
        galilean=sett[si["GalileanCorrection"]])
    out[:27] = torch.where(coll[None], Fp.reshape(f.shape), f)
    out[30] = fields[30] + (rho - 1.0) / 3.0
    out[31:34] = fields[31:34] + torch.stack([ux, uy, uz])
    return out


def plain_steps(fields, flags, ztab, a: StepArgs, n: int) -> torch.Tensor:
    """``n`` NoGlobals steps of ``a.model`` on the whole lattice: what
    ``step`` (n=1) and ``step2`` (n=2) compute."""
    with torch.no_grad():
        for _ in range(n):
            fields = _plain_step(fields, flags, ztab, a)
    return fields


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

_LIB: dict = {}    # the loaded libraries and per-device step2 set-ups
# the other models' libraries keep every multiply and add apart, as the
# plain PyTorch versions compute them
FAMILY_FLAGS = ("--fmad=false",)


def build(model: str = MODEL) -> tuple[pathlib.Path, str]:
    """Compile csrc/d3q27.cu for sm_90a into build/tclb_tpu_torch/ (once
    per source content and model): ``d3q27_cumulant`` as it is, another
    model with ``-DD3Q_MODEL=<id>``.  Returns the library path and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills per
    kernel)."""
    if model == MODEL:
        return _cuda_build.build("d3q27")
    return _cuda_build.build(
        "d3q27", variant=(model, (f"-DD3Q_MODEL={MODEL_ID[model]}",)
                          + FAMILY_FLAGS))


def _lib(model: str = MODEL) -> ctypes.CDLL:
    if model not in _LIB:
        path, _ = build(model)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        argp = ctypes.POINTER(_CArgs)
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, argp, i, p]
            fn.restype = i
        ip = ctypes.POINTER(i)
        lib.d3q27_step2_config.argtypes = [i, ip, ip, ip, ip]
        lib.d3q27_step2_config.restype = i
        lib.d3q27_error_string.argtypes = [i]
        lib.d3q27_error_string.restype = ctypes.c_char_p
        lib.d3q27_model_info.argtypes = [ip] * 7
        lib.d3q27_model_info.restype = None
        check_model_info(lib, model)
        _LIB[model] = lib
    return _LIB[model]


def check_model_info(lib, model: str) -> None:
    """The library was compiled for ``model``: its model id, population
    count, storage planes, case count and velocity set are the
    registry's."""
    ints = [ctypes.c_int() for _ in range(4)]
    e = [(ctypes.c_int * 27)() for _ in range(3)]
    lib.d3q27_model_info(*[ctypes.byref(v) for v in ints], *e)
    mid, q, ns, ncases = (v.value for v in ints)
    got = np.array([list(c[:q]) for c in e]).T
    m = _model(model)
    want = (MODEL_ID[model], q_of(model), m.n_storage, len(CASES[model]))
    if (mid, q, ns, ncases) != want \
            or not np.array_equal(got, m.ei[:q_of(model)]):
        raise RuntimeError(
            f"csrc/d3q27.cu built as model {mid} (q {q}, {ns} planes, "
            f"{ncases} cases, velocities {got.tolist()}); {model} needs "
            f"{want} and {m.ei[:q_of(model)].tolist()}")


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.d3q27_error_string(rc).decode()})")


def step2_config(device: int, model: str = MODEL) -> dict:
    """``d3q27_step2``'s dynamic shared memory, threads per block,
    co-resident blocks per SM and the device's SM count, for ``model``'s
    build."""
    key = ("config", device, model)
    if key not in _LIB:
        lib = _lib(model)
        vals = [ctypes.c_int(0) for _ in range(4)]
        _check(lib, lib.d3q27_step2_config(
            device, *[ctypes.byref(v) for v in vals]),
            "d3q27_step2 configuration query")
        smem, threads, per_sm, sms = (v.value for v in vals)
        if per_sm < 1:
            raise RuntimeError(f"d3q27_step2 ({threads} threads, {smem} B "
                               f"shared) fits no block on device {device}")
        _LIB[key] = {"smem": smem, "threads": threads,
                     "blocks_per_sm": per_sm, "sms": sms}
    return _LIB[key]


def step2_planes(shape, slots: int) -> int:
    """z planes per ``d3q27_step2`` block: a block runs step 1 on
    ``zc + 2`` planes and step 2 on ``zc``, the blocks of one (x, y)
    column split nz; take the ``zc`` with the fewest plane-passes over
    the waves of ``slots`` co-resident blocks."""
    nz, ny, nx = (int(s) for s in shape)
    columns = math.ceil(nx / 32) * math.ceil(ny / 8)

    def cost(zc):
        return math.ceil(columns * math.ceil(nz / zc) / slots) * (2 * zc + 2)
    return min(range(1, nz + 1), key=lambda zc: (cost(zc), -zc))


def _validate(fields, flags, ztab, a: StepArgs) -> None:
    shape = (a.nz, a.ny, a.nx)
    want = ((fields, torch.float32, (len(STORAGE[a.model]),) + shape),
            (flags, torch.int32, shape),
            (ztab, torch.float32, (len(ZONAL[a.model]), a.zone_max)))
    for t, dtype, sh in want:
        if t.device != fields.device or t.dtype != dtype \
                or tuple(t.shape) != sh or not t.is_contiguous():
            raise ValueError(
                f"d3q27 kernel input {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: needs contiguous {sh} {dtype} on "
                f"{fields.device}")


def _launch(name: str, fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    _validate(fields, flags, ztab, a)
    lib = _lib(a.model)
    dev = fields.device.index if fields.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    zc = 1
    if name == "d3q27_step2":
        cfg = step2_config(dev, a.model)
        zc = step2_planes((a.nz, a.ny, a.nx),
                          cfg["sms"] * cfg["blocks_per_sm"])
    out = torch.empty_like(fields)
    rc = getattr(lib, name)(fields.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), ztab.data_ptr(),
                            ctypes.byref(a.c_struct(zc)), dev, stream)
    _check(lib, rc, name)
    LAUNCHES[launch_key(name, a.model)] += 1
    return out


def step(fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    """One step (kernel ``d3q27_step``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1)
    return _launch("d3q27_step", fields, flags, ztab, a)


def step2(fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    """Two fused steps (kernel ``d3q27_step2``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 2)
    return _launch("d3q27_step2", fields, flags, ztab, a)


# kernel name -> (wrapper, steps one launch takes)
WRAPPERS = {"d3q27_step": (step, 1), "d3q27_step2": (step2, 2)}


# --------------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------------- #


def supports(model: Model, shape, dtype) -> bool:
    """Whether the kernels run this configuration: a model of ``MODELS``,
    3D, f32."""
    return (model.name in MODELS and len(shape) == 3
            and dtype == torch.float32 and min(int(s) for s in shape) >= 1)


def kernel_inputs(model: Model, state: LatticeState, params: SimParams
                  ) -> tuple:
    """``(fields, flags, ztab, args)`` as the engine hands them to a kernel
    wrapper, once per ``iterate`` call: the field stack, the int32 flags,
    the (rows, zone_max) table of the model's ``ZONAL`` settings, and the
    constants."""
    si = model.setting_index
    ztab = params.zone_table[[si[n] for n in ZONAL[model.name]]].contiguous()
    a = step_args(model, tuple(state.flags.shape),
                  params.settings.cpu().numpy())
    return state.fields.contiguous(), state.flags.contiguous(), ztab, a


def make_band_iterate(model: Model, shape, fuse: int = 2) -> Callable:
    """``iterate(state, params, niter)``: with ``fuse=2`` pairs of steps
    through ``step2`` and an odd last step through ``step``; with
    ``fuse=1`` every step through ``step``.  Globals come back zeroed."""
    if not supports(model, shape, torch.float32):
        raise ValueError(f"d3q27 kernels unsupported: {model.name} {shape}")
    if fuse not in (1, 2):
        raise ValueError(f"fuse={fuse}: only 1 and 2 exist")

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        f, flags, ztab, a = kernel_inputs(model, state, params)
        pairs = niter // 2 if fuse == 2 else 0
        for _ in range(pairs):
            f = step2(f, flags, ztab, a)
        for _ in range(niter - 2 * pairs):
            f = step(f, flags, ztab, a)
        return dataclasses.replace(state, fields=f,
                                   globals_=torch.zeros_like(state.globals_),
                                   iteration=state.iteration + niter)

    return iterate


def select_engine(model: Model, shape, dtype, series: bool = False
                  ) -> tuple:
    """``(iterate, tag)`` of the band engine at fuse 2 where ``supports()``
    accepts, else ``(None, None)``.  A <Control> time series (``series``)
    is rejected: these kernels read the zone table, not a per-step
    value."""
    if supports(model, shape, dtype) and not series:
        return (make_band_iterate(model, shape, fuse=2),
                f"cuda_d3q27_band[{model.name},fuse=2]")
    return None, None
