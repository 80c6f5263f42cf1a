"""Hand-written CUDA kernels for the d3q27_cumulant collide-stream step,
their plain PyTorch versions, and the engine ``Lattice`` builds from them.

Two kernels live in ``tclb_tpu_torch/csrc/d3q27.cu``; each wrapper below
launches its kernel for a CUDA tensor (or raises) and runs the plain
version for a CPU tensor, and counts its launches in ``LAUNCHES``:

``step`` (``d3q27_step``) replaces ``tclb_tpu/ops/pallas_d3q.py:
    make_pallas_iterate``'s single-step kernels (the ring kernel, and the
    block kernel that computes the same function).  One thread per node
    pulls its 27 populations straight from device memory with periodic
    indices.  Bound by bytes on this card: a node reads 34 planes and its
    flag and writes 34 planes (276 B) for about 540 flops (see
    ``node_step_flops``); neighbouring threads read neighbouring x.
``step2`` (``d3q27_step2``) replaces ``make_pallas_iterate``'s fused
    kernel at K=2.  A block owns a 32x8 (x, y) column over a run of z
    planes and marches up z, keeping a ring of three step-1 planes (the
    column extended by one node in x and y) in shared memory; step 2 of
    each plane reads that ring.  Bound by bytes, at the same bytes per
    launch as ``step`` for two steps; it recomputes the one-node ring of
    step 1 (34x10 for 32x8, 1.33x) and two extra planes per z run.

Both compute what ``pallas_d3q.py``'s ``_step`` computes for
``d3q27_cumulant``, minus globals: the periodic pull, the
``family.boundary_cases`` dispatch, the Buffer-layer omega, the cumulant
collision with force and Galilean correction where the COLLISION group is
set, SynthT copied through, and the avgP/avgU running averages.  Zonal
Velocity/Density/Turbulence come from the zone table through the flag's
zone bits, as the TPU's fused kernel rebuilds them.  f32 only.
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
from tclb_tpu_torch.models import d3q27_cumulant as d3q
from tclb_tpu_torch.models import family
from tclb_tpu_torch.ops import _cuda_build, cumulant, lbm

KERNELS = ("d3q27_step", "d3q27_step2")
# launches per kernel; a wrapper adds one where it launches, nowhere else
LAUNCHES = {name: 0 for name in KERNELS}

MODEL = "d3q27_cumulant"
# boundary cases in the order the model lists them (csrc/d3q27.cu CASE_*)
CASES = ("Wall", "Solid", "WVelocity", "WPressure", "EVelocity",
         "EPressure", "SVelocity", "SPressure", "SSymmetry", "NVelocity",
         "NPressure", "NSymmetry", "WVelocityTurbulent")
ZONAL = ("Velocity", "Density", "Turbulence")   # rows of the zone table
# the storage stack the kernels index by plane (csrc/d3q27.cu P_*)
STORAGE = tuple(f"f[{k}]" for k in range(27)) + (
    "SynthTX", "SynthTY", "SynthTZ", "avgP", "avgUX", "avgUY", "avgUZ")


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
        ("case_mask", ctypes.c_int * len(CASES)),
        ("case_val", ctypes.c_int * len(CASES)),
        ("coll_mask", ctypes.c_int),
        ("buffer_mask", ctypes.c_int), ("buffer_val", ctypes.c_int),
        ("zone_shift", ctypes.c_int), ("zone_max", ctypes.c_int),
        ("omega", ctypes.c_float), ("omega_buffer", ctypes.c_float),
        ("omega_bulk", ctypes.c_float), ("galilean", ctypes.c_float),
        ("force", ctypes.c_float * 3),
    ]


@dataclasses.dataclass(frozen=True)
class StepArgs:
    """The d3q27_cumulant step's constants, from the registry and the
    settings vector (registry order, at the lattice's precision)."""

    nz: int
    ny: int
    nx: int
    settings: tuple
    cases: tuple       # (mask, value) per CASES entry
    coll_mask: int
    buffer: tuple      # (mask, value) of Buffer
    zone_shift: int
    zone_max: int

    def _f32(self, name: str) -> np.float32:
        return np.float32(self.settings[
            _model().setting_index[name]])

    def c_struct(self, zc: int = 1) -> _CArgs:
        """The ``struct D3q27Args`` the kernels take, with ``zc`` z planes
        per ``d3q27_step2`` block (built once per ``zc``)."""
        cache = self.__dict__.setdefault("_c_structs", {})
        if zc not in cache:
            c = _CArgs()
            c.nz, c.ny, c.nx, c.zc = self.nz, self.ny, self.nx, zc
            c.case_mask[:] = [mv[0] for mv in self.cases]
            c.case_val[:] = [mv[1] for mv in self.cases]
            c.coll_mask = self.coll_mask
            c.buffer_mask, c.buffer_val = self.buffer
            c.zone_shift, c.zone_max = self.zone_shift, self.zone_max
            # the f32 arithmetic of the model's own expressions
            c.omega = self._f32("omega")
            c.omega_buffer = np.float32(1.0) / (
                np.float32(3.0) * self._f32("nubuffer") + np.float32(0.5))
            c.omega_bulk = self._f32("omega_bulk")
            c.galilean = self._f32("GalileanCorrection")
            c.force[:] = [float(self._f32(f"Force{a}")
                                + self._f32(f"Gravitation{a}"))
                          for a in "XYZ"]
            cache[zc] = c
        return cache[zc]


def _model() -> Model:
    from tclb_tpu_torch.models import get_model
    return get_model(MODEL)


def check_layout(model: Model) -> None:
    """The kernels' fixed population order and plane layout must be the
    model's (raises otherwise)."""
    if tuple(model.storage_names) != STORAGE:
        raise ValueError(f"{model.name}: storage {model.storage_names} is "
                         f"not the d3q27 kernels' {STORAGE}")
    if not np.array_equal(model.ei[:27], cumulant.velocity_set(3)):
        raise ValueError(f"{model.name}: f planes are not in the "
                         "tensor-product order of cumulant.velocity_set(3)")


def step_args(model: Model, shape, settings: np.ndarray) -> StepArgs:
    """Kernel constants for ``model`` at ``shape`` with the settings
    vector ``settings`` (registry order)."""
    check_layout(model)
    nt = model.node_types
    return StepArgs(
        nz=int(shape[0]), ny=int(shape[1]), nx=int(shape[2]),
        settings=tuple(float(v) for v in settings),
        cases=tuple((int(nt[n].mask), int(nt[n].value)) for n in CASES),
        coll_mask=int(model.group_masks["COLLISION"]),
        buffer=(int(nt["Buffer"].mask), int(nt["Buffer"].value)),
        zone_shift=int(model.zone_shift), zone_max=int(model.zone_max))


# --------------------------------------------------------------------------- #
# Bounds: operations and bytes
# --------------------------------------------------------------------------- #

# Operations of one node, counted on the arithmetic of ops/cumulant.py and
# ops/lbm.py (an add or a multiply each; multiplies by 0 and +-1 are not
# operations, and neither are products of settings alone):
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


def _nebb_flops(axis: int, turbulent: bool = False) -> int:
    """Operations of one ``lbm.nebb_boundary`` node on a d3q27 face: the
    tangential and outgoing sums, rho or un (4), the normal correction
    (rho un, then one multiply per unknown), per tangential axis its
    momentum sum, ``-3 q_t``, and a multiply-add per unknown that moves
    along it (plus ``3 rho v_t`` where a tangential velocity is imposed),
    and the unknowns' bounce-back adds; velocity and pressure faces count
    the same.  The turbulent inlet also forms its normal velocity and two
    tangential velocities (4)."""
    E = cumulant.velocity_set(3)
    en = E[:, axis]
    unknown = [k for k in range(27) if en[k] == 1]   # either side: 9
    tang = [k for k in range(27) if en[k] == 0]
    n = (len(tang) - 1) + (len(unknown) - 1) + 4 + 1 + len(unknown)
    for t in range(3):
        if t == axis:
            continue
        n += (sum(1 for k in tang if E[k, t]) - 1) + 1
        n += 2 * sum(1 for k in unknown if E[k, t])
        n += 3 if turbulent else 0
    n += len(unknown)
    return n + (4 if turbulent else 0)


def node_step_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations one step of d3q27_cumulant needs over a
    flag field (what the function takes, not what csrc/d3q27.cu
    executes)."""
    flags = np.asarray(flags).astype(np.int64)
    nt = model.node_types

    def count(name):
        t = nt[name]
        return int(((flags & t.mask) == t.value).sum())

    coll = int(((flags & model.group_masks["COLLISION"]) != 0).sum())
    n = NODE_FLOPS * flags.size + COLLISION_FLOPS * coll
    for face, axis in (("W", 0), ("E", 0), ("S", 1), ("N", 1)):
        n += _nebb_flops(axis) * (count(face + "Velocity")
                                  + count(face + "Pressure"))
    n += _nebb_flops(0, turbulent=True) * count("WVelocityTurbulent")
    return n


def launch_bytes(model: Model, shape) -> int:
    """Device-memory bytes one launch of either kernel must move: the
    field stack and the int32 flags read once, the zone table read once,
    the field stack written once."""
    n = int(np.prod(shape))
    return (2 * model.n_storage + 1) * 4 * n + len(ZONAL) * model.zone_max * 4


# --------------------------------------------------------------------------- #
# Plain PyTorch version (the kernels' function, whole-lattice tensor ops)
# --------------------------------------------------------------------------- #


def _plain_step(fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    """One NoGlobals d3q27_cumulant step on the whole lattice, exact
    periodic wrap: pallas_d3q.py's ``_step`` on the model's own pieces."""
    m = _model()
    si = m.setting_index
    nt = m.node_types
    sett = torch.tensor(a.settings, dtype=fields.dtype, device=fields.device)
    f = pull_stream(m, fields)[:27]
    zones = (flags >> a.zone_shift).long()
    vel, den, turb = (ztab[i][zones] for i in range(len(ZONAL)))
    synth = fields[27:30]
    turb_u = vel + turb * synth[0]
    extra = {"WVelocityTurbulent": lambda f: lbm.nebb_boundary(
        d3q.E, d3q.W, d3q.OPP, f, 0, +1, "velocity", turb_u,
        vt={1: turb * synth[1], 2: turb * synth[2]})}
    cases = family.boundary_cases(m, d3q.E, d3q.W, d3q.OPP, vel, den, extra)

    def is_type(name):
        return (flags & nt[name].mask) == nt[name].value

    f = family.dispatch_boundary_cases(cases, f, is_type)
    om = torch.where(is_type("Buffer"),
                     1.0 / (3.0 * sett[si["nubuffer"]] + 0.5),
                     sett[si["omega"]])
    force = tuple(sett[si[f"Force{x}"]] + sett[si[f"Gravitation{x}"]]
                  for x in "XYZ")
    Fp, rho, (ux, uy, uz) = cumulant.collide_d3q27(
        f.reshape((3, 3, 3) + f.shape[1:]), om, sett[si["omega_bulk"]],
        force=force, correlated=True,
        galilean=sett[si["GalileanCorrection"]])
    coll = (flags & a.coll_mask) != 0
    out = fields.clone()
    out[:27] = torch.where(coll[None], Fp.reshape(f.shape), f)
    out[30] = fields[30] + (rho - 1.0) / 3.0
    out[31:34] = fields[31:34] + torch.stack([ux, uy, uz])
    return out


def plain_steps(fields, flags, ztab, a: StepArgs, n: int) -> torch.Tensor:
    """``n`` NoGlobals d3q27_cumulant steps on the whole lattice: what
    ``step`` (n=1) and ``step2`` (n=2) compute."""
    with torch.no_grad():
        for _ in range(n):
            fields = _plain_step(fields, flags, ztab, a)
    return fields


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

_LIB: dict = {}    # the loaded library and per-device step2 set-ups


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/d3q27.cu for sm_90a into build/tclb_tpu_torch/ (once
    per source content).  Returns the library path and the compiler's
    report (``-Xptxas -v``: registers, shared memory, spills per kernel)."""
    return _cuda_build.build("d3q27")


def _lib() -> ctypes.CDLL:
    if "lib" not in _LIB:
        path, _ = build()
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
        _LIB["lib"] = lib
    return _LIB["lib"]


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.d3q27_error_string(rc).decode()})")


def step2_config(device: int) -> dict:
    """``d3q27_step2``'s dynamic shared memory, threads per block,
    co-resident blocks per SM and the device's SM count."""
    key = ("config", device)
    if key not in _LIB:
        lib = _lib()
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
    want = ((fields, torch.float32, (len(STORAGE),) + shape),
            (flags, torch.int32, shape),
            (ztab, torch.float32, (len(ZONAL), a.zone_max)))
    for t, dtype, sh in want:
        if t.device != fields.device or t.dtype != dtype \
                or tuple(t.shape) != sh or not t.is_contiguous():
            raise ValueError(
                f"d3q27 kernel input {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: needs contiguous {sh} {dtype} on "
                f"{fields.device}")


def _launch(name: str, fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    _validate(fields, flags, ztab, a)
    lib = _lib()
    dev = fields.device.index if fields.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    zc = 1
    if name == "d3q27_step2":
        cfg = step2_config(dev)
        zc = step2_planes((a.nz, a.ny, a.nx),
                          cfg["sms"] * cfg["blocks_per_sm"])
    out = torch.empty_like(fields)
    rc = getattr(lib, name)(fields.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), ztab.data_ptr(),
                            ctypes.byref(a.c_struct(zc)), dev, stream)
    _check(lib, rc, name)
    LAUNCHES[name] += 1
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
    """Whether the kernels run this configuration: ``d3q27_cumulant``, 3D,
    f32."""
    return (model.name == MODEL and len(shape) == 3
            and dtype == torch.float32 and min(int(s) for s in shape) >= 1)


def kernel_inputs(model: Model, state: LatticeState, params: SimParams
                  ) -> tuple:
    """``(fields, flags, ztab, args)`` as the engine hands them to a kernel
    wrapper, once per ``iterate`` call: the field stack, the int32 flags,
    the (3, zone_max) table of zonal Velocity, Density and Turbulence, and
    the constants."""
    si = model.setting_index
    ztab = params.zone_table[[si[n] for n in ZONAL]].contiguous()
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


def select_engine(model: Model, shape, dtype) -> tuple:
    """``(iterate, tag)`` of the band engine at fuse 2 where ``supports()``
    accepts, else ``(None, None)``."""
    if supports(model, shape, dtype):
        return (make_band_iterate(model, shape, fuse=2),
                f"cuda_d3q27_band[{model.name},fuse=2]")
    return None, None
