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

The TPU engines' ghost-row padding and (8,128) alignment are not carried
over: the kernels wrap periodically at any ``ny``, ``nx`` and mask the
ragged edge.  Like the TPU kernels they compute no globals (the engine's
trailing eager step does) and copy the BC planes through.
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
from tclb_tpu_torch.models import d2q9
from tclb_tpu_torch.ops import _cuda_build, lbm

KERNELS = ("d2q9_step", "d2q9_step2", "d2q9_resident8")
# launches per kernel; a wrapper adds one where it launches, nowhere else
LAUNCHES = {name: 0 for name in KERNELS}

RESIDENT_FUSE = 8               # steps per d2q9_resident8 launch
L2_BYTES = 50 * 1024 * 1024     # H100 L2
# boundary cases in the order the model applies them (csrc/d2q9.cu CASE_*)
CASES = ("Wall", "Solid", "EVelocity", "WPressure", "WVelocity",
         "EPressure", "TopSymmetry", "BottomSymmetry")


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
    ]


@dataclasses.dataclass(frozen=True)
class StepArgs:
    """The d2q9 step's constants, from the registry and the settings."""

    ny: int
    nx: int
    n_storage: int
    bc: tuple          # planes of BC[0], BC[1]
    ex: tuple
    ey: tuple
    opp: tuple
    w: tuple
    m: np.ndarray      # (6, 9) MRT basis rows 3..8
    minv: np.ndarray   # (9, 6) inverse-basis columns 3..8
    rate: tuple        # S3, S4, S56, S56, S78, S78
    gx: float
    gy: float
    cases: tuple       # (mask, value) per CASES entry
    mrt: tuple         # (mask, value) of MRT

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
        return c


def step_args(model: Model, shape, settings: np.ndarray) -> StepArgs:
    """Kernel constants for ``model`` at ``shape`` with the settings
    vector ``settings`` (registry order)."""
    E, M = d2q9.E, d2q9.M
    minv = lbm.inverse_basis(M)
    si = model.setting_index
    s = [float(settings[si[n]]) for n in ("S3", "S4", "S56", "S78")]
    nt = model.node_types
    return StepArgs(
        ny=int(shape[0]), nx=int(shape[1]), n_storage=model.n_storage,
        bc=tuple(int(i) for i in model.groups["BC"]),
        ex=tuple(int(v) for v in E[:, 0]), ey=tuple(int(v) for v in E[:, 1]),
        opp=tuple(int(v) for v in d2q9.OPP),
        w=tuple(float(v) for v in d2q9.W),
        m=M[3:].copy(), minv=minv[:, 3:].copy(),
        rate=(s[0], s[1], s[2], s[2], s[3], s[3]),
        gx=float(settings[si["GravitationX"]]),
        gy=float(settings[si["GravitationY"]]),
        cases=tuple((int(nt[n].mask), int(nt[n].value)) for n in CASES),
        mrt=(int(nt["MRT"].mask), int(nt["MRT"].value)))


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


def node_step_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations one step of d2q9 needs over a flag field:
    what the function takes, not what csrc/d2q9.cu executes (it also
    multiplies by the basis' zeros and by the unit streaming components).

    An MRT node: rho and j (8 + 5 + 5), two divisions, two equilibria
    (2 x 53), f - feq (9), the moment rows 3..8 of ``M`` over their
    nonzeros (46), the six rates, four force adds, and the inverse-basis
    columns 3..8 over their nonzeros onto the post-force equilibrium (76):
    267 in all, derived below from the same ``E``, ``W`` and ``M`` the
    kernels take.  A Zou/He node adds 21; bounce-back and symmetry only
    move values."""
    E, W, M = d2q9.E, d2q9.W, d2q9.M
    minv = lbm.inverse_basis(M)
    eq = _equilibrium_flops(E, W)
    mrt_flops = (_combo_flops(np.ones(len(W))) + _combo_flops(E[:, 0])
                 + _combo_flops(E[:, 1]) + 2 + 2 * eq + len(W)
                 + sum(_combo_flops(row) for row in M[3:]) + len(M) - 3
                 + 4 + sum(_combo_flops(row, onto=True)
                           for row in minv[:, 3:]))
    flags = np.asarray(flags).astype(np.int64)
    nt = model.node_types

    def count(name):
        t = nt[name]
        return int(((flags & t.mask) == t.value).sum())

    zou_he = sum(count(n) for n in ("EVelocity", "WPressure", "WVelocity",
                                    "EPressure"))
    return mrt_flops * count("MRT") + 21 * zou_he


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


def plain_steps(fields, flags, vel, den, a: StepArgs, n: int
                ) -> torch.Tensor:
    """``n`` NoGlobals d2q9 steps on the whole lattice: what ``step``
    (n=1), ``step2`` (n=2) and ``resident8`` (n=8) compute."""
    with torch.no_grad():
        for _ in range(n):
            fields = _plain_step(fields, flags, vel, den, a)
    return fields


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

_LIB: dict = {}    # the loaded library, once per process


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/d2q9.cu for sm_90a into build/tclb_tpu_torch/ (once per
    source content).  Returns the library path and the compiler's report
    (``-Xptxas -v``: registers, shared memory, spills per kernel)."""
    return _cuda_build.build("d2q9")


def _lib() -> ctypes.CDLL:
    if "lib" not in _LIB:
        path, _ = build()
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
        _LIB["lib"] = lib
    return _LIB["lib"]


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.d2q9_error_string(rc).decode()})")


def _validate(fields, flags, vel, den, a: StepArgs) -> None:
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
    lib = _lib()
    out = torch.empty_like(fields)
    dev, stream = _device_and_stream(fields)
    rc = getattr(lib, name)(fields.data_ptr(), out.data_ptr(),
                            flags.data_ptr(), vel.data_ptr(), den.data_ptr(),
                            ctypes.byref(a.c_struct), dev, stream)
    _check(lib, rc, name)
    LAUNCHES[name] += 1
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


def resident_grid(device: int, nodes: int) -> int:
    """Blocks of one cooperative ``d2q9_resident8`` launch: as many as
    the device holds at once, no more than the lattice needs.  Raises
    when the device cannot launch cooperative kernels."""
    key = ("capacity", device)
    if key not in _LIB:
        lib = _lib()
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
    lib = _lib()
    dev, stream = _device_and_stream(fields)
    blocks = resident_grid(dev, a.ny * a.nx)
    out = torch.empty_like(fields)
    scratch = torch.empty((9, a.ny, a.nx), dtype=fields.dtype,
                          device=fields.device)
    rc = lib.d2q9_resident8(fields.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), flags.data_ptr(),
                            vel.data_ptr(), den.data_ptr(),
                            ctypes.byref(a.c_struct), blocks, dev, stream)
    _check(lib, rc, "d2q9_resident8")
    LAUNCHES["d2q9_resident8"] += 1
    return out


# kernel name -> (wrapper, steps one launch takes)
WRAPPERS = {"d2q9_step": (step, 1), "d2q9_step2": (step2, 2),
            "d2q9_resident8": (resident8, RESIDENT_FUSE)}


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #


def supports(model: Model, shape, dtype) -> bool:
    """Whether the kernels run this configuration: ``d2q9``, 2D, f32."""
    return (model.name == "d2q9" and len(shape) == 2
            and dtype == torch.float32 and min(int(s) for s in shape) >= 1)


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
    flags, the zonal Velocity and Density planes gathered through the zone
    bits, and the constants."""
    flags = state.flags.contiguous()
    zones = (flags >> model.zone_shift).long()
    si = model.setting_index
    vel = params.zone_table[si["Velocity"]][zones].contiguous()
    den = params.zone_table[si["Density"]][zones].contiguous()
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


def select_engine(model: Model, shape, dtype) -> tuple:
    """``(iterate, tag)`` of the kernel engine ``supports()`` picks for
    this configuration, or ``(None, None)``: resident where it fits, else
    the band engine at fuse 2."""
    if supports_resident(model, shape, dtype):
        return (make_resident_iterate(model, shape),
                f"cuda_d2q9_resident[{model.name},fuse={RESIDENT_FUSE}]")
    if supports(model, shape, dtype):
        return (make_band_iterate(model, shape, fuse=2),
                f"cuda_d2q9_band[{model.name},fuse=2]")
    return None, None
