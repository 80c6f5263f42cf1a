"""Hand-written CUDA kernels of the generic 2D engine, their plain PyTorch
versions, and the engines ``Lattice`` builds from them.

The JAX package's generic engine (``tclb_tpu/ops/pallas_generic.py``) traces
a model's Python stage functions inside its Pallas kernels.  CUDA cannot
trace Python, so a model reaches these kernels through its device physics:
one ``__device__`` function per stage in ``csrc/models/<model>.cuh``,
compiled into the model-independent template ``csrc/generic2d.cu``
(streaming, the stage plan, node types, zonal settings, globals), built
once per model into a library of its own.  ``DEVICE_MODELS`` lists the
models that have such a header (``d2q9``, ``d2q9_kuper``, ``d2q9_heat_adj``
and the 3D ``d3q19_adj``, whose kernels ``ops/generic3d_kernels.py`` binds)
with the registry layout the header indexes by position.  ``d2q9`` takes
these kernels under a ``<Control>`` series only; without one its own
kernels (``ops/d2q9_kernels.py``) come first.

Two kernels and the series flavours of the first; each wrapper launches
its kernel for a CUDA tensor (or raises) and runs the plain version for a
CPU tensor, and counts its launches in ``LAUNCHES`` (the step kernels'
also by flavour in ``FLAVOUR_LAUNCHES``, read through ``flavours``; the
series flavours in ``SERIES_LAUNCHES``):

``step`` / ``step_globals`` (``generic2d_step``) replace
    ``make_pallas_iterate``'s ``call`` and its in-kernel-globals flavour
    ``call_g``: one whole Iteration per launch (a two-stage action runs
    stage 0 on the output tile plus a one-node ring into shared memory and
    stage 1 on the tile, a one-stage action its stage on the tile).  Bound
    by bytes (see ``launch_bytes`` and ``node_step_flops``).  The globals
    flavour also returns the last step's SUM globals, reduced in a fixed
    order (no float atomics).
``step_series`` / ``step_series_globals`` (``generic2d_step_series``)
    replace the ``<Control>`` time series flavours ``call_s`` and
    ``call_sg``: the same Iteration, with a zonal setting read from the
    series (its entry at the iteration before the step, modulo the
    horizon) where one overrides the node's zone.  The kernel takes the
    series table, a (zonal setting, zone) -> row map and the entry as
    launch arguments, so a series step moves the bytes of a plain step.
    The reference's ``_DT`` planes have no reader among the models with a
    device header, and no kernel computes them.
``resident`` (``generic2d_resident``) replaces ``make_resident_iterate``:
    an even number of Iterations in one cooperative launch, a grid barrier
    after each stage, two ping-pong buffers that stay in the L2 when the
    lattice fits half of it.

The storage ladder: ``step``, ``step_globals`` and ``resident`` also take
a bf16 stack at rest, launching ``generic2d_step_bf16`` and
``generic2d_resident_bf16`` (the same templates; counted in ``LAUNCHES``
under those names, and ``flavours("generic2d_step_bf16")``).  Each plane is
widened where it is read and narrowed where it is written, with the
lattice's DDF shifts (``StepArgs.shift``, from ``core/shift.py``), and
every stage computes in f32, so a step narrows once.  The series flavours
are f32 only.

The plain versions are the port's eager action step (``make_action_step``)
on the kernels' inputs; on a bf16 stack, the narrowed eager step
(``narrowed_step``: widen, the whole action, narrow) once per step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from tclb_tpu_torch.core import shift as ddf
from tclb_tpu_torch.core.lattice import (LatticeState, SimParams,
                                         make_action_step, narrowed_step)
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.ops import _cuda_build

KERNELS = ("generic2d_step", "generic2d_resident")
# the bf16 storage flavours of both kernels
BF16_KERNELS = ("generic2d_step_bf16", "generic2d_resident_bf16")
# launches per kernel (f32 and bf16); a wrapper adds one where it launches,
# nowhere else
LAUNCHES = {name: 0 for name in KERNELS + BF16_KERNELS}
# the step kernels' launches by flavour, as "<kernel>/<flavour>" (each also
# counts in LAUNCHES)
STEP_FLAVOURS = ("plain", "globals")
FLAVOUR_LAUNCHES = {f"{k}/{fl}": 0 for k in ("generic2d_step",
                                             "generic2d_step_bf16")
                    for fl in STEP_FLAVOURS}
# the <Control> series flavours (generic2d_step_series), counted apart
SERIES_KERNELS = ("generic2d_step_series", "generic2d_step_series_globals")
SERIES_LAUNCHES = {name: 0 for name in SERIES_KERNELS}

HALO = 2                        # action reach the step kernel's ring covers
RESIDENT_CHECK_STEPS = 8        # steps of the resident launch WRAPPERS holds
L2_BYTES = 50 * 1024 * 1024     # H100 L2


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """The registry layout a model's device header is written against:
    the names its enums list, in their order, and the stage plan it
    implements (``action_plan`` of the Iteration action)."""

    header: str
    storage: tuple
    settings: tuple
    node_types: tuple
    groups: tuple
    zonal: tuple
    globals_: tuple
    plan: tuple
    adjoint: bool = False    # the header has a reverse stage_b
    ndim: int = 2            # 3: built into csrc/generic3d.cu



DEVICE_MODELS = {
    "d2q9": DeviceModel(
        header="models/d2q9.cuh",
        storage=tuple(f"f[{k}]" for k in range(9)) + ("BC[0]", "BC[1]"),
        settings=("omega", "nu", "Velocity", "Density", "GravitationY",
                  "GravitationX", "S3", "S4", "S56", "S78",
                  "PressureLossInObj", "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "BottomSymmetry", "TopSymmetry", "MRT",
                    "Inlet", "Outlet"),
        groups=("BOUNDARY",),
        zonal=("Velocity", "Density"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 0),)),
    "d2q9_kuper": DeviceModel(
        header="models/d2q9_kuper.cuh",
        storage=tuple(f"f[{k}]" for k in range(9)) + ("phi",),
        settings=("omega", "nu", "InletVelocity", "Temperature", "FAcc",
                  "Magic", "MagicA", "MagicF", "GravitationX",
                  "GravitationY", "MovingWallVelocity", "Density",
                  "Wetting") + tuple(f"S{i}" for i in range(9))
        + ("WallForceXInObj", "WallForceYInObj"),
        node_types=("Wall", "Solid", "MovingWall", "NSymmetry",
                    "SSymmetry"),
        groups=("BOUNDARY", "COLLISION"),
        zonal=("Density",),
        globals_=("WallForceX", "WallForceY"),
        plan=(("BaseIteration", 1), ("CalcPhi", 0))),
    "d2q9_heat_adj": DeviceModel(
        header="models/d2q9_heat_adj.cuh",
        storage=tuple(f"f[{k}]" for k in range(9))
        + tuple(f"T[{k}]" for k in range(9)) + ("w",),
        settings=("omega", "nu", "InletVelocity", "InletTemperature",
                  "InitTemperature", "InletDensity", "FluidAlfa",
                  "SolidAlfa", "HeatSource", "Porocity", "HeatFluxInObj",
                  "HeatSourceTotalInObj", "MaterialInObj", "DragInObj"),
        node_types=("Wall", "Solid", "WVelocity", "EPressure", "Outlet"),
        groups=("COLLISION", "DESIGNSPACE"),
        zonal=("Porocity",),
        globals_=("HeatFlux", "HeatSourceTotal", "Material", "Drag"),
        plan=(("BaseIteration", 0),),
        adjoint=True),
    "d3q19_adj": DeviceModel(
        header="models/d3q19_adj.cuh",
        storage=tuple(f"f[{k}]" for k in range(19)) + ("w",),
        settings=("nu", "omega", "Velocity", "Density", "GravitationX",
                  "GravitationY", "GravitationZ", "S_high", "Porocity",
                  "PorocityGamma", "PressureLossInObj", "OutletFluxInObj",
                  "InletFluxInObj", "DragInObj", "LiftInObj",
                  "MaterialInObj", "MaterialPenaltyInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "NSymmetry", "SSymmetry", "Inlet",
                    "Outlet"),
        groups=("COLLISION", "DESIGNSPACE"),
        zonal=("Velocity", "Density", "Porocity"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux", "Drag", "Lift",
                  "Material", "MaterialPenalty"),
        plan=(("BaseIteration", 0),),
        adjoint=True, ndim=3),
}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLAVOUR_LAUNCHES, SERIES_LAUNCHES):
        for name in counts:
            counts[name] = 0


def flavours(kernel: str = "generic2d_step") -> dict:
    """A step kernel's launches by flavour: ``{"plain": n, "globals": m}``."""
    return {fl: FLAVOUR_LAUNCHES[f"{kernel}/{fl}"] for fl in STEP_FLAVOURS}


# --------------------------------------------------------------------------- #
# Registry-derived stage plan (pallas_generic.py:_stage_reach, action_plan)
# --------------------------------------------------------------------------- #


def stage_reach(model: Model, stage_name: str) -> int:
    """Reach of one stage's reads along y: the pull distance of the
    streamed densities (when the stage streams) and the declared Field
    stencils."""
    stage = model.stages[stage_name]
    r = 0
    if stage.load_densities:
        r = max((abs(int(d.dy)) for d in model.densities), default=0)
    for f in model.fields:
        r = max(r, abs(f.dy_range[0]), abs(f.dy_range[1]))
    return r


def action_plan(model: Model, action: str = "Iteration", fuse: int = 1
                ) -> tuple[list[tuple[str, int]], int]:
    """``fuse`` repetitions of an action as ``[(stage, out_ext)]`` in
    execution order, and the reach ``R`` of the input it needs: each stage
    computes ``out_ext`` nodes beyond the output so that every later
    stage's reads stay inside what was computed."""
    names = list(model.actions[action]) * fuse
    plan: list[tuple[str, int]] = [("", 0)] * len(names)
    ext = 0
    for i in range(len(names) - 1, -1, -1):
        plan[i] = (names[i], ext)
        ext += stage_reach(model, names[i])
    return plan, ext


def check_layout(model: Model) -> None:
    """The model's registry layout and plan must be the ones its device
    header indexes by position (raises otherwise)."""
    dm = DEVICE_MODELS[model.name]
    got = DeviceModel(
        header=dm.header, storage=tuple(model.storage_names),
        settings=tuple(s.name for s in model.settings),
        node_types=tuple(n for n in dm.node_types if n in model.node_types),
        groups=tuple(g for g in dm.groups if g in model.group_masks),
        zonal=tuple(model.zonal_settings),
        globals_=tuple(g.name for g in model.globals_),
        plan=tuple(action_plan(model)[0]), adjoint=dm.adjoint,
        ndim=model.ndim)
    if got != dm:
        raise ValueError(f"{model.name}: registry layout {got} is not the "
                         f"one {dm.header} is written against: {dm}")
    if any(g.op != "SUM" for g in model.globals_):
        raise ValueError(f"{model.name}: the kernels sum SUM globals only")


# --------------------------------------------------------------------------- #
# Arguments: everything a kernel reads besides the planes and the zone table
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def c_args_type(model: str) -> type:
    """Mirror of ``struct GenericArgs`` in csrc/generic_common.cuh (field
    for field), at the sizes of ``model``'s device header."""
    dm = DEVICE_MODELS[model]
    return type(f"GenericArgs_{model}", (ctypes.Structure,), {
        "_fields_": [
            ("nz", ctypes.c_int), ("ny", ctypes.c_int), ("nx", ctypes.c_int),
            ("zone_shift", ctypes.c_int), ("zone_max", ctypes.c_int),
            ("setting", ctypes.c_float * len(dm.settings)),
            ("nt_mask", ctypes.c_int * len(dm.node_types)),
            ("nt_val", ctypes.c_int * len(dm.node_types)),
            ("group_mask", ctypes.c_int * len(dm.groups)),
        ]})


@dataclasses.dataclass(frozen=True)
class StepArgs:
    """The step's constants, from the registry and the settings vector
    (registry order, at the lattice's precision)."""

    model: str
    ny: int
    nx: int
    settings: tuple
    node_types: tuple   # (mask, value) per DeviceModel.node_types entry
    groups: tuple       # mask per DeviceModel.groups entry
    zone_shift: int
    zone_max: int
    nz: int = 0         # 0 for a 2D lattice
    # a bf16 stack's per-plane DDF shifts (core/shift.py:kernel_shift),
    # None for a raw stack (and for every f32 one)
    shift: Optional[tuple] = None

    @property
    def shape(self) -> tuple:
        return (self.nz, self.ny, self.nx) if self.nz else (self.ny, self.nx)

    @functools.cached_property
    def c_shift(self):
        """The shifts as the bf16 kernels take them (or a null pointer)."""
        return ddf.c_shift(self.shift)

    def shift_block(self) -> Optional[np.ndarray]:
        """The shifts as :func:`tclb_tpu_torch.core.shift.widen_stack`
        takes them (the float32 block), or None."""
        return ddf.shift_block(self.shift, len(self.shape))

    @functools.cached_property
    def c_struct(self) -> ctypes.Structure:
        """The ``struct GenericArgs`` the kernels take (built once)."""
        c = c_args_type(self.model)()
        c.nz, c.ny, c.nx = max(self.nz, 1), self.ny, self.nx
        c.zone_shift, c.zone_max = self.zone_shift, self.zone_max
        c.setting[:] = [float(np.float32(v)) for v in self.settings]
        c.nt_mask[:] = [mv[0] for mv in self.node_types]
        c.nt_val[:] = [mv[1] for mv in self.node_types]
        c.group_mask[:] = list(self.groups)
        return c


def step_args(model: Model, shape, settings: np.ndarray) -> StepArgs:
    """Kernel constants for ``model`` at ``shape`` with the settings
    vector ``settings`` (registry order)."""
    check_layout(model)
    dm = DEVICE_MODELS[model.name]
    nt = model.node_types
    return StepArgs(
        model=model.name, nz=int(shape[0]) if len(shape) == 3 else 0,
        ny=int(shape[-2]), nx=int(shape[-1]),
        settings=tuple(float(v) for v in settings),
        node_types=tuple((int(nt[n].mask), int(nt[n].value))
                         for n in dm.node_types),
        groups=tuple(int(model.group_masks[g]) for g in dm.groups),
        zone_shift=int(model.zone_shift), zone_max=int(model.zone_max))


@dataclasses.dataclass(frozen=True)
class SeriesInputs:
    """A ``<Control>`` time series as the series flavours take it:
    ``row[j, z]`` is the row of ``ts`` that overrides zonal setting ``j``
    (``DeviceModel.zonal`` order) in zone ``z``, -1 where none does;
    ``ts`` is ``SimParams.time_series``."""

    row: torch.Tensor        # (n_zonal, zone_max) int32
    ts: torch.Tensor         # (n_series, T)

    @property
    def horizon(self) -> int:
        return int(self.ts.shape[1])


def series_inputs(model: Model, params: SimParams):
    """The lattice's series as :class:`SeriesInputs` (built on the host,
    once per ``iterate`` call), or None without one."""
    if params.time_series is None:
        return None
    zonal = {model.setting_index[n]: j
             for j, n in enumerate(model.zonal_settings)}
    row = np.full((len(zonal), model.zone_max), -1, dtype=np.int32)
    for si, z, r in params.series_map:
        row[zonal[si], z] = r
    ts = params.time_series
    return SeriesInputs(row=torch.as_tensor(row, device=ts.device),
                        ts=ts.contiguous())


def series_map_of(series: SeriesInputs, model: Model) -> tuple:
    """``SimParams.series_map`` of :class:`SeriesInputs`: the inverse of
    :func:`series_inputs`."""
    row = series.row.cpu().numpy()
    return tuple(sorted(
        (model.setting_index[model.zonal_settings[j]], int(z), int(row[j, z]))
        for j, z in zip(*np.nonzero(row >= 0))))


# --------------------------------------------------------------------------- #
# Bounds: operations and bytes
# --------------------------------------------------------------------------- #


def count_types(model: Model, flags: np.ndarray, *names: str) -> int:
    """Nodes of a flag field whose group field equals one of ``names``."""
    flags = np.asarray(flags).astype(np.int64)
    nt = model.node_types
    return sum(int(((flags & nt[n].mask) == nt[n].value).sum())
               for n in names)


def count_group(model: Model, flags: np.ndarray, group: str) -> int:
    """Nodes of a flag field with any bit of ``group`` set."""
    flags = np.asarray(flags).astype(np.int64)
    return int(((flags & model.group_masks[group]) != 0).sum())


def node_step_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations one Iteration of a ``DEVICE_MODELS``
    model needs over a flag field: what the function takes, not what
    csrc/generic2d.cu executes (it recomputes stage 0 on the ring)."""
    return {"d2q9": _d2q9_flops, "d2q9_kuper": _kuper_flops,
            "d2q9_heat_adj": _heat_adj_flops}[model.name](model, flags)


def _d2q9_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9 (models/d2q9.py): the step d2q9_kernels.node_step_flops counts
    (267 at an MRT node, 21 more at a Zou/He face), and at an Inlet or
    Outlet MRT node the objectives: ux / rho, |u|^2 (3) and the pressure
    loss (6)."""
    from tclb_tpu_torch.ops import d2q9_kernels
    flags64 = np.asarray(flags).astype(np.int64)
    nt = model.node_types
    mrt = (flags64 & nt["MRT"].mask) == nt["MRT"].value
    objective = sum(int((((flags64 & nt[n].mask) == nt[n].value) & mrt)
                        .sum()) for n in ("Inlet", "Outlet"))
    return d2q9_kernels.node_step_flops(model, flags) + 10 * objective


def _heat_adj_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_heat_adj (models/d2q9_heat_adj.py), every node: rho and j
    (8 + 5 + 5), two divisions, the equilibrium, 1 - w, the Brinkman
    velocity (2), the second equilibrium, temp (8), alfa (4), om_t (3),
    the source (1) and the temperature equilibrium (1 + 4 x 4 + 4 x 5); a
    collision node adds the two collisions (5 x 9 each) and |ux| (1 - w)
    (1); an Outlet node its heat flux (1); a WVelocity node its Zou/He
    closure (22) and inlet temperature (9), an EPressure node its closure
    (22)."""
    from tclb_tpu_torch.models.d2q9 import E, W
    from tclb_tpu_torch.ops.d2q9_kernels import _equilibrium_flops
    eq = _equilibrium_flops(E, W)
    every = 18 + 2 + eq + 1 + 2 + eq + 8 + 4 + 3 + 1 + (1 + 16 + 20)
    coll = count_group(model, flags, "COLLISION")
    return (every * int(np.asarray(flags).size) + (90 + 1) * coll
            + count_types(model, flags, "Outlet")
            + 31 * count_types(model, flags, "WVelocity")
            + 22 * count_types(model, flags, "EPressure"))


def _kuper_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_kuper (models/d2q9_kuper.py).

    A collision node: rho and j (8 + 5 + 5), two divisions, two equilibria
    (2 x 53), f - feq (9), ``M`` over its nonzeros, the nine keep factors,
    the inverse basis over its nonzeros and the add of feq2 (9), the forced
    velocity (2 x 3) and the force: per neighbour ``a phi_i^2 + (1 -
    2a) phi_i phi_0`` (5; ``1 - 2a`` is a product of settings), the shell
    weight on the four diagonals, ten adds into fx and fy, and the scale
    (2).  A Wall node adds its momentum (10), two doublings and two adds
    into the force and two into the globals; a MovingWall node the six
    corrected populations.  Every node runs CalcPhi: rho (8), the van der
    Waals pressure (17), and Magic, rho / 3, the difference, the clamp,
    the root and FAcc (6)."""
    from tclb_tpu_torch.models import d2q9_kuper as kuper
    from tclb_tpu_torch.ops import lbm
    from tclb_tpu_torch.ops.d2q9_kernels import (_combo_flops,
                                                 _equilibrium_flops)
    E, W, M = kuper.E, kuper.W, kuper.M
    minv = lbm.inverse_basis(M)
    eq = _equilibrium_flops(E, W)
    diagonals = int((E.astype(bool).sum(axis=1) == 2).sum())
    force = 5 * (len(E) - 1) + diagonals + 10 + 2
    collide = (_combo_flops(np.ones(len(W))) + _combo_flops(E[:, 0])
               + _combo_flops(E[:, 1]) + 2 + 2 * eq + len(W)
               + sum(_combo_flops(row) for row in M) + len(M)
               + sum(_combo_flops(row) for row in minv) + len(W) + 6
               + force)
    wall = _combo_flops(E[:, 0]) + _combo_flops(E[:, 1]) + 2 + 2 + 2
    calc_phi = _combo_flops(np.ones(len(W))) + 17 + 6
    coll = count_group(model, flags, "COLLISION")
    return (collide * coll + wall * count_types(model, flags, "Wall")
            + int(np.count_nonzero(E[:, 0]))
            * count_types(model, flags, "MovingWall")
            + calc_phi * int(np.asarray(flags).size))


def launch_bytes(model: Model, shape, n_series: int = 0,
                 itemsize: int = 4) -> int:
    """Device-memory bytes one launch of either kernel must move: the
    field stack (``itemsize`` bytes a value at rest) and the int32 flags
    read once, the zone table read once, the field stack written once (the
    resident kernel's steps stay in the L2).  A series flavour's launch
    under ``n_series`` series also reads the row map (int32, the zone
    table's size) and one entry of each series."""
    n = int(np.prod(shape))
    zonal = len(model.zonal_settings)
    table = zonal * model.zone_max * 4
    series = table + 4 * n_series if n_series else 0
    return (2 * model.n_storage * itemsize + 4) * n + table + series


# --------------------------------------------------------------------------- #
# Plain PyTorch versions: the port's eager action step on the kernels' inputs
# --------------------------------------------------------------------------- #


def _get_model(name: str) -> Model:
    from tclb_tpu_torch.models import get_model
    return get_model(name)


@functools.lru_cache(maxsize=None)
def _action_step(name: str, compute_globals: bool) -> Callable:
    return make_action_step(_get_model(name), "Iteration",
                            compute_globals=compute_globals)


def _plain_params(ztab, a: StepArgs, series=None) -> SimParams:
    """The settings vector and a zone table whose zonal rows are
    ``ztab``, with the time series of :class:`SeriesInputs` ``series``."""
    m = _get_model(a.model)
    sett = torch.tensor(a.settings, dtype=ztab.dtype, device=ztab.device)
    table = sett[:, None].expand(len(a.settings), a.zone_max).clone()
    for j, name in enumerate(m.zonal_settings):
        table[m.setting_index[name]] = ztab[j]
    if series is None:
        return SimParams(settings=sett, zone_table=table)
    return SimParams(settings=sett, zone_table=table, time_series=series.ts,
                     series_map=series_map_of(series, m))


def plain_steps(fields, flags, ztab, a: StepArgs, n: int,
                with_globals: bool = False, series=None, it: int = 0):
    """``n`` Iterations on the whole lattice: what ``step`` (n=1) and
    ``resident`` (n steps) compute, and with ``with_globals`` what
    ``step_globals`` computes (n=1): then ``(fields, globals)``, the last
    step's globals.  Under :class:`SeriesInputs` ``series`` the steps
    start at iteration ``it``: what ``step_series`` and
    ``step_series_globals`` compute (n=1).  On a bf16 stack each step is
    the narrowed eager step (widen with ``a.shift``, the action in f32,
    narrow): what ``generic2d_step_bf16`` and ``generic2d_resident_bf16``
    compute."""
    m = _get_model(a.model)
    params = _plain_params(ztab, a, series)
    narrow = fields.dtype != ztab.dtype
    state = LatticeState(
        fields=fields, flags=flags,
        globals_=torch.zeros((m.n_globals,), dtype=ztab.dtype,
                             device=fields.device), iteration=int(it))
    with torch.no_grad():
        for i in range(n):
            full = with_globals and i == n - 1
            step = _action_step(a.model, full)
            if narrow:
                step = narrowed_step(step, fields.dtype, a.shift_block())
            state = step(state, params)
    return (state.fields, state.globals_) if with_globals else state.fields


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

# model -> its loaded library, step tile and per-device resident grids
_LIB: dict = {}


def build(model: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/generic2d.cu (csrc/generic3d.cu for a 3D model) with
    ``model``'s device header for sm_90a into build/tclb_tpu_torch/ (once
    per source content).  Returns the library path and the compiler's
    report (``-Xptxas -v``)."""
    dm = DEVICE_MODELS[model]
    return _cuda_build.build(f"generic{dm.ndim}d", dm.header)


def lib(model: str) -> ctypes.CDLL:
    """``model``'s generic library, built and bound at first use; its
    layout sizes are checked against ``DEVICE_MODELS``."""
    entry = _LIB.setdefault(model, {})
    if "lib" not in entry:
        dm = DEVICE_MODELS[model]
        if dm.ndim != 2:
            raise ValueError(f"{model} is a 3D model: its kernels are "
                             "ops/generic3d_kernels.py's")
        path, _ = build(model)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        argp = ctypes.POINTER(c_args_type(model))
        lib.generic2d_layout.argtypes = [ip] * 8
        lib.generic2d_layout.restype = None
        lib.generic2d_step.argtypes = [p, p, p, p, argp, p, p, i, p]
        lib.generic2d_step.restype = i
        lib.generic2d_step_series.argtypes = [p, p, p, p, argp, p, p, i, i,
                                              p, p, i, p]
        lib.generic2d_step_series.restype = i
        lib.generic2d_resident.argtypes = [p, p, p, p, p, argp, i, i, i, p]
        lib.generic2d_resident.restype = i
        fp = ctypes.POINTER(ctypes.c_float)
        lib.generic2d_step_bf16.argtypes = [p, p, p, p, argp, fp, p, p, i, p]
        lib.generic2d_step_bf16.restype = i
        lib.generic2d_resident_bf16.argtypes = [p, p, p, p, p, p, argp, fp,
                                                i, i, i, p]
        lib.generic2d_resident_bf16.restype = i
        lib.generic2d_resident_capacity.argtypes = [i, i, ip, ip]
        lib.generic2d_resident_capacity.restype = i
        lib.generic_error_string.argtypes = [i]
        lib.generic_error_string.restype = ctypes.c_char_p
        if dm.adjoint:
            lib.generic2d_step_b.argtypes = [p, p, p, argp, p, p, p, p, i, p]
            lib.generic2d_step_b.restype = i
            lib.generic2d_step_b_tile.argtypes = [ip, ip]
            lib.generic2d_step_b_tile.restype = None
            by, bx = ctypes.c_int(0), ctypes.c_int(0)
            lib.generic2d_step_b_tile(ctypes.byref(by), ctypes.byref(bx))
            entry["tile_b"] = (by.value, bx.value)
        vals = [ctypes.c_int(0) for _ in range(8)]
        lib.generic2d_layout(*[ctypes.byref(v) for v in vals])
        tile_y, tile_x, *sizes = (v.value for v in vals)
        want = [len(dm.storage), len(dm.settings), len(dm.node_types),
                len(dm.groups), len(dm.zonal), len(dm.globals_)]
        if sizes != want:
            raise RuntimeError(f"{path.name} was built with layout sizes "
                               f"{sizes}, the wrapper expects {want}")
        entry["tile"] = (tile_y, tile_x)
        entry["lib"] = lib
    return entry["lib"]


def check(lib, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.generic_error_string(rc).decode()})")


def validate(fields, flags, ztab, a: StepArgs) -> None:
    """The kernels' inputs: contiguous fields (f32, or bf16 at rest with
    the shifts in ``a``) and f32 zone table and int32 flags on one device,
    at the shapes of ``a.model``'s header."""
    if a.model not in DEVICE_MODELS:
        raise ValueError(f"no generic kernels for {a.model} (device "
                         f"headers: {sorted(DEVICE_MODELS)})")
    dm = DEVICE_MODELS[a.model]
    shape = a.shape
    sdt = fields.dtype if fields.dtype in ddf.STORAGE_DTYPES \
        else torch.float32
    if a.shift is not None and (sdt == torch.float32
                                or len(a.shift) != len(dm.storage)):
        raise ValueError(f"a shift of {len(a.shift)} planes is for a bf16 "
                         f"stack of {len(dm.storage)}; got {fields.dtype}")
    want = ((fields, sdt, (len(dm.storage),) + shape),
            (flags, torch.int32, shape),
            (ztab, torch.float32, (len(dm.zonal), a.zone_max)))
    for t, dtype, sh in want:
        if t.device != fields.device or t.dtype != dtype \
                or tuple(t.shape) != sh or not t.is_contiguous():
            raise ValueError(
                f"generic kernel input {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: needs contiguous {sh} {dtype} on "
                f"{fields.device}")


def series_args(series: SeriesInputs, a: StepArgs, it: int,
                device: torch.device) -> tuple:
    """``(row, ts, T, t)`` as the series flavours take them: the row map
    and the table (contiguous int32 and f32 on ``device``) and the entry
    ``t = it mod T`` of this step."""
    dm = DEVICE_MODELS[a.model]
    want = ((series.row, torch.int32, (len(dm.zonal), a.zone_max)),
            (series.ts, torch.float32, tuple(series.ts.shape)))
    for t, dtype, sh in want:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != sh \
                or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"series input {tuple(t.shape)} {t.dtype} on {t.device}: "
                f"needs contiguous {sh} {dtype} on {device}")
    T = series.horizon
    if T < 1:
        raise ValueError("a Control series needs a horizon of at least 1")
    return series.row.data_ptr(), series.ts.data_ptr(), T, int(it) % T


def device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _launch_step(fields, flags, ztab, a: StepArgs, with_globals: bool,
                 series=None, it: int = 0):
    """One ``generic2d_step`` launch (``generic2d_step_bf16`` for a bf16
    stack), or with :class:`SeriesInputs` ``series`` one
    ``generic2d_step_series`` launch at iteration ``it``."""
    validate(fields, flags, ztab, a)
    bf16 = fields.dtype == torch.bfloat16
    if series is not None:
        if bf16:
            raise ValueError("the series flavours take f32 storage only")
        sargs = series_args(series, a, it, fields.device)
    lb = lib(a.model)
    dev, stream = device_and_stream(fields)
    out = torch.empty_like(fields)
    partials = gout = None
    if with_globals:
        ty, tx = _LIB[a.model]["tile"]
        blocks = -(-a.ny // ty) * -(-a.nx // tx)
        n_g = len(DEVICE_MODELS[a.model].globals_)
        partials = torch.empty((blocks, max(n_g, 1)), dtype=torch.float64,
                               device=fields.device)
        gout = torch.empty((n_g,), dtype=torch.float32, device=fields.device)
    head = (fields.data_ptr(), out.data_ptr(), flags.data_ptr(),
            ztab.data_ptr(), ctypes.byref(a.c_struct))
    tail = (partials.data_ptr() if with_globals else None,
            gout.data_ptr() if with_globals else None, dev, stream)
    if series is None:
        name = "generic2d_step_bf16" if bf16 else "generic2d_step"
        fn = getattr(lb, name)
        check(lb, fn(*head, a.c_shift, *tail) if bf16 else fn(*head, *tail),
              name)
        LAUNCHES[name] += 1
        FLAVOUR_LAUNCHES[f"{name}/{STEP_FLAVOURS[with_globals]}"] += 1
    else:
        check(lb, lb.generic2d_step_series(*head, *sargs, *tail),
              "generic2d_step_series")
        SERIES_LAUNCHES[SERIES_KERNELS[1 if with_globals else 0]] += 1
    return (out, gout) if with_globals else out


def step(fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    """One Iteration (kernel ``generic2d_step``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1)
    return _launch_step(fields, flags, ztab, a, with_globals=False)


def step_globals(fields, flags, ztab, a: StepArgs) -> tuple:
    """One Iteration and its SUM globals (kernel ``generic2d_step``, the
    globals flavour): ``(fields, globals)``."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1, with_globals=True)
    return _launch_step(fields, flags, ztab, a, with_globals=True)


def step_series(fields, flags, ztab, a: StepArgs, series: SeriesInputs,
                it: int) -> torch.Tensor:
    """One Iteration at iteration ``it`` under a Control series (kernel
    ``generic2d_step_series``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1, series=series, it=it)
    return _launch_step(fields, flags, ztab, a, False, series, it)


def step_series_globals(fields, flags, ztab, a: StepArgs,
                        series: SeriesInputs, it: int) -> tuple:
    """One Iteration at iteration ``it`` under a Control series and its
    SUM globals (kernel ``generic2d_step_series``, the globals flavour):
    ``(fields, globals)``."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1, with_globals=True,
                           series=series, it=it)
    return _launch_step(fields, flags, ztab, a, True, series, it)


def resident_grid(model: str, device: int, nodes: int,
                  bf16: bool = False) -> int:
    """Blocks of one cooperative ``generic2d_resident`` (``bf16``:
    ``generic2d_resident_bf16``) launch of ``model``'s library: as many as
    the device holds at once, no more than the lattice needs.  Raises when
    the device cannot launch cooperative kernels."""
    lb = lib(model)
    entry = _LIB[model]
    key = ("capacity", device, bf16)
    if key not in entry:
        coop, blocks = ctypes.c_int(0), ctypes.c_int(0)
        check(lb, lb.generic2d_resident_capacity(
            device, int(bf16), ctypes.byref(coop), ctypes.byref(blocks)),
            "generic2d_resident capacity query")
        if not coop.value:
            raise RuntimeError(f"CUDA device {device} cannot launch "
                               "cooperative kernels (cudaDevAttr"
                               "CooperativeLaunch is 0)")
        if blocks.value < 1:
            raise RuntimeError("generic2d_resident fits no block on device "
                               f"{device}")
        entry[key] = blocks.value
    return min(entry[key], (nodes + 255) // 256)


def resident(fields, flags, ztab, a: StepArgs, nsteps: int) -> torch.Tensor:
    """``nsteps`` Iterations (even, at least 2) in one cooperative launch
    (kernel ``generic2d_resident``; ``generic2d_resident_bf16`` for a bf16
    stack, with an f32 scratch stack that carries a two-stage model's
    stage-0 planes to stage 1)."""
    if nsteps < 2 or nsteps % 2:
        raise ValueError(f"nsteps={nsteps}: the ping-pong needs an even "
                         "count of at least 2")
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, nsteps)
    validate(fields, flags, ztab, a)
    lb = lib(a.model)
    dev, stream = device_and_stream(fields)
    bf16 = fields.dtype == torch.bfloat16
    blocks = resident_grid(a.model, dev, a.ny * a.nx, bf16)
    out = torch.empty_like(fields)
    scratch = torch.empty_like(fields)
    if bf16:
        two = len(DEVICE_MODELS[a.model].plan) == 2
        mid = torch.empty(fields.shape if two else (0,),
                          dtype=torch.float32, device=fields.device)
        rc = lb.generic2d_resident_bf16(
            fields.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            mid.data_ptr() if two else None, flags.data_ptr(),
            ztab.data_ptr(), ctypes.byref(a.c_struct), a.c_shift, nsteps,
            blocks, dev, stream)
        check(lb, rc, "generic2d_resident_bf16")
        LAUNCHES["generic2d_resident_bf16"] += 1
        return out
    rc = lb.generic2d_resident(
        fields.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        flags.data_ptr(), ztab.data_ptr(), ctypes.byref(a.c_struct),
        nsteps, blocks, dev, stream)
    check(lb, rc, "generic2d_resident")
    LAUNCHES["generic2d_resident"] += 1
    return out


def _resident_checked(fields, flags, ztab, a: StepArgs) -> torch.Tensor:
    return resident(fields, flags, ztab, a, RESIDENT_CHECK_STEPS)


# kernel name -> (wrapper, steps one launch takes); the resident kernel at
# the step count its checks use
WRAPPERS = {"generic2d_step": (step, 1),
            "generic2d_resident": (_resident_checked, RESIDENT_CHECK_STEPS)}


# --------------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------------- #


def supports(model: Model, shape, dtype, storage_dtype=None) -> bool:
    """Whether the kernels run this configuration: a 2D model with device
    physics (``DEVICE_MODELS``), f32 compute with the stack at rest in f32
    or bf16 (``storage_dtype``, default ``dtype``), whose Iteration plan
    reaches no further than the step kernel's ring."""
    sdt = dtype if storage_dtype is None else storage_dtype
    return (model.name in DEVICE_MODELS and model.ndim == 2
            and len(shape) == 2 and dtype == torch.float32
            and sdt in ddf.STORAGE_DTYPES
            and min(int(s) for s in shape) >= 1
            and action_plan(model)[1] <= HALO)


def supports_resident(model: Model, shape, dtype, series: bool = False,
                      storage_dtype=None) -> bool:
    """Whether the resident engine fits: the two ping-pong stacks (at the
    storage itemsize) plus the flags within half of the L2.  Not under a
    Control series (``series``): its launch runs many Iterations on one
    zone table."""
    sdt = dtype if storage_dtype is None else storage_dtype
    return (not series and supports(model, shape, dtype, sdt)
            and launch_bytes(model, shape, itemsize=sdt.itemsize)
            <= L2_BYTES // 2)


def kernel_inputs(model: Model, state: LatticeState, params: SimParams,
                  shift: Optional[tuple] = None) -> tuple:
    """``(fields, flags, ztab, args)`` as the engines hand them to a kernel
    wrapper, once per ``iterate`` call: the field stack, the int32 flags,
    the (n_zonal, zone_max) table of the zonal settings, and the
    constants, with a bf16 stack's DDF shifts ``shift``
    (:func:`tclb_tpu_torch.core.shift.kernel_shift`)."""
    si = model.setting_index
    ztab = params.zone_table[[si[n] for n in model.zonal_settings]]
    a = step_args(model, tuple(state.flags.shape),
                  params.settings.cpu().numpy())
    if shift is not None:
        a = dataclasses.replace(a, shift=tuple(shift))
    return (state.fields.contiguous(), state.flags.contiguous(),
            ztab.contiguous(), a)


def _band_steps(f, flags, ztab, a: StepArgs, n: int) -> tuple:
    """``n >= 1`` Iterations on ``generic2d_step``: ``n - 1`` plain
    launches, then the globals flavour.  Returns ``(fields, globals)``."""
    for _ in range(n - 1):
        f = step(f, flags, ztab, a)
    return step_globals(f, flags, ztab, a)


def series_steps(f, flags, ztab, a: StepArgs, series: SeriesInputs,
                 it: int, n: int, one: Callable, last: Callable) -> tuple:
    """``n >= 1`` Iterations from iteration ``it`` under a Control series:
    ``n - 1`` launches of the series flavour ``one``, then the series +
    globals flavour ``last`` (pallas_generic.py's ``call_s`` and
    ``call_sg`` at fuse 1).  Returns ``(fields, globals)``."""
    for k in range(n - 1):
        f = one(f, flags, ztab, a, series, it + k)
    return last(f, flags, ztab, a, series, it + n - 1)


def _advanced(state: LatticeState, fields, globals_, niter: int
              ) -> LatticeState:
    return dataclasses.replace(state, fields=fields,
                               globals_=globals_.to(state.globals_.dtype),
                               iteration=state.iteration + niter)


def storage_tag(storage_dtype=torch.float32, storage_repr: str = "raw"
                ) -> str:
    """The storage part of an engine tag: empty for f32, else
    ``,bfloat16/shifted`` (or ``/raw``)."""
    if storage_dtype in (None, torch.float32):
        return ""
    return f",{ddf.dtype_name(storage_dtype)}/{storage_repr}"


def engine_shift(model: Model, storage_dtype, storage_repr: str):
    """The shifts an engine hands its kernels: None for f32 storage."""
    if storage_dtype in (None, torch.float32):
        return None
    return ddf.kernel_shift(model, storage_repr)


def make_band_iterate(model: Model, shape, storage_dtype=torch.float32,
                      storage_repr: str = "raw") -> Callable:
    """``iterate(state, params, niter)`` on ``generic2d_step``: ``niter -
    1`` plain launches, then one globals launch, so the state comes back
    with the last step's globals (``full_globals``).  Under a Control
    series the same on the series flavours (``supports_series``, f32 storage
    only).  A bf16 stack (``storage_dtype``) runs ``generic2d_step_bf16``
    with the shifts of ``storage_repr``."""
    if not supports(model, shape, torch.float32, storage_dtype):
        raise ValueError(f"generic kernels unsupported: {model.name} "
                         f"{shape} {storage_dtype}")
    shift = engine_shift(model, storage_dtype, storage_repr)
    narrowed = storage_dtype != torch.float32

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        if niter <= 0:
            return state
        f, flags, ztab, a = kernel_inputs(model, state, params, shift)
        series = series_inputs(model, params)
        if series is None:
            f, g = _band_steps(f, flags, ztab, a, niter)
        else:
            f, g = series_steps(f, flags, ztab, a, series, state.iteration,
                                niter, step_series, step_series_globals)
        return _advanced(state, f, g, niter)

    iterate.full_globals = True
    iterate.supports_series = not narrowed
    return iterate


def make_resident_iterate(model: Model, shape, storage_dtype=torch.float32,
                          storage_repr: str = "raw") -> Callable:
    """``iterate(state, params, niter)``: the even part of ``niter - 1``
    steps in one ``generic2d_resident`` launch, the rest on the band
    engine, whose last launch is the globals flavour
    (pallas_generic.py:make_resident_iterate's composition).  A bf16 stack
    runs the bf16 flavours of both kernels."""
    if not supports_resident(model, shape, torch.float32,
                             storage_dtype=storage_dtype):
        raise ValueError(f"generic resident engine unsupported: "
                         f"{model.name} {shape} {storage_dtype}")
    shift = engine_shift(model, storage_dtype, storage_repr)

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        if niter <= 0:
            return state
        f, flags, ztab, a = kernel_inputs(model, state, params, shift)
        main = (niter - 1) // 2 * 2
        if main:
            f = resident(f, flags, ztab, a, main)
        f, g = _band_steps(f, flags, ztab, a, niter - main)
        return _advanced(state, f, g, niter)

    iterate.full_globals = True
    return iterate


def select_engine(model: Model, shape, dtype, series: bool = False,
                  storage_dtype=None, storage_repr: str = "raw") -> tuple:
    """``(iterate, tag)`` of the kernel engine ``supports()`` picks for
    this configuration, or ``(None, None)``: resident where it fits (one
    launch fuses the even part of each call's ``niter - 1`` steps: the tag's
    ``fuse=N``), else the band engine; under a Control series
    (``series``) the band engine, f32 storage only.  A bf16 stack
    (``storage_dtype``) is named in the tag: ``cuda_generic_band[d2q9,
    fuse=1,bfloat16/shifted]``."""
    sdt = dtype if storage_dtype is None else storage_dtype
    tag = storage_tag(sdt, storage_repr)
    if series and sdt != torch.float32:
        return None, None
    if supports_resident(model, shape, dtype, series, sdt):
        return (make_resident_iterate(model, shape, sdt, storage_repr),
                f"cuda_generic_resident[{model.name},fuse=N{tag}]")
    if supports(model, shape, dtype, sdt):
        return (make_band_iterate(model, shape, sdt, storage_repr),
                f"cuda_generic_band[{model.name},fuse=1{tag}]")
    return None, None
