"""Hand-written CUDA kernels of the generic 2D engine, their plain PyTorch
versions, and the engines ``Lattice`` builds from them.

The JAX package's generic engine (``tclb_tpu/ops/pallas_generic.py``) traces
a model's Python stage functions inside its Pallas kernels.  CUDA cannot
trace Python, so a model reaches these kernels through its device physics:
one ``__device__`` function per stage in ``csrc/models/<model>.cuh``,
compiled into the model-independent template ``csrc/generic2d.cu``
(streaming, the stage plan, node types, zonal settings, globals), built
once per model into a library of its own.  ``DEVICE_MODELS`` lists the
models that have such a header (``d2q9``, ``d2q9_kuper``, the one-stage 2D
models ``d2q9_heat``, ``d2q9_heat_conjugate``, ``d2q9_hb``, ``sw``,
``d2q9_solid`` and ``d2q9_npe_guo``, the multi-stage 2D models
``d2q9_pf_pressureEvolution``, ``d2q9_pp_MCMP``, ``d2q9_lee`` and
``d2q9_poison_boltzmann``, the 2D adjoint models ``d2q9_heat_adj``,
``d2q9_adj``, ``d2q9_optimalMixing`` and ``d2q9_plate``, the phase-field,
pseudopotential and design models ``wave``, ``wave2d``, ``d2q9_diff``,
``d2q9_pf``, ``d2q9_pp_LBL`` and ``d2q9_pf_curvature``, and the 3D
``d3q19_adj``, ``d3q19_heat``, ``d3q27``, ``d3q27_viscoplastic``,
``d3q27_cumulant_qibb_small`` and ``d3q19_kuper``, whose kernels
``ops/generic3d_kernels.py`` binds) with the registry layout the header
indexes by position.  ``d2q9`` takes
these kernels under a ``<Control>`` series only; without one its own
kernels (``ops/d2q9_kernels.py``) come first.

Two kernels and the series flavours of the first; each wrapper launches
its kernel for a CUDA tensor (or raises) and runs the plain version for a
CPU tensor, and counts its launches in ``LAUNCHES`` (the step kernels'
also by flavour in ``FLAVOUR_LAUNCHES``, read through ``flavours``; the
series flavours in ``SERIES_LAUNCHES``):

``step`` / ``step_globals`` (``generic2d_step``) replace
    ``make_pallas_iterate``'s ``call`` and its in-kernel-globals flavour
    ``call_g``: one whole Iteration per call, in one launch.  A one-stage
    action runs its stage one node a thread, its pulls from device memory
    (the pass form; for a mid-sized header in narrower blocks, three an
    SM: the narrow pass), or, over many planes, from its tile's planes
    staged in shared memory (the tiled form, ``tiled_tile``); a
    two-stage action whose first stage computes a ring of at most two
    nodes runs it on a 32x32 tile into shared memory and stage 1 on the
    tile's inner nodes from there (the ring form, ``ring_tile``); any
    other plan (three stages, a wider ring) takes the staged form: a
    block stages its tile plus the plan's reach into shared memory once
    and runs every stage from there (``staged_tile``).  ``step_form``
    names the form.  Bound by bytes
    (see ``launch_bytes`` and ``node_step_flops``).  The globals flavour
    also returns the last step's SUM globals, reduced in a fixed order (no
    float atomics).
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
    an even number of Iterations in one cooperative launch.  Each block
    owns its tiles (``resident_tile``) for the whole launch and runs a
    step's stages on them as the staged form does, the earlier stages'
    planes in shared memory; instead of a grid barrier a stage, it
    publishes each step in a counter and waits only for the blocks whose
    tiles lie within ``HALO`` of its own.  Two ping-pong buffers stay in
    the L2 when the lattice fits half of it.

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

HALO = 8                        # the largest action reach the engines take
                                # (pallas_generic.py:_HALO)
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



def _d2q9_groups(*names: str) -> tuple:
    """Storage names of d2q9 groups, nine planes each, in order."""
    return tuple(f"{n}[{k}]" for n in names for k in range(9))


# the registry entries d2q9_heat_physics.cuh reads, common to its builds
_HEAT_SETTINGS = ("omega", "nu", "InletVelocity", "InletPressure",
                  "InletDensity", "InletTemperature", "InitTemperature",
                  "FluidAlfa", "HeaterTemperature")
_HEAT_TYPES = ("Heater", "Wall", "Solid", "WVelocity", "WPressure",
               "EPressure", "EVelocity", "Outlet")

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
    # d2q9_kuper with the design density wd (d2q9_kuper.cuh built with
    # KUPER_DESIGN) and the reverse of both stages
    "d2q9_kuper_adj": DeviceModel(
        header="models/d2q9_kuper_adj.cuh",
        storage=tuple(f"f[{k}]" for k in range(9)) + ("wd", "phi"),
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
        plan=(("BaseIteration", 1), ("CalcPhi", 0)),
        adjoint=True),
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
    # the one-stage 2D models (csrc/models/d2q9_common.cuh's building
    # blocks); the two built on d2q9_heat share d2q9_heat_physics.cuh
    "d2q9_heat": DeviceModel(
        header="models/d2q9_heat.cuh",
        storage=_d2q9_groups("f", "T"),
        settings=_HEAT_SETTINGS + ("OutFluxInObj",),
        node_types=_HEAT_TYPES, groups=("COLLISION",),
        zonal=("HeaterTemperature",), globals_=("OutFlux",),
        plan=(("BaseIteration", 0),)),
    "d2q9_heat_conjugate": DeviceModel(
        header="models/d2q9_heat_conjugate.cuh",
        storage=_d2q9_groups("f", "T"),
        settings=_HEAT_SETTINGS + ("SolidAlfa", "OutFluxInObj"),
        node_types=_HEAT_TYPES, groups=("COLLISION",),
        zonal=("HeaterTemperature",), globals_=("OutFlux",),
        plan=(("BaseIteration", 0),)),
    "d2q9_hb": DeviceModel(
        header="models/d2q9_hb.cuh",
        storage=_d2q9_groups("f", "T"),
        settings=_HEAT_SETTINGS + ("DestructionRate", "DestructionPower",
                                   "OutFluxInObj",
                                   "DestroyedCellFluxInObj"),
        node_types=_HEAT_TYPES + ("Destroy",), groups=("COLLISION",),
        zonal=("HeaterTemperature",),
        globals_=("OutFlux", "DestroyedCellFlux"),
        plan=(("BaseIteration", 0),)),
    "sw": DeviceModel(
        header="models/sw.cuh",
        storage=_d2q9_groups("f") + ("w",),
        settings=("omega", "nu", "InletVelocity", "InletPressure",
                  "InletDensity", "Gravity", "SolidH", "EnergySink",
                  "Height", "S2", "S3", "S5", "S7", "S8", "S9",
                  "PressDiffInObj", "TotalDiffInObj", "MaterialInObj",
                  "EnergyGainInObj"),
        node_types=("Wall", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "Obj1"),
        groups=("COLLISION",), zonal=("Height",),
        globals_=("PressDiff", "TotalDiff", "Material", "EnergyGain"),
        plan=(("BaseIteration", 0),)),
    "d2q9_solid": DeviceModel(
        header="models/d2q9_solid.cuh",
        storage=_d2q9_groups("f", "g", "h") + ("Cs", "fi_s"),
        settings=("nu", "FluidAlfa", "SoluteDiffusion", "C0", "T0", "Teq",
                  "Velocity", "Pressure", "Temperature", "Concentration",
                  "Theta0", "PartitionCoef", "LiquidusSlope", "GTCoef",
                  "SurfaceAnisotropy", "SoluteCapillar", "Buoyancy",
                  "OutFluxInObj", "MaterialInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EVelocity",
                    "EPressure", "ForceTemperature", "ForceConcentration",
                    "Obj"),
        groups=("COLLISION",),
        zonal=("Velocity", "Pressure", "Temperature", "Concentration",
               "Theta0"),
        globals_=("OutFlux", "Material"),
        plan=(("BaseIteration", 0),)),
    "d2q9_npe_guo": DeviceModel(
        header="models/d2q9_npe_guo.cuh",
        storage=_d2q9_groups("phi", "g", "f", "h_0", "h_1"),
        settings=("n_inf_0", "n_inf_1", "el", "el_kbT", "epsilon", "dt",
                  "psi0", "phi0", "ez", "Ex", "D", "nu", "rho_bc",
                  "phi_bc", "psi_bc", "t_to_s", "TotalMomentumInObj"),
        node_types=("Wall", "Solid", "WPressure", "EPressure",
                    "BottomSymmetry", "TopSymmetry"),
        groups=("COLLISION",), zonal=("rho_bc", "phi_bc", "psi_bc"),
        globals_=("TotalMomentum",),
        plan=(("BaseIteration", 0),)),
    # the multi-stage 2D models: pressureEvolution's plan runs in the ring
    # form (a ring of two), the three-stage plans in the staged form
    "d2q9_pf_pressureEvolution": DeviceModel(
        header="models/d2q9_pf_pressure_evolution.cuh",
        storage=_d2q9_groups("f", "h") + ("PhaseF",),
        settings=("Density_h", "Density_l", "PhaseField_h", "PhaseField_l",
                  "PhaseField", "W", "M", "sigma", "omega_l", "omega_h",
                  "nu_l", "nu_h") + tuple(f"S{i}" for i in range(7))
        + ("VelocityX", "VelocityY", "Pressure", "GravitationX",
           "GravitationY", "BuoyancyX", "BuoyancyY", "GmatchedX",
           "GmatchedY", "PressureLossInObj", "OutletFluxInObj",
           "InletFluxInObj", "TotalDensityInObj"),
        node_types=("Wall", "Solid", "MRT"), groups=("COLLISION",),
        zonal=("PhaseField", "VelocityX", "VelocityY", "Pressure"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux", "TotalDensity"),
        plan=(("BaseIter", 2), ("calcPhase", 0))),
    "d2q9_pp_MCMP": DeviceModel(
        header="models/d2q9_pp_mcmp.cuh",
        storage=_d2q9_groups("f", "g") + ("psi_f", "psi_g"),
        settings=("omega", "omega_g", "nu", "nu_g", "Velocity_f",
                  "Pressure_f", "Velocity_g", "Pressure_g", "Density",
                  "Density_dry", "Gc", "Gad1", "Gad2", "R", "T", "a", "b",
                  "Smag", "SL_U", "SL_lambda", "SL_delta", "SL_L",
                  "GravitationX", "GravitationY", "TotalDensity1InObj",
                  "TotalDensity2InObj", "PressureLossInObj",
                  "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity"),
        groups=("COLLISION",),
        zonal=("Velocity_f", "Pressure_f", "Velocity_g", "Pressure_g",
               "Density", "Density_dry"),
        globals_=("TotalDensity1", "TotalDensity2", "PressureLoss",
                  "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 2), ("CalcPsi_f", 1), ("CalcPsi_g", 0))),
    "d2q9_lee": DeviceModel(
        header="models/d2q9_lee.cuh",
        storage=_d2q9_groups("f") + ("rho", "nu"),
        settings=("omega", "nu", "InletVelocity", "InletPressure",
                  "InletDensity", "OutletDensity", "InitDensity",
                  "WallDensity", "GravitationY", "GravitationX",
                  "MovingWallVelocity", "WetDensity", "DryDensity",
                  "Wetting", "LiquidDensity", "VaporDensity", "Beta",
                  "Kappa", "MomentumXInObj", "MomentumYInObj", "MassInObj"),
        node_types=("Wet", "Dry", "Wall", "Solid", "WVelocity", "WPressure",
                    "EPressure", "EVelocity", "MovingWall",
                    "ForcedMovingWall", "BGK", "MRT"),
        groups=("COLLISION",),
        zonal=("InletVelocity", "InletPressure", "InletDensity",
               "OutletDensity", "InitDensity", "WallDensity",
               "MovingWallVelocity", "WetDensity", "DryDensity", "Wetting"),
        globals_=("MomentumX", "MomentumY", "Mass"),
        plan=(("BaseIteration", 4), ("CalcRho", 2), ("CalcNu", 0))),
    "d2q9_poison_boltzmann": DeviceModel(
        header="models/d2q9_poison_boltzmann.cuh",
        storage=_d2q9_groups("g") + ("subiter", "psi"),
        settings=("tau_psi", "n_inf", "z", "el", "kb", "T", "epsilon", "dt",
                  "psi_bc", "psi0"),
        node_types=("Wall", "Solid"), groups=("COLLISION",),
        zonal=("psi_bc", "psi0"), globals_=(),
        plan=(("BaseIteration", 2), ("CalcPsi", 1), ("CalcSubiter", 0))),
    # the 2D adjoint models of example/adj_drag.xml and its kin, each with
    # a reverse stage for generic2d_step_b
    "d2q9_adj": DeviceModel(
        header="models/d2q9_adj.cuh",
        storage=_d2q9_groups("f") + ("w",),
        settings=("omega", "nu", "Velocity", "Pressure", "ForceX", "ForceY",
                  "PorocityGamma", "PorocityTheta", "Porocity", "DragInObj",
                  "LiftInObj", "MaterialPenaltyInObj", "MaterialInObj",
                  "PressureLossInObj", "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "MRT", "Inlet", "Outlet"),
        groups=("DESIGNSPACE",),
        zonal=("Velocity", "Pressure", "Porocity"),
        globals_=("Drag", "Lift", "MaterialPenalty", "Material",
                  "PressureLoss", "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 0),),
        adjoint=True),
    "d2q9_optimalMixing": DeviceModel(
        header="models/d2q9_optimal_mixing.cuh",
        storage=_d2q9_groups("f") + tuple(f"g[{i}]" for i in range(5)),
        settings=("omega", "nu", "omegaT", "K", "MovingWallVelocity",
                  "Velocity", "Pressure", "Temperature", "TotalTempSqrInObj",
                  "CountCellsInObj", "NMovingWallForceInObj"),
        node_types=("Wall", "Solid", "MovingWall"),
        groups=("COLLISION",),
        zonal=("MovingWallVelocity", "Velocity", "Pressure", "Temperature"),
        globals_=("TotalTempSqr", "CountCells", "NMovingWallForce"),
        plan=(("BaseIteration", 0),),
        adjoint=True),
    "d2q9_plate": DeviceModel(
        header="models/d2q9_plate.cuh",
        storage=_d2q9_groups("f"),
        settings=("nu", "omega", "Velocity", "Density", "GravitationX",
                  "GravitationY", "tau0", "Smag", "PressureLossInObj",
                  "OutletFluxInObj", "InletFluxInObj", "ForceXInObj",
                  "ForceYInObj", "MomentInObj", "PowerXInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EVelocity",
                    "EPressure", "Inlet", "Outlet"),
        groups=("COLLISION",),
        zonal=("Velocity", "Density"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux", "ForceX",
                  "ForceY", "Moment", "PowerX"),
        plan=(("BaseIteration", 0),),
        adjoint=True),
    # the phase-field, pseudopotential and design models of the
    # reference's workflows: wave, d2q9_diff and d2q9_pf in the pass form
    # (wave2d and d2q9_diff with a reverse stage), the two-stage pp_LBL
    # and pf_curvature in the ring form
    "wave": DeviceModel(
        header="models/wave.cuh", storage=("u", "v"),
        settings=("Speed", "Value", "Viscosity"),
        node_types=("Dirichlet",), groups=("BOUNDARY",), zonal=("Value",),
        globals_=(), plan=(("BaseIteration", 0),)),
    "wave2d": DeviceModel(
        header="models/wave2d.cuh",
        storage=("h", "u", "h1", "h2", "h3", "h4", "w"),
        settings=("WaveK", "SolidH", "Loss", "TotalDiffInObj"),
        node_types=("Obj1",), groups=("OBJECTIVE",), zonal=(),
        globals_=("TotalDiff",), plan=(("BaseIteration", 0),),
        adjoint=True),
    "d2q9_diff": DeviceModel(
        header="models/d2q9_diff.cuh",
        storage=_d2q9_groups("f") + ("w",),
        settings=("omega", "Diffusivity", "UX", "UY", "InitC", "Source",
                  "TotalCInObj", "OutCInObj"),
        node_types=("Wall", "Solid", "Outlet"),
        groups=("COLLISION", "DESIGNSPACE"), zonal=("InitC",),
        globals_=("TotalC", "OutC"), plan=(("BaseIteration", 0),),
        adjoint=True),
    "d2q9_pf": DeviceModel(
        header="models/d2q9_pf.cuh", storage=_d2q9_groups("f", "h"),
        settings=("omega", "nu", "Velocity", "Pressure", "W", "M",
                  "PhaseField", "GravitationX", "GravitationY",
                  "PressureLossInObj", "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "EVelocity", "WPressure", "WVelocity",
                    "EPressure"),
        groups=("COLLISION",), zonal=("Velocity", "Pressure", "PhaseField"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 0),)),
    "d2q9_pp_LBL": DeviceModel(
        header="models/d2q9_pp_lbl.cuh",
        storage=_d2q9_groups("f") + ("psi",),
        settings=("G", "T", "alpha", "R", "beta", "kappa", "eps_0",
                  "betaforcing", "omega", "tempomega", "nu", "Velocity",
                  "VelocityY", "Density", "GravitationY", "GravitationX")
        + tuple(f"S{i}" for i in range(9))
        + ("PressureLossInObj", "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "EVelocity", "WPressure", "WVelocity",
                    "EPressure", "TopSymmetry", "BottomSymmetry"),
        groups=("COLLISION",), zonal=("Velocity", "VelocityY", "Density"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 1), ("calcPsi", 0))),
    "d2q9_pf_curvature": DeviceModel(
        header="models/d2q9_pf_curvature.cuh",
        storage=_d2q9_groups("f", "h") + ("phi",),
        settings=("omega", "omega_l", "nu", "Velocity", "Pressure", "W", "M",
                  "PhaseField", "GravitationX", "GravitationY",
                  "GravitationX_l", "GravitationY_l", "SurfaceTensionDecay",
                  "SurfaceTensionRate", "WettingAngle", "PressureLossInObj",
                  "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "EVelocity", "WPressure", "WVelocity",
                    "EPressure", "NSymmetry", "SSymmetry"),
        groups=("COLLISION",),
        zonal=("Velocity", "Pressure", "PhaseField", "WettingAngle"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 1), ("CalcPhi", 0))),
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
    # the 3D heat design family: one header each over
    # d3q19_heat_adj_common.cuh, with the reverse K8 builds in
    **{name: DeviceModel(
        header=f"models/{name}.cuh",
        storage=tuple(f"f[{k}]" for k in range(19))
        + tuple(f"T[{k}]" for k in range(7)) + ("w",)
        + (("w0", "w1") if prop else ()),
        settings=("nu", "omega", "Velocity", "Density", "GravitationX",
                  "GravitationY", "GravitationZ", "InletTemperature",
                  "InitTemperature", "FluidAlfa", "SolidAlfa", "Porocity")
        + (("PropagateX",) if prop else ())
        + ("PressureLossInObj", "OutletFluxInObj", "InletFluxInObj",
           "HeatFluxInObj", "MaterialInObj", "DragInObj")
        + (("MaterialPenaltyInObj",) if prop else ()),
        node_types=(("Propagate",) if prop else ())
        + ("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
           "EVelocity", "NSymmetry", "SSymmetry", "Outlet"),
        groups=("COLLISION", "DESIGNSPACE"),
        zonal=("Velocity", "Density", "Porocity"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux", "HeatFlux",
                  "Material", "Drag") + (("MaterialPenalty",) if prop
                                         else ()),
        plan=(("BaseIteration", 0),),
        adjoint=True, ndim=3)
       for name, prop in (("d3q19_heat_adj", False),
                          ("d3q19_heat_adj_art", False),
                          ("d3q19_heat_adj_prop", True))},
    # the 3D forward models of the generic engine: one stage each but
    # d3q19_kuper's two (Run, CalcPhi: one launch a stage)
    "d3q19_heat": DeviceModel(
        header="models/d3q19_heat.cuh",
        storage=tuple(f"f[{k}]" for k in range(19))
        + tuple(f"T[{k}]" for k in range(7)),
        settings=("nu", "omega", "Velocity", "Density", "GravitationX",
                  "GravitationY", "GravitationZ", "S_high",
                  "InletTemperature", "InitTemperature", "FluidAlfa",
                  "HeaterTemperature", "PressureLossInObj",
                  "OutletFluxInObj", "InletFluxInObj", "OutFluxInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "NSymmetry", "SSymmetry", "Heater",
                    "Outlet"),
        groups=("COLLISION",), zonal=("Velocity", "Density"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux", "OutFlux"),
        plan=(("BaseIteration", 0),), ndim=3),
    "d3q27": DeviceModel(
        header="models/d3q27.cuh",
        storage=tuple(f"f[{k}]" for k in range(27)),
        settings=("nu", "omega", "Velocity", "Density", "GravitationX",
                  "GravitationY", "GravitationZ", "omega_bulk",
                  "PressureLossInObj", "OutletFluxInObj", "InletFluxInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "NSymmetry", "SSymmetry", "Inlet",
                    "Outlet"),
        groups=("COLLISION",), zonal=("Velocity", "Density"),
        globals_=("PressureLoss", "OutletFlux", "InletFlux"),
        plan=(("BaseIteration", 0),), ndim=3),
    "d3q27_viscoplastic": DeviceModel(
        header="models/d3q27_viscoplastic.cuh",
        storage=tuple(f"f[{k}]" for k in range(27))
        + ("nu_app", "yield_stat"),
        settings=("nu", "Velocity", "Pressure", "ForceX", "ForceY",
                  "ForceZ", "YieldStress", "FluxInObj", "TotalRhoInObj")
        + tuple(f"{pl}{g}InObj" for pl in ("XY", "XZ", "YZ")
                for g in ("vx", "vy", "vz", "rho1", "rho2", "area")),
        node_types=("Wall", "Solid", "SymmetryY", "SymmetryZ",
                    "NVelocity_ZouHe", "SVelocity_ZouHe", "EVelocity_ZouHe",
                    "WVelocity_ZouHe", "NPressure_ZouHe", "SPressure_ZouHe",
                    "EPressure_ZouHe", "WPressure_ZouHe", "MRT", "XYslice1",
                    "XZslice1", "YZslice1", "XYslice2", "XZslice2",
                    "YZslice2"),
        groups=("COLLISION",), zonal=("Velocity", "Pressure"),
        globals_=("Flux", "TotalRho") + tuple(
            f"{pl}{g}" for pl in ("XY", "XZ", "YZ")
            for g in ("vx", "vy", "vz", "rho1", "rho2", "area")),
        plan=(("BaseIteration", 0),), ndim=3),
    "d3q27_cumulant_qibb_small": DeviceModel(
        header="models/d3q27_cumulant_qibb.cuh",
        storage=tuple(f"f[{k}]" for k in range(27))
        + tuple(f"q[{k}]" for k in range(1, 27)),
        settings=("nu", "omega", "Velocity", "Density", "GravitationX",
                  "GravitationY", "GravitationZ", "nubuffer",
                  "GalileanCorrection", "omega_bulk", "ForceX", "ForceY",
                  "ForceZ", "FluxInObj"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity", "SVelocity", "SPressure", "NVelocity",
                    "NPressure", "NSymmetry", "SSymmetry", "QIBB", "Buffer"),
        groups=("COLLISION",), zonal=("Velocity", "Density"),
        globals_=("Flux",), plan=(("BaseIteration", 0),), ndim=3),
    "d3q19_kuper": DeviceModel(
        header="models/d3q19_kuper.cuh",
        storage=tuple(f"f[{k}]" for k in range(19)) + ("phi",),
        settings=("omega", "nu", "Temperature", "FAcc", "Magic", "MagicA",
                  "MagicF", "GravitationX", "GravitationY", "GravitationZ",
                  "Density", "Wetting"),
        node_types=("Wall", "Solid", "WVelocity", "WPressure", "EPressure",
                    "EVelocity"),
        groups=("BOUNDARY", "COLLISION"), zonal=("Density",), globals_=(),
        plan=(("BaseIteration", 1), ("CalcPhi", 0)), ndim=3),
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


# generic2d_step's block shapes (csrc/generic2d.cu): the one-node-a-thread
# pass form's 32x16 threads, 32x8 at NARROW_BLOCKS blocks an SM for a
# one-stage plan of at least NARROW_MIN_PLANES planes (the narrow pass);
# the tiled form's 32x8 tile, a node a thread, its planes staged over the
# tile plus the reach, TILED_BLOCKS blocks an SM,
# for a one-stage plan of at least TILED_MIN_PLANES planes; the ring
# form's tile, RING_TILE (`rows` x `cols` nodes of stage 0, a block of
# `thread_rows` rows of `cols` threads, at least `blocks` blocks an SM);
# the staged form's tile, 32 wide, 16 rows high where two blocks' shared
# memory fits an SM (TWO_BLOCKS_SMEM: half of 228 KB, less 1 KB a
# block), else 8
BLOCK = (16, 32)
# the pass form's globals flavours: a persistent grid of 32x16 blocks
# built for PASS_GLOBALS_BLOCKS an SM where a node moves fewer than
# PERSISTENT_MAX_BYTES (``persistent_globals``; ``globals_blocks`` asks
# the library for the grid); the globals reduction's last block loads
# REDUCE_RUN partials a lane at once (csrc/generic_common.cuh:
# reduce_globals)
PASS_GLOBALS_BLOCKS = 2
PERSISTENT_MAX_BYTES = 128
REDUCE_RUN = 8
NARROW = (8, 32)
NARROW_BLOCKS = 3
NARROW_MIN_PLANES = 20
TILED = (8, 32)
TILED_BLOCKS = 2
TILED_MIN_PLANES = 40
RING_TILE = {"rows": 32, "cols": 32, "thread_rows": 16, "blocks": 2}
# generic2d_resident's stage-0 region (csrc/generic2d.cu: KRX, KRY): one
# node a thread, `one_stage_rows` for a plan of one stage; its blocks in a
# launch at most (RESIDENT_MAX_BLOCKS)
RESIDENT_REGION = {"cols": 32, "rows": 16, "one_stage_rows": 8}
RESIDENT_MAX_BLOCKS = 2048      # csrc/resident_sync.cuh
# generic2d_step_b's tile (csrc/generic2d_adjoint.cuh: BQ, B_BLOCKS,
# B_NARROW_MIN_PLANES, b_rows): q on `side` x `side` nodes, a block of
# `rows` rows of `side` threads (`narrow_rows` for a stage whose q has at
# least `narrow_min_planes` slots), at least `blocks` blocks an SM, the
# output tile inside the one-node ring
STEP_B_TILE = {"side": 32, "rows": 16, "narrow_rows": 8,
               "narrow_min_planes": 16, "blocks": 2}
TWO_BLOCKS_SMEM = 113 * 1024
SMEM_PER_SM = 228 * 1024


def step_form(model: Model) -> str:
    """How ``generic2d_step`` runs ``model``'s Iteration in its one
    launch: ``"pass"`` (one stage, a node a thread, 32x16 blocks),
    ``"narrow"`` (one stage over at least ``NARROW_MIN_PLANES`` planes: a
    node a thread, 32x8 blocks at ``NARROW_BLOCKS`` an SM), ``"tiled"``
    (one stage over at least ``TILED_MIN_PLANES`` planes: the tile's
    planes staged in shared memory), ``"ring"`` (two stages, stage 0's
    ring of at most two nodes, its planes over a 32x16 tile within 40 KB:
    stage 0 on a tile plus the ring into shared memory, stage 1 from
    there; ``ring_tile``) or ``"staged"`` (any other plan: the tile plus
    the plan's reach staged into shared memory, every stage from
    there)."""
    plan, _ = action_plan(model)
    if len(plan) == 1:
        return ("tiled" if model.n_storage >= TILED_MIN_PLANES
                else "narrow" if model.n_storage >= NARROW_MIN_PLANES
                else "pass")
    if len(plan) == 2 and plan[0][1] <= 2 \
            and model.n_storage * BLOCK[0] * BLOCK[1] * 4 <= 40 * 1024:
        return "ring"
    return "staged"


def persistent_globals(model: Model, itemsize: int) -> bool:
    """Whether ``generic2d_step``'s globals flavours run ``model`` on a
    persistent grid (csrc/generic2d.cu mirrors it): the pass form, where a
    node's planes in and out at ``itemsize`` bytes a value come to fewer
    than ``PERSISTENT_MAX_BYTES``."""
    return (step_form(model) == "pass"
            and 2 * itemsize * model.n_storage < PERSISTENT_MAX_BYTES)


def ring_tile(model: Model) -> dict:
    """The ring form's tile for ``model`` (csrc/generic2d.cu mirrors it):
    stage 0's tile (``rows`` x ``cols``, its planes in f32 shared memory),
    the output tile inside its ring, the block's threads, and the stage-0
    nodes a block computes for each output node."""
    ring = action_plan(model)[0][0][1]
    rows, cols = RING_TILE["rows"], RING_TILE["cols"]
    out = (rows - 2 * ring, cols - 2 * ring)
    return {"ring": ring, "stage0": (rows, cols), "tile": out,
            "threads": cols * RING_TILE["thread_rows"],
            "blocks": RING_TILE["blocks"],
            "smem": 4 * model.n_storage * rows * cols,
            "stage0_per_node": rows * cols / (out[0] * out[1])}


def resident_tile(model: Model, shape=None) -> dict:
    """``generic2d_resident``'s tile for ``model`` (csrc/generic2d.cu
    mirrors it: ``resident_plan``): the region of a group's first stage
    (one node a thread of the block), the steps a group runs between two
    waits (two where the tile that leaves, the region less the plan's
    reach and stage 0's ring a side, keeps half of the region, else one),
    the tile, each stage's ring, the f32 shared memory (the earlier
    stages' planes, and a step's result where a group runs two), the
    stage-0 nodes a block computes a group for each output node a step,
    and, for a lattice of ``shape``, the tiles (row-major) and the blocks
    that own them (block b the tiles b, b + blocks, ...: at most one a
    tile and ``RESIDENT_MAX_BLOCKS``, the device's co-resident blocks
    aside)."""
    plan, reach = action_plan(model)
    e0 = plan[0][1]
    rr = RESIDENT_REGION
    rows = rr["rows"] if len(plan) > 1 else rr["one_stage_rows"]
    cols = rr["cols"]
    fuse, ring0 = 2, reach + e0
    if rows - 2 * ring0 < 2 \
            or 2 * (rows - 2 * ring0) * (cols - 2 * ring0) < rows * cols:
        fuse, ring0 = 1, e0
    tile = (rows - 2 * ring0, cols - 2 * ring0)
    planes = model.n_storage * rows * cols
    stage0 = sum((tile[0] + 2 * (j * reach + e0))
                 * (tile[1] + 2 * (j * reach + e0)) for j in range(fuse))
    out = {"region": (rows, cols), "fuse": fuse, "tile": tile,
           "ring": ring0, "reach": reach,
           "rings": tuple(ext for _, ext in plan), "threads": rows * cols,
           "smem": 4 * planes * ((len(plan) > 1) + (fuse > 1)),
           "stage0_per_node": stage0 / (fuse * tile[0] * tile[1])}
    if shape is not None:
        grid = tuple(-(-int(n) // t) for n, t in zip(shape, tile))
        out["tiles"] = grid
        out["blocks"] = min(grid[0] * grid[1], RESIDENT_MAX_BLOCKS)
    return out


def resident_waits(shape, tile, reach: int, blocks: int) -> list:
    """For each of ``blocks`` blocks of a resident launch (csrc/
    resident_sync.cuh; ``generic2d_resident``, ``d2q9_resident8``) on a
    lattice of ``shape`` cut into ``tile``-sized tiles, row-major, block
    b owning the tiles b, b + blocks, ...: the set of blocks it waits for
    before a step, the owners of every node within ``reach`` of its tiles
    (wrapped)."""
    ny, nx = (int(s) for s in shape)
    ty, tx = tile
    ntx = -(-nx // tx)
    ntiles = ntx * -(-ny // ty)
    out = [set() for _ in range(blocks)]
    for t in range(ntiles):
        y0, x0 = t // ntx * ty, t % ntx * tx
        ys = {(y0 + d) % ny // ty for d in range(-reach, ty + reach)}
        xs = {(x0 + d) % nx // tx for d in range(-reach, tx + reach)}
        out[t % blocks].update((r * ntx + c) % blocks for r in ys for c in xs)
    return out


def step_b_tile(model: Model, slots: int | None = None) -> dict:
    """``generic2d_step_b``'s tile for a reverse stage of ``model`` whose
    q has ``slots`` slots (a plane each and a Field read each of the
    stage's reverse: the library's ``slots_b`` entry for the stage; by
    default a plane each, a stage that reverses no Field read)
    (csrc/generic2d_adjoint.cuh mirrors it; the library reports the output
    tile as ``tile_b``, which sizes the wrapper's partials): q's tile and
    its f32 shared memory, the output tile, the block's threads, and the
    nodes of q a block computes for each output node."""
    side = STEP_B_TILE["side"]
    out = side - 2
    nq = model.n_storage if slots is None else slots
    rows = STEP_B_TILE["narrow_rows" if nq
                       >= STEP_B_TILE["narrow_min_planes"] else "rows"]
    return {"q": (side, side), "tile": (out, out),
            "threads": side * rows,
            "blocks": STEP_B_TILE["blocks"],
            "smem": 4 * nq * side * side,
            "q_per_node": side * side / (out * out)}


def tiled_tile(model: Model) -> dict:
    """The tiled form's tile for ``model`` (csrc/generic2d.cu mirrors
    it): the output tile ``(ty, tx)``, the input halo (the plan's reach),
    the staged input's extents and its shared memory (every storage plane,
    f32)."""
    reach = action_plan(model)[1]
    ty, tx = TILED
    inp = (ty + 2 * reach, tx + 2 * reach)
    return {"tile": TILED, "halo": reach, "input": inp,
            "threads": ty * tx, "blocks": TILED_BLOCKS,
            "smem": 4 * model.n_storage * inp[0] * inp[1]}


def staged_tile(model: Model) -> dict:
    """The staged form's tile for ``model`` (csrc/generic2d.cu mirrors
    it): the output tile ``(ty, tx)``, the input halo (the plan's reach),
    each stage's ring (``action_plan``'s), the extents of the staged input
    and of the earlier stages' stack (every storage plane of each, f32),
    their shared memory, and the stage-0 nodes a block computes for each
    output node."""
    plan, reach = action_plan(model)
    e0 = plan[0][1]

    def smem(ty):
        return 4 * model.n_storage * ((ty + 2 * reach) * (32 + 2 * reach)
                                      + (ty + 2 * e0) * (32 + 2 * e0))
    ty = 16 if smem(16) <= TWO_BLOCKS_SMEM else 8
    return {"tile": (ty, 32), "halo": reach,
            "rings": tuple(ext for _, ext in plan),
            "input": (ty + 2 * reach, 32 + 2 * reach),
            "stack": (ty + 2 * e0, 32 + 2 * e0), "smem": smem(ty),
            "stage0_per_node": (ty + 2 * e0) * (32 + 2 * e0) / (ty * 32)}


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
            "d2q9_kuper_adj": _kuper_adj_flops,
            "d2q9_heat_adj": _heat_adj_flops, "d2q9_heat": _heat_flops,
            "d2q9_heat_conjugate": _heat_flops, "d2q9_hb": _heat_flops,
            "sw": _sw_flops, "d2q9_solid": _solid_flops,
            "d2q9_npe_guo": _npe_flops,
            "d2q9_pf_pressureEvolution": _pf_pe_flops,
            "d2q9_pp_MCMP": _sum_stages, "d2q9_lee": _sum_stages,
            "d2q9_poison_boltzmann": _sum_stages, "d2q9_adj": _adj_flops,
            "d2q9_optimalMixing": _mixing_flops,
            "d2q9_plate": _plate_flops, "wave": _wave_flops,
            "wave2d": _wave2d_flops, "d2q9_diff": _diff_flops,
            "d2q9_pf": _pf_flops, "d2q9_pp_LBL": _lbl_flops,
            "d2q9_pf_curvature": _curvature_flops}[model.name](model, flags)


def stage_flops(model: Model, flags: np.ndarray) -> tuple:
    """``node_step_flops`` of a three-stage model (d2q9_pp_MCMP,
    d2q9_lee, d2q9_poison_boltzmann), by stage of its plan."""
    return {"d2q9_pp_MCMP": _mcmp_flops, "d2q9_lee": _lee_flops,
            "d2q9_poison_boltzmann": _pb_flops}[model.name](model, flags)


def _sum_stages(model: Model, flags: np.ndarray) -> int:
    return sum(stage_flops(model, flags))


# Operations of the one-stage models' pieces (csrc/models/d2q9_common.cuh):
# a d2q9 population sum (8), rho, j and u (8 + 5 + 5 + 2), a Zou/He face
# (22, as _heat_adj_flops counts it), the temperature equilibrium (w_0 T;
# per moving direction w T, e.u, 3 e.u, 1 + and the product: 37), a
# relaxation q + k (eq - q) over nine planes (27), a keep factor 1 - 1 /
# (3 D + 0.5) (4)
SUM9, MACRO, ZOU, T_EQ, RELAX, KEEP = 8, 20, 22, 37, 27, 4


def _eq_flops() -> int:
    from tclb_tpu_torch.models.d2q9 import E, W
    from tclb_tpu_torch.ops.d2q9_kernels import _equilibrium_flops
    return _equilibrium_flops(E, W)


def _faces(model: Model, flags: np.ndarray) -> int:
    return count_types(model, flags, "WVelocity", "WPressure", "EVelocity",
                       "EPressure")


def _heat_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_heat and its two builds (models/d2q9_heat.py and the
    conjugate and hb runs on it).  Every node: rho and u, the temperature
    sum (28); a collision node the equilibrium, both relaxations,
    1 / (3 alfa + 0.5) (3) and the temperature equilibrium; a Zou/He face
    22, an inlet temperature 9; an Outlet node its flux (1).  The
    conjugate build adds at a Solid node the sum, its rate, the
    equilibrium and the relaxation (75); the hb build at a Destroy node
    the stress (rho and u 20, the equilibrium, f - feq 9, the three
    contractions 5 + 3 + 5, the norm 6), the rate and scale (5), the
    eroded sum and its global (10) and the scaling (9)."""
    eq = _eq_flops()
    n = int(np.asarray(flags).size)
    coll = count_group(model, flags, "COLLISION")
    out = ((MACRO + SUM9) * n + (eq + 2 * RELAX + 3 + T_EQ) * coll
           + ZOU * _faces(model, flags)
           + 9 * count_types(model, flags, "WVelocity", "EPressure")
           + count_types(model, flags, "Outlet"))
    if model.name == "d2q9_heat_conjugate":
        out += (SUM9 + 3 + T_EQ + RELAX) * count_types(model, flags,
                                                        "Solid")
    if model.name == "d2q9_hb":
        stress = MACRO + eq + 9 + 13 + 6
        out += (stress + 5 + 10 + 9) * count_types(model, flags, "Destroy")
    return out


def _sw_flops(model: Model, flags: np.ndarray) -> int:
    """sw (models/sw.py).  Every node: the nine moments (the basis rows'
    combinations), the equilibrium moments (25), the six relaxed rows (3
    each), |j|^2 (3) and the damped momentum (2); an Obj1 node its two
    objectives (3 + 4); a collision node the damped equilibrium moments
    (25), the six sums (6) and f from the moments (the inverse basis'
    rows); a Zou/He face 22."""
    from tclb_tpu_torch.models.d2q9 import M
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    from tclb_tpu_torch.ops.lbm import inverse_basis
    moments = sum(_combo_flops(row) for row in M)
    back = sum(_combo_flops(row) for row in inverse_basis(M))
    n = int(np.asarray(flags).size)
    return ((moments + 25 + 18 + 3 + 2) * n
            + 7 * count_types(model, flags, "Obj1")
            + (25 + 6 + back) * count_group(model, flags, "COLLISION")
            + ZOU * _faces(model, flags))


def _solid_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_solid (models/d2q9_solid.py).  Every node: rho and u, rhoT and
    C (36).  A collision node: the three keep factors and kc (15), the
    central differences (14), |grad|^2 and the curvature with its power
    (3 + 11), the double angles (4 + 3 + 3 + 2), the anisotropy (4 Theta0,
    cos, sin, the combination and 1 - 15 SA cos4: 9), Cl_eq (7), the
    growth (the test, the ratio 4, the clamp 2, fi, dC, Cs: 1 + 4 + 2 + 1
    + 2 + 3), the accelerations and the midpoint velocity (2 + 6 + 4 + 2),
    the shifted scalars (2) and the three collisions (two equilibria and a
    relaxation each); a Force node its difference (1).  A W face: Zou/He
    and two refills (22 + 2 x 10); an E pressure face Zou/He and two
    refills (22 + 2 x 6); an E velocity face Zou/He (22)."""
    eq = _eq_flops()
    n = int(np.asarray(flags).size)
    coll_node = (3 * KEEP + 3 + 14 + 14 + 12 + 9 + 7 + 13 + 14 + 2
                 + 3 * (2 * eq + RELAX))
    return (36 * n
            + coll_node * count_group(model, flags, "COLLISION")
            + count_types(model, flags, "ForceTemperature",
                          "ForceConcentration")
            + (ZOU + 20) * count_types(model, flags, "WVelocity",
                                       "WPressure")
            + (ZOU + 12) * count_types(model, flags, "EPressure")
            + ZOU * count_types(model, flags, "EVelocity"))


def _npe_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_npe_guo (models/d2q9_npe_guo.py).  A collision node: the two
    potentials (8 each) and their gradients (28 each), rho and j (18), n0
    and n1 (16), rho_e (3), the force (8), u and the measured velocity
    (6), tau_D and B (5); the Poisson collisions of phi (36) and g (4 +
    4 + 8 x 7), the fluid BGK (the rate 3, two equilibria, the forced
    velocity 2, 9 x 5) and the two ion collisions (9 x 18 each).  A wall
    node: the zeta potential's and the ions' equilibria (9 x 3) and the
    two Boltzmann factors (5 each); a pressure face Zou/He and the three
    equilibria (22 + 27)."""
    eq = _eq_flops()
    coll_node = (2 * (8 + 28) + 18 + 16 + 3 + 8 + 6 + 5 + 36 + 64
                 + (3 + 2 * eq + 2 + 45) + 2 * 9 * 18)
    return (coll_node * count_group(model, flags, "COLLISION")
            + (27 + 10) * count_types(model, flags, "Wall", "Solid")
            + (ZOU + 27) * count_types(model, flags, "WPressure",
                                       "EPressure"))


def _basis_flops(M: np.ndarray) -> int:
    """A moment basis and its inverse over nine populations."""
    from tclb_tpu_torch.ops import lbm
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    return sum(_combo_flops(row) for row in M) + sum(
        _combo_flops(row) for row in lbm.inverse_basis(M))


def _pf_pe_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_pf_pressureEvolution (models/d2q9_pf_pressure_evolution.py).
    An MRT node: the interpolated density (6) and its global (1), the
    chemical potential (pavg 2, the laplacian 11, the double well 13), the
    body force (16), the gradient (13), u (j 10, the reciprocal and its
    scale 2, the force terms 10), p (the sum 8, 7), Gamma (an
    equilibrium), u.grad and p - rho/3 (5), per population the directional
    difference (2 past the rest), the interface (7) and body (6)
    corrections, g-bar's equilibrium (4) and the non-equilibrium (5), the
    stress rate (9), the classical basis and its inverse, the nine rates,
    f - r + iface + body (27), the normal (6), the mobility rate (3),
    theta (9), the h equilibrium (1 at rest, 4 else) and its relaxation
    (27).  Every node runs calcPhase: the sum of h (8)."""
    from tclb_tpu_torch.models import d2q9_pf_pressure_evolution as pe
    eq = _eq_flops()
    mrt = (6 + 1 + 26 + 16 + 13 + 22 + 15 + eq + 5 + 9 * 22 + 8 * 2 + 9
           + _basis_flops(pe.M_CLASSIC) + 9 + 27 + 6 + 3 + 9 + 1 + 8 * 4
           + 27)
    return (mrt * count_types(model, flags, "MRT")
            + SUM9 * int(np.asarray(flags).size))


def _mcmp_flops(model: Model, flags: np.ndarray) -> tuple:
    """d2q9_pp_MCMP (models/d2q9_pp_mcmp.py).  A collision node: both
    densities (16), the common velocity (the weights 3, the four momenta
    20, four divisions, two adds, two divisions: 31), both Shan-Chen
    forces (each 12 products and 10 adds over the neighbours, the scale
    and gravity 4 a component: 30), the four shifted velocities (3 each),
    two BGK collisions (an equilibrium and 27 each) and the two globals.
    A Zou/He face on both populations (the pressure's 3 P + 1 twice: 2).
    Every node runs CalcPsi_f and CalcPsi_g: a sum each (8)."""
    from tclb_tpu_torch.ops.d2q9_kernels import _nebb_flops
    eq = _eq_flops()
    coll = 16 + 31 + 2 * 30 + 4 * 3 + 2 * (eq + RELAX) + 2
    nodes = int(np.asarray(flags).size)
    return (coll * count_group(model, flags, "COLLISION")
            + (2 * _nebb_flops() + 2) * _faces(model, flags),
            SUM9 * nodes, SUM9 * nodes)


def _lee_flops(model: Model, flags: np.ndarray) -> tuple:
    """d2q9_lee (models/d2q9_lee.py).  A collision node: d, j and the bare
    velocity (20), u.G (3), per moving direction the biased (17) and
    central (7) gradients, e.G (3) and the two projections (4), at rest
    e.G and the projections (7); the central force vector (11) and the
    velocity (6); the force vectors again (22), the globals (6), an
    equilibrium, u.F twice (6); BGK: per population two force terms (4
    each), 0.5 times each, the non-equilibrium and the relaxation (16);
    MRT: the pre-shift (6 a population), the basis over f and feq and the
    inverse, the six relaxed moments (3 each) and the post-shift (6 a
    population).  A ForcedMovingWall adds the matching force (6 and 5 a
    population on both projections: 96).  The boundary cases: a Zou/He
    face 22, the moving lid 15, the equilibrium inlet an equilibrium.
    Every node runs CalcRho (the sum 8) and CalcNu (the laplacian 39, the
    double well 9, the difference 2)."""
    from tclb_tpu_torch.models import d2q9
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    eq = _eq_flops()
    fill = 20 + 3 + 8 * (17 + 7 + 3 + 4) + 7 + 11 + 6
    base = fill + 22 + 6 + eq + 6
    bgk = 9 * 16
    moments = sum(_combo_flops(row) for row in d2q9.M)
    mrt = 9 * 6 + moments + _basis_flops(d2q9.M) + 6 * 3 + 9 * 6
    nodes = int(np.asarray(flags).size)
    return ((base + bgk) * count_types(model, flags, "BGK")
            + (base + mrt) * count_types(model, flags, "MRT")
            + 96 * count_types(model, flags, "ForcedMovingWall")
            + ZOU * count_types(model, flags, "WPressure", "EPressure",
                                "EVelocity")
            + 15 * count_types(model, flags, "MovingWall")
            + eq * count_types(model, flags, "WVelocity"),
            SUM9 * nodes, (39 + 9 + 2) * nodes)


def _pb_flops(model: Model, flags: np.ndarray) -> tuple:
    """d2q9_poison_boltzmann (models/d2q9_poison_boltzmann.py).  A
    collision node: psi (8 and the scale 1), the charge density (the
    product of settings 3, the argument 4, sinh 1, the product 1), the
    source (5) and the sweep (4 at rest, 7 per moving population).  A wall
    node the zeta potential's equilibrium (9).  Every node runs CalcPsi
    (9) and CalcSubiter (1)."""
    coll = 9 + 9 + 5 + 4 + 8 * 7
    nodes = int(np.asarray(flags).size)
    return (coll * count_group(model, flags, "COLLISION")
            + 9 * count_types(model, flags, "Wall", "Solid"),
            9 * nodes, nodes)


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


def _mrt_kept_flops() -> tuple:
    """d2q9_adj's collision pieces over the d2q9 basis: the kept rows 3, 7
    and 8 of ``M`` (the non-equilibrium moments), all of ``M`` (over the
    penalised equilibrium) and the inverse basis, each over its
    nonzeros."""
    from tclb_tpu_torch.models import d2q9
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    from tclb_tpu_torch.ops.lbm import inverse_basis
    kept = sum(_combo_flops(d2q9.M[r]) for r in (3, 7, 8))
    return (kept, sum(_combo_flops(row) for row in d2q9.M),
            sum(_combo_flops(row) for row in inverse_basis(d2q9.M)))


def _adj_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_adj (models/d2q9_adj.py).  An MRT node: rho and u (20), |u|^2
    (3), the equilibrium, f - feq (9), the kept rows of ``M`` and their
    three keep factors, u + Force (2), nw (4), Drag and Lift (3), the
    penalised velocity (2), its equilibrium, ``M`` over it, m_neq + M feq2
    (9) and the inverse basis.  An Inlet or Outlet node its flux and
    pressure loss (10, as d2q9's); a Zou/He face 22, a pressure face 2
    more for 1 + 3 Pressure; a DesignSpace node 1 - w and w (1 - w) (2)."""
    eq = _eq_flops()
    kept, fwd, back = _mrt_kept_flops()
    mrt = MACRO + 3 + eq + 9 + kept + 3 + 2 + 4 + 3 + 2 + eq + fwd + 9 + back
    return (mrt * count_types(model, flags, "MRT")
            + 10 * count_types(model, flags, "Inlet", "Outlet")
            + ZOU * _faces(model, flags)
            + 2 * count_types(model, flags, "WPressure", "EPressure")
            + 2 * count_group(model, flags, "DESIGNSPACE"))


def _mixing_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_optimalMixing (models/d2q9_optimal_mixing.py).  A collision
    node: rho and u (20), the equilibrium, the flow's relaxation (27), the
    scalar's sum (4), its equilibrium (per population e.u 3, 1 + 3 e.u 2,
    w T and the product 2: 35) and relaxation (15), the squared
    temperature (1).  A MovingWall node its six corrections (12) and
    NMovingWallForce (jx 5, two products)."""
    coll = MACRO + _eq_flops() + RELAX + 4 + 35 + 15 + 1
    return (coll * count_group(model, flags, "COLLISION")
            + (12 + 7) * count_types(model, flags, "MovingWall"))


def _plate_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_plate (models/d2q9_plate.py).  A collision node: the BGK step
    with the velocity-shift force (d2q9_kernels._bgk_flops), the
    Smagorinsky rate (35) and its base rate and time 1 / (3 nu + 0.5), 1 /
    om0 (4); an Inlet or Outlet collision node the flux objectives, which
    take rho and u again (20, and 10).  A Wall node its reaction globals
    (jx and jy 10, four products); a face its non-equilibrium bounce-back
    (19)."""
    from tclb_tpu_torch.ops.d2q9_kernels import (_bgk_flops, _nebb_flops,
                                                 _smagorinsky_flops)
    flags64 = np.asarray(flags).astype(np.int64)
    coll_mask = (flags64 & model.group_masks["COLLISION"]) != 0
    nt = model.node_types
    objective = sum(int((((flags64 & nt[n].mask) == nt[n].value)
                         & coll_mask).sum()) for n in ("Inlet", "Outlet"))
    coll = _bgk_flops(_eq_flops()) + _smagorinsky_flops() + 4
    return (coll * int(coll_mask.sum()) + (MACRO + 10) * objective
            + 14 * count_types(model, flags, "Wall")
            + _nebb_flops() * _faces(model, flags))


def _wave_flops(model: Model, flags: np.ndarray) -> int:
    """wave (models/wave.py), every node: the laplacian (3 adds, 4 u and
    the difference: 5), the damped rate (4) and u + v (1)."""
    return 10 * int(np.asarray(flags).size)


def _wave2d_flops(model: Model, flags: np.ndarray) -> int:
    """wave2d (models/wave2d.py), every node: du (5), u + du WaveK (2),
    (h + u) w (2), u Loss (1); an Obj1 node du^2 and its sum (2)."""
    return (10 * int(np.asarray(flags).size)
            + 2 * count_types(model, flags, "Obj1"))


def _diff_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_diff (models/d2q9_diff.py).  Every node: the concentration
    (8).  A collision node, per population: the equilibrium (e.u 3, 1 + 3
    e.u 2, w c and the product 2), the relaxation (3) and the source's
    equilibrium at 0 u and its add (8); 0 u (2), Source w (1) and TotalC
    (1).  An Outlet node OutC (1)."""
    return (SUM9 * int(np.asarray(flags).size)
            + (9 * 18 + 4) * count_group(model, flags, "COLLISION")
            + count_types(model, flags, "Outlet"))


# the h equilibrium of the phase-field models (models/d2q9_pf.py:_heq):
# the equilibrium, and per moving population bh w, e.n, the product and
# the add (4, a diagonal's e.n one more)
HEQ = 8 * 4 + 4


def _pf_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_pf (models/d2q9_pf.py).  A collision node: rho and u (20), the
    velocity with gravity (2), two equilibria, the relaxation toward feq2
    (1 - omega and 3 a population: 28), the phase field (8), the normal
    (h's first moments 10, their central parts 4, |k| 4, -k / |k| 4), the
    mobility rate (3), bh (6), the h equilibrium (an equilibrium and HEQ)
    and its relaxation (27).  A Zou/He face 22, a pressure face 2 more
    for 1 + 3 Pressure."""
    eq = _eq_flops()
    coll = 20 + 2 + 2 * eq + 28 + 8 + 22 + 3 + 6 + eq + HEQ + 27
    return (coll * count_group(model, flags, "COLLISION")
            + ZOU * _faces(model, flags)
            + 2 * count_types(model, flags, "WPressure", "EPressure"))


def _lbl_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_pp_LBL (models/d2q9_pp_lbl.py).  A collision node: rho and u
    (20), the Shan-Chen force with gravity (12 products and adds a
    component, -G psi0 2, the scale and gravity 3 a component: 30), gamma
    (9), the equilibrium, |F|^2 (3), gamma / (2 rho) (2), and per
    population e.u and e.F (6), the two force terms (5 each), the gamma
    term (4), their sum and scales (4) and the BGK update with the source
    (4).  A Zou/He face 22, the equilibrium inlet an equilibrium.  Every
    node runs calcPsi: rho (8), the Carnahan-Starling pressure (bp 2,
    1 - bp 1, the polynomial 6, the cube 2, the rest 7) and psi (6)."""
    eq = _eq_flops()
    coll = 20 + 30 + 9 + eq + 3 + 2 + 9 * (6 + 10 + 4 + 4 + 4)
    return (coll * count_group(model, flags, "COLLISION")
            + ZOU * count_types(model, flags, "WPressure", "EVelocity",
                                "EPressure")
            + eq * count_types(model, flags, "WVelocity")
            + (SUM9 + 2 + 1 + 6 + 2 + 7 + 6) * int(np.asarray(flags).size))


def _curvature_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_pf_curvature (models/d2q9_pf_curvature.py).  A collision node:
    the phase field (8), the repaired stencil's running mean (3 a link:
    27), its unit gradient (the two sums 10, |g| 4, the quotients 2), the
    curvature (the laplacian 11, the rest 13), the decay (4), the surface
    tension (6) and the interpolated gravity (5 a component: 10), the
    interpolated rate (3), rho and j (18), the velocities (6), two
    equilibria, the relaxation toward feq2 (28), J + 1.5 F (4), the
    mobility rate (3), bh (6), the h equilibrium (an equilibrium and HEQ)
    and its relaxation (28).  A Zou/He face 22, a pressure face 2 more and
    h pinned at the face's velocity (the sums 18, the quotients 2 and an
    equilibrium).  Every node runs CalcPhi: h's sum (8)."""
    eq = _eq_flops()
    coll = (8 + 27 + 16 + 24 + 4 + 6 + 10 + 3 + 18 + 6 + 2 * eq + 28 + 4
            + 3 + 6 + eq + HEQ + 28)
    return (coll * count_group(model, flags, "COLLISION")
            + ZOU * _faces(model, flags)
            + (2 + 20 + eq) * count_types(model, flags, "WPressure",
                                          "EPressure")
            + SUM9 * int(np.asarray(flags).size))


def _kuper_adj_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_kuper_adj (models/d2q9_kuper_adj.py): d2q9_kuper's, and on
    every node CalcPhi's product with wd (1)."""
    return _kuper_flops(model, flags) + int(np.asarray(flags).size)


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

# model -> its loaded library, resident tile, reverse tile and the globals
# flavours' block counts by shape and flavour
_LIB: dict = {}


def build(model: str) -> tuple[pathlib.Path, str]:
    """Compile csrc/generic2d.cu (csrc/generic3d.cu for a 3D model) with
    ``model``'s device header for sm_90a into build/tclb_tpu_torch/ (once
    per source content).  Returns the library path and the compiler's
    report (``-Xptxas -v``)."""
    dm = DEVICE_MODELS[model]
    return _cuda_build.build(f"generic{dm.ndim}d", dm.header)


def lib(model: str) -> ctypes.CDLL:
    """``model``'s generic library, built and bound at first use (``bind``)."""
    entry = _LIB.setdefault(model, {})
    if "lib" not in entry:
        if DEVICE_MODELS[model].ndim != 2:
            raise ValueError(f"{model} is a 3D model: its kernels are "
                             "ops/generic3d_kernels.py's")
        path, _ = build(model)
        entry.update(bind(ctypes.CDLL(str(path)), model, path.name))
    return entry["lib"]


def bind(lib, model: str, name: str) -> dict:
    """Bind a library of ``model`` (``name``: its file, for errors): its
    layout sizes and stage count are checked against ``DEVICE_MODELS``.
    Returns its ``_LIB`` entry: the library, its resident tile and, for
    an adjoint model, its reverse tile."""
    dm = DEVICE_MODELS[model]
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    argp = ctypes.POINTER(c_args_type(model))
    fp = ctypes.POINTER(ctypes.c_float)
    entry = {"lib": lib}
    for fn, args, res in (
            ("generic2d_layout", [ip] * 8, None),
            ("generic2d_plan", [ip], None),
            ("generic2d_step", [p, p, p, p, argp, p, p, i, p], i),
            ("generic2d_step_series", [p, p, p, p, argp, p, p, i, i, p, p,
                                       i, p], i),
            ("generic2d_resident", [p, p, p, p, p, p, argp, i, i, i, p],
             i),
            ("generic2d_step_bf16", [p, p, p, p, argp, fp, p, p, i, p], i),
            ("generic2d_resident_bf16", [p, p, p, p, p, p, argp, fp, i, i,
                                         i, p], i),
            ("generic2d_resident_tile", [i] + [ip] * 4, None),
            ("generic2d_step_blocks", [i] * 5 + [ip], i),
            ("generic_error_string", [i], ctypes.c_char_p)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    if dm.adjoint:
        lib.generic2d_step_b.argtypes = [p, p, p, p, p, argp, p, p, p, p, p,
                                         p, i, p]
        lib.generic2d_step_b.restype = i
        lib.generic2d_step_b_tile.argtypes = [ip, ip]
        lib.generic2d_step_b_tile.restype = None
        lib.generic2d_step_b_slots.argtypes = [i]
        lib.generic2d_step_b_slots.restype = i
        by, bx = ctypes.c_int(0), ctypes.c_int(0)
        lib.generic2d_step_b_tile(ctypes.byref(by), ctypes.byref(bx))
        entry["tile_b"] = (by.value, bx.value)
        entry["slots_b"] = tuple(lib.generic2d_step_b_slots(s)
                                 for s in range(len(dm.plan)))
    vals = [ctypes.c_int(0) for _ in range(8)]
    lib.generic2d_layout(*[ctypes.byref(v) for v in vals])
    _, _, *sizes = (v.value for v in vals)
    want = [len(dm.storage), len(dm.settings), len(dm.node_types),
            len(dm.groups), len(dm.zonal), len(dm.globals_)]
    if sizes != want:
        raise RuntimeError(f"{name} was built with layout sizes {sizes}, "
                           f"the wrapper expects {want}")
    stages = ctypes.c_int(0)
    lib.generic2d_plan(ctypes.byref(stages))
    if stages.value != len(dm.plan):
        raise RuntimeError(f"{name} runs {stages.value} stages, the "
                           f"wrapper expects {len(dm.plan)}")
    res = [ctypes.c_int(0) for _ in range(4)]
    lib.generic2d_resident_tile(action_plan(_get_model(model))[1],
                                *[ctypes.byref(v) for v in res])
    entry["resident_tile"] = (res[0].value, res[1].value)
    return entry


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


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def globals_blocks(a: StepArgs, bf16: bool, series: bool,
                   device: int) -> int:
    """The blocks of a globals flavour's ``generic2d_step`` launch on
    ``a``'s lattice (``bf16``: the bf16 stack; ``series``: the series
    flavour) on ``device``, as the library reports them
    (``generic2d_step_blocks``: its persistent grid); its partials hold a
    row a block.  Asked once per shape and flavour."""
    entry = _LIB[a.model]
    key = (a.shape, bool(bf16), bool(series), device)
    cache = entry.setdefault("globals_blocks", {})
    if key not in cache:
        lb = entry["lib"]
        blocks = ctypes.c_int(0)
        check(lb, lb.generic2d_step_blocks(a.ny, a.nx, int(bf16),
                                           int(series), device,
                                           ctypes.byref(blocks)),
              "generic2d_step_blocks")
        if blocks.value < 1:
            raise RuntimeError(f"{a.model}: generic2d_step_blocks reported "
                               f"{blocks.value} blocks for {a.shape}")
        cache[key] = blocks.value
    return cache[key]


def _launch_step(fields, flags, ztab, a: StepArgs, with_globals: bool,
                 series=None, it: int = 0):
    """One ``generic2d_step`` call (``generic2d_step_bf16`` for a bf16
    stack), or with :class:`SeriesInputs` ``series`` one
    ``generic2d_step_series`` call at iteration ``it``: one launch."""
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
    n_g = len(DEVICE_MODELS[a.model].globals_)
    if with_globals:
        blocks = globals_blocks(a, bf16, series is not None, dev)
        partials = torch.empty((blocks, max(n_g, 1)), dtype=torch.float64,
                               device=fields.device)
        gout = torch.empty((max(n_g, 1),), dtype=torch.float32,
                           device=fields.device)
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
    return (out, gout[:n_g]) if with_globals else out


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


def resident(fields, flags, ztab, a: StepArgs, nsteps: int) -> torch.Tensor:
    """``nsteps`` Iterations (even, at least 2) in one cooperative launch
    (kernel ``generic2d_resident``; ``generic2d_resident_bf16`` for a bf16
    stack)."""
    if nsteps < 2 or nsteps % 2:
        raise ValueError(f"nsteps={nsteps}: the ping-pong needs an even "
                         "count of at least 2")
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, nsteps)
    validate(fields, flags, ztab, a)
    lb = lib(a.model)
    dev, stream = device_and_stream(fields)
    ty, tx = _LIB[a.model]["resident_tile"]
    out = torch.empty_like(fields)
    scratch = torch.empty_like(fields)
    counters = torch.empty((-(-a.ny // ty) * -(-a.nx // tx),),
                           dtype=torch.int32, device=fields.device)
    head = (fields.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            counters.data_ptr(), flags.data_ptr(), ztab.data_ptr(),
            ctypes.byref(a.c_struct))
    reach = action_plan(_get_model(a.model))[1]
    name = "generic2d_resident"
    if fields.dtype == torch.bfloat16:
        name = "generic2d_resident_bf16"
        rc = lb.generic2d_resident_bf16(*head, a.c_shift, nsteps, reach,
                                        dev, stream)
    else:
        rc = lb.generic2d_resident(*head, nsteps, reach, dev, stream)
    check(lb, rc, name)
    LAUNCHES[name] += 1
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
    reaches no further than ``HALO`` rows (the reference's bound; the
    kernels themselves take any reach)."""
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
