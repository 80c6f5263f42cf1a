"""Hand-written CUDA kernel of the generic 3D engine, its plain PyTorch
version, and the engine ``Lattice`` builds from it.

The 3D half of ``ops/generic_kernels.py``: a 3D model reaches the kernel
through its device physics (``csrc/models/<model>.cuh``, listed in
``generic_kernels.DEVICE_MODELS`` with ``ndim=3``), compiled into the
model-independent template ``csrc/generic3d.cu`` once per model.  The
registry layout, the kernels' constants (``StepArgs``), the plain versions
and the byte count are the 2D module's.

``step`` / ``step_globals`` (``generic3d_step``) replace the JAX package's
``pallas_generic.py:make_pallas_iterate_3d`` (``call`` and its
in-kernel-globals flavour ``call_g``) at fuse = 1: one whole Iteration per
launch, one thread per node.  Bound by bytes (``launch_bytes``,
``node_step_flops``).  The globals flavour also returns the step's SUM
globals, reduced in a fixed order (no float atomics).
``step_series`` / ``step_series_globals`` (``generic3d_step_series``)
replace the ``<Control>`` time series flavours ``call_s`` and ``call_sg``
the same way as the 2D module's.  Each wrapper launches its kernel for a
CUDA tensor (or raises) and runs the plain version for a CPU tensor, and
counts its launches in ``LAUNCHES`` (the series flavours in
``SERIES_LAUNCHES``).  f32 only.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import LatticeState, SimParams
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.ops import generic_kernels as gk

KERNELS = ("generic3d_step",)
# launches per kernel; a wrapper adds one where it launches, nowhere else
LAUNCHES = {name: 0 for name in KERNELS}
# generic3d_step's launches by flavour (each also counts in LAUNCHES)
FLAVOUR_LAUNCHES = {"plain": 0, "globals": 0}
# the <Control> series flavours (generic3d_step_series), counted apart
SERIES_KERNELS = ("generic3d_step_series", "generic3d_step_series_globals")
SERIES_LAUNCHES = {name: 0 for name in SERIES_KERNELS}

# the 3D models with device physics
DEVICE_MODELS = {name: dm for name, dm in gk.DEVICE_MODELS.items()
                 if dm.ndim == 3}

# the shared pieces, under the names the kernel modules use
kernel_inputs = gk.kernel_inputs
plain_steps = gk.plain_steps
launch_bytes = gk.launch_bytes
build = gk.build


def reset_launches() -> None:
    for counts in (LAUNCHES, FLAVOUR_LAUNCHES, SERIES_LAUNCHES):
        for name in counts:
            counts[name] = 0


# --------------------------------------------------------------------------- #
# Bounds: operations (bytes: generic_kernels.launch_bytes)
# --------------------------------------------------------------------------- #


def equilibrium_flops(E: np.ndarray, W: np.ndarray) -> int:
    """Operations of one 3D ``lbm.equilibrium``: |u|^2 (5), 1 - 1.5|u|^2
    (2), w*rho once per distinct weight; per moving direction e.u, 3 e.u,
    4.5 (e.u)^2 (2), the three adds and the product with w*rho (5 past
    e.u); the rest population's product (1)."""
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    n = 5 + 2 + len(np.unique(W))
    for e in E:
        n += _combo_flops(e) + 5 if e.any() else 1
    return n


def _d3q19_adj_counts():
    """Per-node operation counts of d3q19_adj (models/d3q19_adj.py):
    ``(macro, collide, nebb, flux)``."""
    from tclb_tpu_torch.models.d3q19 import E, M, STRESS, W
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    lo, hi = STRESS
    norms = (M * M).sum(axis=1)
    back = (M[lo:hi] / norms[lo:hi, None]).T
    # rho and j over the populations, three divisions
    macro = _combo_flops(np.ones(19)) + sum(_combo_flops(E[:, a])
                                            for a in range(3)) + 3
    eq = equilibrium_flops(E, W)
    # feq, fneq (19), the stress moments and their projection, the keep
    # factors (3), kh fneq + d back (3 x 19), nw (4), v = u + g (3),
    # Drag and Lift (1 - nw and two products and two adds, 5), un2 (3),
    # feq2, relax + feq2 (19)
    collide = (eq + 19 + sum(_combo_flops(r) for r in M[lo:hi])
               + sum(_combo_flops(r) for r in back) + 3 + 57 + 4 + 3 + 5
               + 3 + eq + 19)
    # a NEBB closure on a d3q19 face: the two sums (8 + 4), S (2), rho or
    # un (2), five normal corrections (2 each), two tangential momenta
    # (5 adds, the factor, two corrections of two), five bounce-backs
    nebb = 16 + 10 + 2 * (5 + 1 + 4) + 5
    # add_flux_objectives: its own rho, j and u, |u|^2 (5), the flux, the
    # pressure loss (6) and the two global adds
    flux = macro + 5 + 1 + 6 + 2
    return macro, collide, nebb, flux


def node_step_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations one Iteration of a 3D ``DEVICE_MODELS``
    model needs over a flag field: what the function takes.  d3q19_adj:
    every node rho, j and u; a collision node the two-rate MRT with the
    Brinkman velocity, Drag and Lift; a NEBB node its closure; an Inlet or
    Outlet collision node its flux objectives; a DesignSpace node its two
    material globals (4)."""
    if model.name != "d3q19_adj":
        raise ValueError(f"no flop count for {model.name}")
    macro, collide, nebb, flux = _d3q19_adj_counts()
    n = int(np.asarray(flags).size)
    coll = gk.count_group(model, flags, "COLLISION")
    faces = gk.count_types(model, flags, "WVelocity", "WPressure",
                           "EVelocity", "EPressure")
    flags64 = np.asarray(flags).astype(np.int64)
    objective = int((((flags64 & model.group_masks["OBJECTIVE"]) != 0)
                     & ((flags64 & model.group_masks["COLLISION"]) != 0))
                    .sum())
    return (macro * n + collide * coll + nebb * faces + flux * objective
            + 4 * gk.count_group(model, flags, "DESIGNSPACE"))


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

# model -> its loaded library and step block
_LIB: dict = {}


def lib(model: str) -> ctypes.CDLL:
    """``model``'s generic 3D library, built and bound at first use; its
    layout sizes are checked against ``DEVICE_MODELS``."""
    entry = _LIB.setdefault(model, {})
    if "lib" not in entry:
        dm = DEVICE_MODELS[model]
        path, _ = build(model)
        lb = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        argp = ctypes.POINTER(gk.c_args_type(model))
        lb.generic3d_layout.argtypes = [ip] * 8
        lb.generic3d_layout.restype = None
        lb.generic3d_step.argtypes = [p, p, p, p, argp, p, p, i, p]
        lb.generic3d_step.restype = i
        lb.generic3d_step_series.argtypes = [p, p, p, p, argp, p, p, i, i,
                                             p, p, i, p]
        lb.generic3d_step_series.restype = i
        lb.generic_error_string.argtypes = [i]
        lb.generic_error_string.restype = ctypes.c_char_p
        if dm.adjoint:
            lb.generic3d_step_b.argtypes = [p, p, p, p, argp, p, p, p, p, p,
                                            i, p]
            lb.generic3d_step_b.restype = i
        vals = [ctypes.c_int(0) for _ in range(8)]
        lb.generic3d_layout(*[ctypes.byref(v) for v in vals])
        block_y, block_x, *sizes = (v.value for v in vals)
        want = [len(dm.storage), len(dm.settings), len(dm.node_types),
                len(dm.groups), len(dm.zonal), len(dm.globals_)]
        if sizes != want:
            raise RuntimeError(f"{path.name} was built with layout sizes "
                               f"{sizes}, the wrapper expects {want}")
        entry["block"] = (block_y, block_x)
        entry["lib"] = lb
    return entry["lib"]


def n_blocks(a: gk.StepArgs) -> int:
    """Blocks of one ``generic3d_step`` (or ``generic3d_step_b``) launch:
    the length of its partials."""
    by, bx = _LIB[a.model]["block"]
    return -(-a.ny // by) * -(-a.nx // bx) * a.nz


def _launch_step(fields, flags, ztab, a: gk.StepArgs, with_globals: bool,
                 series=None, it: int = 0):
    """One ``generic3d_step`` launch, or with :class:`SeriesInputs`
    ``series`` one ``generic3d_step_series`` launch at iteration ``it``."""
    gk.validate(fields, flags, ztab, a)
    if a.model not in DEVICE_MODELS:
        raise ValueError(f"{a.model} has no generic 3D kernels")
    if series is not None:
        sargs = gk.series_args(series, a, it, fields.device)
    lb = lib(a.model)
    dev, stream = gk.device_and_stream(fields)
    out = torch.empty_like(fields)
    partials = gout = None
    if with_globals:
        n_g = len(DEVICE_MODELS[a.model].globals_)
        partials = torch.empty((n_blocks(a), max(n_g, 1)),
                               dtype=torch.float64, device=fields.device)
        gout = torch.empty((n_g,), dtype=torch.float32, device=fields.device)
    head = (fields.data_ptr(), out.data_ptr(), flags.data_ptr(),
            ztab.data_ptr(), ctypes.byref(a.c_struct))
    tail = (partials.data_ptr() if with_globals else None,
            gout.data_ptr() if with_globals else None, dev, stream)
    if series is None:
        gk.check(lb, lb.generic3d_step(*head, *tail), "generic3d_step")
        LAUNCHES["generic3d_step"] += 1
        FLAVOUR_LAUNCHES["globals" if with_globals else "plain"] += 1
    else:
        gk.check(lb, lb.generic3d_step_series(*head, *sargs, *tail),
                 "generic3d_step_series")
        SERIES_LAUNCHES[SERIES_KERNELS[1 if with_globals else 0]] += 1
    return (out, gout) if with_globals else out


def step(fields, flags, ztab, a: gk.StepArgs) -> torch.Tensor:
    """One Iteration (kernel ``generic3d_step``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1)
    return _launch_step(fields, flags, ztab, a, with_globals=False)


def step_globals(fields, flags, ztab, a: gk.StepArgs) -> tuple:
    """One Iteration and its SUM globals (kernel ``generic3d_step``, the
    globals flavour): ``(fields, globals)``."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1, with_globals=True)
    return _launch_step(fields, flags, ztab, a, with_globals=True)


def step_series(fields, flags, ztab, a: gk.StepArgs, series, it: int
                ) -> torch.Tensor:
    """One Iteration at iteration ``it`` under a Control series (kernel
    ``generic3d_step_series``)."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1, series=series, it=it)
    return _launch_step(fields, flags, ztab, a, False, series, it)


def step_series_globals(fields, flags, ztab, a: gk.StepArgs, series,
                        it: int) -> tuple:
    """One Iteration at iteration ``it`` under a Control series and its
    SUM globals (kernel ``generic3d_step_series``, the globals flavour):
    ``(fields, globals)``."""
    if fields.device.type == "cpu":
        return plain_steps(fields, flags, ztab, a, 1, with_globals=True,
                           series=series, it=it)
    return _launch_step(fields, flags, ztab, a, True, series, it)


# kernel name -> (wrapper, steps one launch takes)
WRAPPERS = {"generic3d_step": (step, 1)}


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #


def supports(model: Model, shape, dtype) -> bool:
    """Whether the kernel runs this configuration: a 3D model with device
    physics, f32, whose Iteration is one stage that streams the densities
    and reads no Field stencil (the template's shape)."""
    if model.name not in DEVICE_MODELS or model.ndim != 3 \
            or len(shape) != 3 or dtype != torch.float32 \
            or min(int(s) for s in shape) < 1:
        return False
    stages = model.actions["Iteration"]
    return (len(stages) == 1 and model.stages[stages[0]].load_densities
            and not model.fields and gk.action_plan(model)[1] <= 1)


def make_band_iterate(model: Model, shape) -> Callable:
    """``iterate(state, params, niter)`` on ``generic3d_step``: ``niter -
    1`` plain launches, then one globals launch, so the state comes back
    with the last step's globals (``full_globals``).  Under a Control
    series the same on the series flavours (``supports_series``)."""
    if not supports(model, shape, torch.float32):
        raise ValueError(f"generic 3D kernel unsupported: {model.name} "
                         f"{shape}")

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        if niter <= 0:
            return state
        f, flags, ztab, a = kernel_inputs(model, state, params)
        series = gk.series_inputs(model, params)
        if series is None:
            for _ in range(niter - 1):
                f = step(f, flags, ztab, a)
            f, g = step_globals(f, flags, ztab, a)
        else:
            f, g = gk.series_steps(f, flags, ztab, a, series,
                                   state.iteration, niter, step_series,
                                   step_series_globals)
        return dataclasses.replace(
            state, fields=f, globals_=g.to(state.globals_.dtype),
            iteration=state.iteration + niter)

    iterate.full_globals = True
    iterate.supports_series = True
    return iterate


def select_engine(model: Model, shape, dtype, series: bool = False
                  ) -> tuple:
    """``(iterate, tag)`` of the band engine where ``supports()`` accepts
    this configuration, else ``(None, None)``; the band engine reads a
    Control series (``series``) itself."""
    if supports(model, shape, dtype):
        return (make_band_iterate(model, shape),
                f"cuda_generic3d_band[{model.name},fuse=1]")
    return None, None
