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
call, one launch a stage of the plan (each stage writes its planes into
the step's output, where a later stage reads them; each launch counts),
one thread per node.  Bound by bytes (``launch_bytes``,
``node_step_flops``).  The globals flavour also returns the step's SUM
globals, reduced in a fixed order (no float atomics).
``step_series`` / ``step_series_globals`` (``generic3d_step_series``)
replace the ``<Control>`` time series flavours ``call_s`` and ``call_sg``
the same way as the 2D module's.  Each wrapper launches its kernel for a
CUDA tensor (or raises) and runs the plain version for a CPU tensor, and
counts its launches in ``LAUNCHES`` (the series flavours in
``SERIES_LAUNCHES``; a call counts each of its launches).  f32 only.
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

# the 3D heat design family (one header each over
# csrc/models/d3q19_heat_adj_common.cuh)
HEAT_ADJ = ("d3q19_heat_adj", "d3q19_heat_adj_art", "d3q19_heat_adj_prop")

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


def flavours() -> dict:
    """generic3d_step's launches by flavour (as ``gk.flavours``)."""
    return dict(FLAVOUR_LAUNCHES)


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


def node_step_flops(model: Model, flags: np.ndarray, fields=None) -> int:
    """Floating-point operations one Iteration of a 3D ``DEVICE_MODELS``
    model needs over a flag field (and, for d3q27_cumulant_qibb_small, the
    cut distances of ``fields``): what the function takes.  The models
    other than d3q19_adj: :func:`stage_flops`.  d3q19_adj:
    every node rho, j and u; a collision node the two-rate MRT with the
    Brinkman velocity, Drag and Lift; a NEBB node its closure; an Inlet or
    Outlet collision node its flux objectives; a DesignSpace node its two
    material globals (4)."""
    if model.name != "d3q19_adj":
        return sum(stage_flops(model, flags, fields))
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


def _nebb_flops(E: np.ndarray, axis: int) -> int:
    """One ``lbm.nebb_boundary`` face on the velocity set ``E``: the two
    sums, S (2), rho or un (2), a normal correction (2) per unknown, each
    tangential momentum, its factor and a correction (2) per unknown that
    moves along it, an add per unknown."""
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops as _combo
    en = E[:, axis]
    unknown = int((en == 1).sum())
    n = _combo(en == 0) + _combo(en == -1) + 2 + 2 + 2 * unknown
    for t in range(3):
        if t != axis:
            n += _combo(np.where(en == 0, E[:, t], 0)) + 1 \
                + 2 * int(((en == 1) & (E[:, t] != 0)).sum())
    return n + unknown


def _macro_flops(E: np.ndarray) -> int:
    """rho and u = j / rho over a velocity set, in plane order."""
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops as _combo
    return _combo(np.ones(len(E))) + sum(_combo(E[:, a])
                                        for a in range(3)) + 3


def _moments_flops() -> int:
    """csrc/models/d3q27_moments.cuh's collision of 27 populations: the
    forward contractions (54 + 19), 1 / rho and u (4), the six central
    moments (12), their ratios (3), the relaxation combinations (the
    a/b/cc terms 13, the three diagonal moments 18, the off-diagonal 4),
    the higher moments (43 correlated), the forced velocity (3), the
    sparse x pass (25), the y and z passes (9 lines x 6, twice) and the
    inverse contractions (27 lines x 4, three axes)."""
    return 54 + 19 + 4 + 12 + 3 + 13 + 18 + 4 + 43 + 3 + 25 + 108 + 324


def _galilean_flops() -> int:
    """Geier's Galilean correction: the half-shifted velocity (6), the
    three derivatives (17), the three corrections (22) and their weights
    (6)."""
    return 6 + 17 + 22 + 6


def stage_flops(model: Model, flags: np.ndarray, fields=None) -> tuple:
    """Floating-point operations of each stage of a 3D ``DEVICE_MODELS``
    model's Iteration over a flag field (``node_step_flops`` is their
    sum):

    * d3q19_heat: every node rho and u, the temperature's sum (6) and, on
      an Outlet node, its flux (1); a collision node d3q19's two-rate MRT
      (two equilibria, f - feq, the stress rows and their projection, the
      keep factors (3), the relaxed sum (3 x 19), the forced velocity
      (3)) and the temperature's (its rate 3, per moving direction the
      equilibrium 4 and at rest 1, a relaxation 3 each); a NEBB face its
      closure, an inlet temperature 7;
    * d3q27: every collision node the moment collision; a NEBB face its
      closure; an Inlet or Outlet collision node its flux objectives;
    * d3q27_viscoplastic: every node rho and the forced u (3 more);
      an MRT node the forcing terms and shifted equilibria (per moving
      population the e.F and e.u dot products (5 + 5), the forcing term
      (3) and the equilibrium (11); at rest 10), S (its 6 sums over the
      nonzero coefficients, 27 x 6 differences), the deviator (6), S:S
      (14), the rates (12), the quadratic forms and the write-back (per
      moving population its terms and 4; at rest 2); a Zou/He face its
      closure;
    * d3q27_cumulant_qibb_small: every collision node the moment collision
      with the Galilean correction, its rate (5) and force (3); a NEBB face
      its closure; each cut link of a QIBB node (its distance in
      ``fields`` at least 0) its blend (8);
    * d3q19_heat_adj and its _art and _prop variants: every node rho and
      u, the temperature's sum (6) and the scaled velocity (3; _art's
      2 w - 1 two more, _prop's clip two); a collision node two equilibria,
      the BGK relaxation with the equilibrium difference (5 x 19), Drag (3),
      the diffusivity (4), its rate (3), the temperature's equilibrium (per
      moving direction 4 and at rest 1) and relaxation (3 x 7); a NEBB
      face its closure; an Outlet node its heat flux (1); a DesignSpace
      node Material (1; _prop's MaterialPenalty two more); a Propagate
      node the propagated weight (3);
    * d3q19_kuper: Run on a collision node: rho and u, the force (per
      moving direction 5 and the shell weight, the adds into the force),
      its scale and the forced velocity (12), two equilibria, and the BGK
      relaxation with the equilibrium difference (4 x 19); a NEBB face
      its closure; CalcPhi on every node: rho (18), the van der Waals
      pressure (17), and Magic, rho / 3, the difference, the clamp, the
      root and FAcc (6)."""
    from tclb_tpu_torch.models import get_model
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops as _combo
    name = model.name
    flags = np.asarray(flags)
    n = int(flags.size)
    coll = (gk.count_group(model, flags, "COLLISION")
            if "COLLISION" in model.group_masks else 0)

    def faces(*names):
        return gk.count_types(model, flags, *[t for t in names
                                              if t in model.node_types])

    if name in ("d3q19_heat", "d3q19_kuper") or name in HEAT_ADJ:
        from tclb_tpu_torch.models.d3q19 import E, M, STRESS, W
    else:
        E, W = get_model("d3q27").ei[:27], None
    E = np.asarray(E, dtype=np.int64)
    nebb = _nebb_flops(E, 0)
    if name == "d3q19_heat":
        lo, hi = STRESS
        norms = (M * M).sum(axis=1)
        back = (M[lo:hi] / norms[lo:hi, None]).T
        eq = equilibrium_flops(E, W)
        mrt = (2 * eq + 19 + sum(_combo(r) for r in M[lo:hi])
               + sum(_combo(r) for r in back) + 3 + 57 + 3)
        temp = 3 + 6 * (4 + 3) + (1 + 3)
        return ((_macro_flops(E) + 6) * n + (mrt + temp) * coll
                + nebb * faces("WVelocity", "WPressure", "EVelocity",
                               "EPressure")
                + 7 * faces("WVelocity", "EPressure")
                + faces("Outlet"),)
    if name in HEAT_ADJ:
        art, prop = name.endswith("_art"), name.endswith("_prop")
        eq = equilibrium_flops(E, W)
        every = (_macro_flops(E) + 6 + 3 + 2 * art
                 + 2 * prop)
        collide = 2 * eq + 5 * 19 + 3 + 4 + 3 + 25 + 21
        return (every * n + collide * coll
                + nebb * faces("WVelocity", "WPressure", "EVelocity",
                               "EPressure")
                + faces("Outlet")
                + (1 + 2 * prop) * gk.count_group(model, flags,
                                                  "DESIGNSPACE")
                + 3 * (faces("Propagate") if prop else 0),)
    if name == "d3q27":
        flags64 = flags.astype(np.int64)
        cmask = (flags64 & model.group_masks["COLLISION"]) != 0
        objective = sum(int((((flags64 & model.node_types[t].mask)
                              == model.node_types[t].value) & cmask).sum())
                        for t in ("Inlet", "Outlet"))
        return (_moments_flops() * coll
                + nebb * faces("WVelocity", "WPressure", "EVelocity",
                               "EPressure")
                + (_macro_flops(E) + 5 + 1 + 6) * objective,)
    if name == "d3q27_viscoplastic":
        moving = 26
        force = moving * (5 + 5 + 3 + 11) + 10
        stress = sum(_combo(E[:, a] * E[:, b]) for a in range(3)
                     for b in range(a, 3)) + 27 * 6
        quad = sum(_combo(np.array([E[k, a] * E[k, b] for a in range(3)
                                    for b in range(a, 3)])) + 4
                   for k in range(27) if E[k].any()) + 2
        mrt = force + stress + 6 + 14 + 12 + quad
        zou = _nebb_flops(E, 0) - 2      # rho from 1 + 3 P, no correction
        return ((_macro_flops(E) + 3) * n
                + mrt * gk.count_types(model, flags, "MRT")
                + zou * faces("NVelocity_ZouHe", "SVelocity_ZouHe",
                              "EVelocity_ZouHe", "WVelocity_ZouHe",
                              "NPressure_ZouHe", "SPressure_ZouHe",
                              "EPressure_ZouHe", "WPressure_ZouHe"),)
    if name == "d3q27_cumulant_qibb_small":
        cuts = 0
        if fields is not None:
            t = model.node_types["QIBB"]
            qibb = (flags.astype(np.int64) & t.mask) == t.value
            q0 = model.storage_index["q[1]"]
            q = np.asarray(fields[q0:q0 + 26].float().cpu().numpy()
                           if hasattr(fields, "cpu") else fields[q0:q0 + 26])
            cuts = int(((q >= 0) & qibb[None]).sum())
        return ((_moments_flops() + _galilean_flops() + 5 + 3) * coll
                + nebb * faces("WVelocity", "WPressure", "EVelocity",
                               "EPressure", "SVelocity", "SPressure",
                               "NVelocity", "NPressure")
                + 8 * cuts,)
    if name == "d3q19_kuper":
        eq = equilibrium_flops(E, W)
        force = 18 * (5 + 1) + sum(int(np.count_nonzero(E[:, a]))
                                   for a in range(3)) + 2
        run = (_macro_flops(E) + force + 12 + 2 * eq + 4 * 19) * coll \
            + nebb * faces("WVelocity", "WPressure", "EVelocity",
                           "EPressure")
        return run, (18 + 17 + 6) * n
    raise ValueError(f"no flop count for {name}")


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #

# model -> its loaded library and step block
_LIB: dict = {}


def lib(model: str) -> ctypes.CDLL:
    """``model``'s generic 3D library, built and bound at first use
    (:func:`bind`)."""
    entry = _LIB.setdefault(model, {})
    if "lib" not in entry:
        path, _ = build(model)
        entry.update(bind(ctypes.CDLL(str(path)), model, path.name))
    return entry["lib"]


def bind(lb, model: str, name: str) -> dict:
    """Bind a generic 3D library of ``model`` (``name``: its file, for
    errors): its layout sizes and stage count are checked against
    ``DEVICE_MODELS``.  Returns its ``_LIB`` entry: the library, its step
    block, its launches a step and, for an adjoint model, the grid of its
    reverse (``tile_b``: a block's z-planes, rows and columns)."""
    dm = DEVICE_MODELS[model]
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    argp = ctypes.POINTER(gk.c_args_type(model))
    lb.generic3d_layout.argtypes = [ip] * 8
    lb.generic3d_layout.restype = None
    lb.generic3d_plan.argtypes = [ip]
    lb.generic3d_plan.restype = None
    lb.generic3d_step.argtypes = [p, p, p, p, argp, p, p, i, p]
    lb.generic3d_step.restype = i
    lb.generic3d_step_series.argtypes = [p, p, p, p, argp, p, p, i, i, p,
                                         p, i, p]
    lb.generic3d_step_series.restype = i
    lb.generic_error_string.argtypes = [i]
    lb.generic_error_string.restype = ctypes.c_char_p
    entry = {"lib": lb}
    if dm.adjoint:
        lb.generic3d_step_b.argtypes = [p, p, p, p, argp, p, p, p, p, i, p]
        lb.generic3d_step_b.restype = i
        lb.generic3d_step_b_tile.argtypes = [ip] * 3
        lb.generic3d_step_b_tile.restype = None
        tile = [ctypes.c_int(0) for _ in range(3)]
        lb.generic3d_step_b_tile(*[ctypes.byref(v) for v in tile])
        entry["tile_b"] = tuple(v.value for v in tile)
    vals = [ctypes.c_int(0) for _ in range(8)]
    lb.generic3d_layout(*[ctypes.byref(v) for v in vals])
    block_y, block_x, *sizes = (v.value for v in vals)
    want = [len(dm.storage), len(dm.settings), len(dm.node_types),
            len(dm.groups), len(dm.zonal), len(dm.globals_)]
    if sizes != want:
        raise RuntimeError(f"{name} was built with layout sizes "
                           f"{sizes}, the wrapper expects {want}")
    stages = ctypes.c_int(0)
    lb.generic3d_plan(ctypes.byref(stages))
    if stages.value != len(dm.plan):
        raise RuntimeError(f"{name} runs {stages.value} stages, "
                           f"the wrapper expects {len(dm.plan)}")
    # launches a step: one a stage
    entry.update(block=(block_y, block_x), passes=stages.value)
    return entry


def n_blocks(a: gk.StepArgs) -> int:
    """Blocks of one ``generic3d_step`` launch: the length of its
    partials (the multi-pass carry row aside)."""
    by, bx = _LIB[a.model]["block"]
    return -(-a.ny // by) * -(-a.nx // bx) * a.nz


def n_blocks_b(a: gk.StepArgs) -> int:
    """Blocks of one ``generic3d_step_b`` launch (its grid, ``tile_b``):
    the length of its partials."""
    tz, ty, tx = _LIB[a.model]["tile_b"]
    return -(-a.nz // tz) * -(-a.ny // ty) * -(-a.nx // tx)


def _launch_step(fields, flags, ztab, a: gk.StepArgs, with_globals: bool,
                 series=None, it: int = 0):
    """One ``generic3d_step`` call, or with :class:`SeriesInputs`
    ``series`` one ``generic3d_step_series`` call at iteration ``it``: one
    launch a stage of the plan (each counted)."""
    gk.validate(fields, flags, ztab, a)
    if a.model not in DEVICE_MODELS:
        raise ValueError(f"{a.model} has no generic 3D kernels")
    if fields.dtype != torch.float32:
        raise ValueError("the generic 3D kernels take f32 storage only")
    if series is not None:
        sargs = gk.series_args(series, a, it, fields.device)
    lb = lib(a.model)
    dev, stream = gk.device_and_stream(fields)
    out = torch.empty_like(fields)
    passes = _LIB[a.model]["passes"]
    partials = gout = None
    if with_globals:
        n_g = len(DEVICE_MODELS[a.model].globals_)
        # one partial per block and global, and the row that carries a
        # multi-pass step's sums between its passes
        partials = torch.empty((n_blocks(a) + 1, max(n_g, 1)),
                               dtype=torch.float64, device=fields.device)
        gout = torch.empty((max(n_g, 1),), dtype=torch.float32,
                           device=fields.device)
    head = (fields.data_ptr(), out.data_ptr(), flags.data_ptr(),
            ztab.data_ptr(), ctypes.byref(a.c_struct))
    tail = (gk._ptr(partials), gk._ptr(gout), dev, stream)
    if series is None:
        gk.check(lb, lb.generic3d_step(*head, *tail), "generic3d_step")
        LAUNCHES["generic3d_step"] += passes
        FLAVOUR_LAUNCHES["globals" if with_globals else "plain"] += passes
    else:
        gk.check(lb, lb.generic3d_step_series(*head, *sargs, *tail),
                 "generic3d_step_series")
        SERIES_LAUNCHES[SERIES_KERNELS[1 if with_globals else 0]] += passes
    if with_globals:
        return out, gout[:len(DEVICE_MODELS[a.model].globals_)]
    return out


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
    physics, f32, whose Iteration plan reaches no further than
    ``generic_kernels.HALO`` (the reference's bound; the passes themselves
    take any reach).  Any plan runs, with Field reads: its last stage
    computes no ring by construction (``generic_kernels.action_plan``)."""
    if model.name not in DEVICE_MODELS or model.ndim != 3 \
            or len(shape) != 3 or dtype != torch.float32 \
            or min(int(s) for s in shape) < 1:
        return False
    return gk.action_plan(model)[1] <= gk.HALO


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


def select_engine(model: Model, shape, dtype, series: bool = False,
                  storage_dtype=None, storage_repr: str = "raw") -> tuple:
    """``(iterate, tag)`` of the band engine where ``supports()`` accepts
    this configuration, else ``(None, None)``; the band engine reads a
    Control series (``series``) itself.  The kernel has no bf16 rung yet
    (ROADMAP queue 2): a narrowed stack (``storage_dtype`` other than
    ``dtype``) is rejected and runs eager."""
    if storage_dtype not in (None, dtype):
        return None, None
    if supports(model, shape, dtype):
        return (make_band_iterate(model, shape),
                f"cuda_generic3d_band[{model.name},fuse=1]")
    return None, None
