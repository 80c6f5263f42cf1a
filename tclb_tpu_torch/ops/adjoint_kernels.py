"""The hand-written backward kernels of the generic 2D and 3D engines,
their plain PyTorch version, and the differentiable step the adjoint runs
take.

``step_b`` (kernel ``generic2d_step_b``, ``csrc/generic2d_adjoint.cuh``)
replaces the JAX package's fused backward band kernel
(``tclb_tpu/ops/pallas_adjoint.py:make_diff_step``, ``call_bwd``) at chunk
k = 1: given one Iteration's primal input, the zone table of its zonal
settings, the cotangent of its output fields and of its SUM globals, it
returns the cotangent of the input fields and of the settings vector
(zonal settings take none, as in the reference outside its series
flavour).  The reverse physics is the model's
hand-written ``stage_b<0>`` in its device header (the counterpart of
TCLB's Tapenade-generated ``Run_b``); models with one (``DeviceModel.
adjoint``) build it into their generic library.  Bound by bytes: the
primal, the output cotangent and the flags are read once and the input
cotangent written once (``launch_bytes_b``).

A two-stage 2D plan (``d2q9_kuper_adj``) reverses in two launches of
``generic2d_step_b``'s kernel, one call of its entry: each stage's
``stage_b``, last stage first, through a scratch stack of the state's
size; the wrapper counts both launches.

For a 3D model the same wrapper launches ``generic3d_step_b``
(``csrc/generic3d_adjoint.cuh``), which replaces the fused 3D backward
(``pallas_adjoint.py:_mk_call_bwd_3d`` for ``_make_diff_step_3d``) at
k = 1 in one launch: each node's cotangents q pushed to the nodes that
pull them.

The wrapper launches the kernel for a CUDA tensor (or raises) and runs
``step_b_plain`` for a CPU tensor; it counts its launches in
``LAUNCHES``.  ``step_b_plain`` is ``torch.func.vjp`` of the plain
forward step with the settings entering per node, so that its settings
cotangent is summed in float64 as the kernel sums it.

``make_diff_step`` builds the step ``tclb_tpu_torch.adjoint.run`` drives
on the card: a ``torch.autograd.Function`` whose forward is
``generic_kernels.step_globals`` (``generic3d_kernels.step_globals`` in 3D)
and whose backward is ``step_b``, with the
JAX package's protocol (``chunk``, ``returns_inc``, ``prepare``,
``engine_name``).  k > 1 and the Control-series flavour wait (ROADMAP
queue 2).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import LatticeState, SimParams
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.ops import generic3d_kernels as g3
from tclb_tpu_torch.ops import generic_kernels as gk

KERNELS = ("generic2d_step_b", "generic3d_step_b")
# launches per kernel; the wrapper adds one where it launches, nowhere else
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_diff(model: Model, shape, dtype, storage_dtype=None) -> bool:
    """Whether the differentiable kernel step covers this configuration:
    the forward kernels run it (``generic_kernels.supports`` or
    ``generic3d_kernels.supports``) and the model's header has a reverse
    stage for every stage of its Iteration (``DeviceModel.adjoint``): one
    stage pulling one node far, or in 2D two (two launches of
    ``generic2d_step_b``'s kernel: the last stage computes no ring, the
    first a ring of one, so that each reverse gathers from one node
    away).  f32 storage only: the backward
    kernels have no bf16 rung (a narrowed ``storage_dtype`` is
    rejected)."""
    dm = gk.DEVICE_MODELS.get(model.name)
    if not (dm is not None and dm.adjoint
            and storage_dtype in (None, dtype)
            and (gk.supports(model, shape, dtype)
                 or g3.supports(model, shape, dtype))):
        return False
    plan, reach = gk.action_plan(model)
    if len(plan) == 1:
        return reach <= 1
    return (dm.ndim == 2 and len(plan) == 2 and plan[0][1] <= 1
            and plan[1][1] == 0 and reach <= 2)


# --------------------------------------------------------------------------- #
# Bounds
# --------------------------------------------------------------------------- #


def launch_bytes_b(model: Model, shape) -> int:
    """Device-memory bytes one ``generic2d_step_b`` or ``generic3d_step_b``
    call must move: the primal fields, the output cotangent and the int32
    flags read once, the input cotangent written once."""
    n = int(np.prod(shape))
    return (3 * model.n_storage + 1) * 4 * n


def node_step_b_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations of one Iteration's reverse over a flag
    field: the forward it recomputes (``node_step_flops``) and the
    reverse stage, counted by hand from the header's ``run_b`` (one
    function a model, ``_REVERSE_FLOPS``)."""
    if model.name not in _REVERSE_FLOPS:
        raise ValueError(f"no reverse flop count for {model.name}")
    return _REVERSE_FLOPS[model.name](model, flags)


def _heat_adj_b_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_heat_adj's reverse (``run_b`` in
    csrc/models/d2q9_heat_adj.cuh) on top of the forward: a collision node
    the two collisions' cotangents (9 x 14), the temperature
    equilibrium's (8 x 7 + 1), two reverse equilibria (2 x 110), the
    settings (12); every node: the Brinkman velocity, the divisions by rho
    and the sums (9 x 6 + 14); a WVelocity node its closure and inlet
    temperature (40), an EPressure node its closure (30)."""
    coll = gk.count_group(model, flags, "COLLISION")
    return (gk.node_step_flops(model, flags)
            + (126 + 57 + 220 + 12) * coll
            + 68 * int(np.asarray(flags).size)
            + 40 * gk.count_types(model, flags, "WVelocity")
            + 30 * gk.count_types(model, flags, "EPressure"))


def _d3q19_adj_b_flops(model: Model, flags: np.ndarray) -> int:
    """d3q19_adj's reverse, counted by hand from ``run_b`` in
    csrc/models/d3q19_adj.cuh, on top of the forward it recomputes
    (``generic3d_kernels.node_step_flops``): a collision node the output
    cotangents times kh (19), the two dot products for the keep factors
    (4 x 19), the stress projection's transpose and the basis' (2 x 2 x
    69 nonzeros), the settings (3), two reverse equilibria (2 x 276), the
    Brinkman velocity, Drag, Lift and nw (24); every node u = j / rho
    (13) and the populations' cotangents (19 x 3); a NEBB node its
    transpose (40); an Inlet or Outlet collision node its flux reverse
    (40); a DesignSpace node the material cotangents (4)."""
    coll = gk.count_group(model, flags, "COLLISION")
    faces = gk.count_types(model, flags, "WVelocity", "WPressure",
                           "EVelocity", "EPressure")
    flags64 = np.asarray(flags).astype(np.int64)
    objective = int((((flags64 & model.group_masks["OBJECTIVE"]) != 0)
                     & ((flags64 & model.group_masks["COLLISION"]) != 0))
                    .sum())
    return (g3.node_step_flops(model, flags)
            + (19 + 76 + 276 + 3 + 552 + 24) * coll
            + (13 + 57) * int(np.asarray(flags).size) + 40 * faces
            + 40 * objective
            + 4 * gk.count_group(model, flags, "DESIGNSPACE"))


def _adj_b_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_adj's reverse, counted by hand from ``run_b`` in
    csrc/models/d2q9_adj.cuh, on top of the forward it recomputes: an MRT
    node the transposes of the inverse basis and of ``M`` over their
    nonzeros, omega's and the kept rows' cotangents (6) and the kept rows'
    transpose, -afb (9), two reverse equilibria (2 x 110), the Brinkman
    velocity, Drag, Lift and nw (16) and the settings (4); an MRT, Inlet or
    Outlet node u = j / rho and the populations (9 x 6 + 14); an Inlet or
    Outlet node the flux objectives (20); a Zou/He face its transpose
    (30); a DesignSpace node the material cotangents (4)."""
    kept, fwd, back = gk._mrt_kept_flops()
    mrt = gk.count_types(model, flags, "MRT")
    objective = gk.count_types(model, flags, "Inlet", "Outlet")
    return (gk.node_step_flops(model, flags)
            + (back + fwd + 6 + kept + 9 + 220 + 16 + 4) * mrt
            + 68 * (mrt + objective) + 20 * objective
            + 30 * gk._faces(model, flags)
            + 4 * gk.count_group(model, flags, "DESIGNSPACE"))


def _mixing_b_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_optimalMixing's reverse (``run_b`` in
    csrc/models/d2q9_optimal_mixing.cuh) on top of the forward: a collision
    node the flow's relaxation (9 x 5) and the scalar's with its
    equilibrium (5 x 9), the squared temperature (2), a reverse equilibrium
    (110), u = j / rho and the populations (68) and the temperature's sum
    (5); a MovingWall node NMovingWallForce's cotangent (3 + 9)."""
    return (gk.node_step_flops(model, flags)
            + (45 + 45 + 2 + 110 + 68 + 5)
            * gk.count_group(model, flags, "COLLISION")
            + 12 * gk.count_types(model, flags, "MovingWall"))


def _plate_b_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_plate's reverse (``run_b`` in csrc/models/d2q9_plate.cuh) on
    top of the forward: a collision node the relaxation (9 x 5), the rate's
    chain and its settings (25), the stress norm's (35), two reverse
    equilibria (2 x 110) and u = j / rho with the populations (68); an
    Inlet or Outlet collision node the flux objectives (20); a Wall node
    the reaction globals (4 + 9 x 4); a face its transpose (40)."""
    coll = gk.count_group(model, flags, "COLLISION")
    return (gk.node_step_flops(model, flags)
            + (45 + 25 + 35 + 220 + 68) * coll
            + 20 * gk.count_types(model, flags, "Inlet", "Outlet")
            + 40 * gk.count_types(model, flags, "Wall")
            + 40 * gk._faces(model, flags))


def _wave2d_b_flops(model: Model, flags: np.ndarray) -> int:
    """wave2d's reverse (``run_b`` in csrc/models/wave2d.cuh) on top of the
    forward: every node the height copies' cotangent (4), Loss's (2), the
    masked height's (1 + 3), u's (2), WaveK's (2), du's (1) and h's (2);
    an Obj1 node TotalDiff's (3)."""
    return (gk.node_step_flops(model, flags)
            + 17 * int(np.asarray(flags).size)
            + 3 * gk.count_types(model, flags, "Obj1"))


def _diff_b_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_diff's reverse (``run_b`` in csrc/models/d2q9_diff.cuh) on
    top of the forward: a collision node, per population the relaxation's
    cotangents (the equilibrium again 7, 1 - omega and omega's 5, c's 8,
    e.u's 3, UX's and UY's 4, the source's 2), and TotalC's (1); every
    node c's cotangent on the nine populations (9); a DesignSpace node
    Source's and w's (3); an Outlet node OutC's (1)."""
    return (gk.node_step_flops(model, flags)
            + (9 * 29 + 1) * gk.count_group(model, flags, "COLLISION")
            + 9 * int(np.asarray(flags).size)
            + 3 * gk.count_group(model, flags, "DESIGNSPACE")
            + gk.count_types(model, flags, "Outlet"))


def _heat_adj3d_b_flops(model: Model, flags: np.ndarray) -> int:
    """The 3D heat design family's reverse (``run_b`` in
    csrc/models/d3q19_heat_adj_common.cuh) on top of the forward it
    recomputes: a collision node the flow's relaxation (omega's, the
    populations' and the equilibria's, 5 x 19), two reverse equilibria
    (2 x 276, as d3q19_adj's), the temperature's equilibrium again (25),
    its relaxation, rate and equilibrium's cotangents (7 x 10 + 6 x 3),
    alfa's chain and its settings (10) and Drag's (5); every node the
    scaled velocity's (9), the temperature's sum (7), u = j / rho (13) and
    the populations (19 x 3); a NEBB face its transpose (40); a
    WVelocity node the inlet temperature's (14); an Outlet node the heat
    flux's (3); a DesignSpace node the material globals' (1; _prop 4);
    _prop's clip on every node (4) and a Propagate node its weight's
    (4)."""
    prop = model.name.endswith("_prop")
    coll = gk.count_group(model, flags, "COLLISION")
    n = int(np.asarray(flags).size)
    return (g3.node_step_flops(model, flags)
            + (95 + 552 + 25 + 88 + 10 + 5) * coll
            + (9 + 7 + 13 + 57 + 4 * prop) * n
            + 40 * gk.count_types(model, flags, "WVelocity", "WPressure",
                                  "EVelocity", "EPressure")
            + 14 * gk.count_types(model, flags, "WVelocity")
            + 3 * gk.count_types(model, flags, "Outlet")
            + (1 + 3 * prop) * gk.count_group(model, flags, "DESIGNSPACE")
            + (4 * gk.count_types(model, flags, "Propagate") if prop
               else 0))


def _kuper_adj_b_flops(model: Model, flags: np.ndarray) -> int:
    """d2q9_kuper_adj's two reverse stages (``run_b`` and ``calc_phi_b``
    in csrc/models/d2q9_kuper_adj.cuh) on top of the forward each
    recomputes (both stages, ``node_step_flops``): a collision node the
    transposes of the inverse basis and of ``M`` over their nonzeros, the
    keep factors' cotangents (18), two reverse equilibria (2 x 110), the
    forced velocity's (12), the force's (8 x 12 and 4), u = j / rho and
    the populations (9 x 4 + 10); every node CalcPhi's reverse (the
    equation of state's chain 30, the root, wd and FAcc 8); a Wall node
    its globals' (18), a MovingWall node its velocity's (12)."""
    from tclb_tpu_torch.models import d2q9_kuper as kuper
    from tclb_tpu_torch.ops import lbm
    from tclb_tpu_torch.ops.d2q9_kernels import _combo_flops
    M = kuper.M
    minv = lbm.inverse_basis(M)
    bases = (sum(_combo_flops(row) for row in M)
             + sum(_combo_flops(row) for row in minv.T))
    coll = gk.count_group(model, flags, "COLLISION")
    return (gk.node_step_flops(model, flags)
            + (bases + 18 + 220 + 12 + 96 + 4 + 46) * coll
            + 38 * int(np.asarray(flags).size)
            + 18 * gk.count_types(model, flags, "Wall")
            + 12 * gk.count_types(model, flags, "MovingWall"))


_REVERSE_FLOPS = {"d2q9_heat_adj": _heat_adj_b_flops,
                  "d3q19_heat_adj": _heat_adj3d_b_flops,
                  "d3q19_heat_adj_art": _heat_adj3d_b_flops,
                  "d3q19_heat_adj_prop": _heat_adj3d_b_flops,
                  "d2q9_kuper_adj": _kuper_adj_b_flops,
                  "d3q19_adj": _d3q19_adj_b_flops, "d2q9_adj": _adj_b_flops,
                  "d2q9_optimalMixing": _mixing_b_flops,
                  "d2q9_plate": _plate_b_flops, "wave2d": _wave2d_b_flops,
                  "d2q9_diff": _diff_b_flops}


# --------------------------------------------------------------------------- #
# The plain version
# --------------------------------------------------------------------------- #


def step_b_plain(fields, flags, ztab, a: gk.StepArgs, lam_out, lam_g):
    """What ``step_b`` computes: ``torch.func.vjp`` of the plain step with
    its globals (``generic_kernels.plain_steps``' step) at these inputs.
    Returns ``(lam_in, settings cotangent)``; the settings enter per node
    and their cotangent is summed in float64."""
    m = gk._get_model(a.model)
    table = gk._plain_params(ztab, a).zone_table
    sett = torch.tensor(a.settings, dtype=fields.dtype, device=fields.device)
    planes = sett.reshape((-1,) + (1,) * len(a.shape)).expand(
        (len(a.settings),) + a.shape)
    step = gk._action_step(a.model, True)
    zeros = torch.zeros((m.n_globals,), dtype=fields.dtype,
                        device=fields.device)

    def forward(f, s):
        st = step(LatticeState(fields=f, flags=flags, globals_=zeros,
                               iteration=0),
                  SimParams(settings=s, zone_table=table))
        return st.fields, st.globals_

    _, vjp = torch.func.vjp(forward, fields, planes)
    lam_in, lam_planes = vjp((lam_out, lam_g))
    return lam_in, lam_planes.double().flatten(1).sum(dim=1)


# --------------------------------------------------------------------------- #
# The kernel's wrapper
# --------------------------------------------------------------------------- #


def step_b(fields, flags, ztab, a: gk.StepArgs, lam_out, lam_g, out=None):
    """The reverse of one Iteration (kernel ``generic2d_step_b``, or
    ``generic3d_step_b`` for a 3D model): ``(lam_in, settings
    cotangent)``, the latter float64.  A two-stage plan's reverse also
    reads the step's primal output ``out``; without one the wrapper
    computes it with ``generic_kernels.step``."""
    if fields.device.type == "cpu":
        return step_b_plain(fields, flags, ztab, a, lam_out, lam_g)
    gk.validate(fields, flags, ztab, a)
    dm = gk.DEVICE_MODELS[a.model]
    name = f"generic{dm.ndim}d_step_b"
    if not dm.adjoint:
        raise ValueError(f"{a.model}'s device header has no reverse stage")
    for t, sh in ((lam_out, tuple(fields.shape)), (lam_g, (len(dm.globals_),))):
        if t.device != fields.device or t.dtype != torch.float32 \
                or tuple(t.shape) != sh or not t.is_contiguous():
            raise ValueError(
                f"{name} cotangent {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: needs contiguous {sh} float32 on "
                f"{fields.device}")
    if dm.ndim == 3:
        return _launch_step_b_3d(fields, flags, ztab, a, lam_out, lam_g)
    return _launch_step_b_2d(fields, flags, ztab, a, lam_out, lam_g, out)


def _launch_step_b_2d(fields, flags, ztab, a: gk.StepArgs, lam_out, lam_g,
                      out):
    """``generic2d_step_b``: one launch a stage of the plan, each counted.
    A two-stage plan's takes the step's primal output ``out`` and a
    scratch stack of the state's size (stage 1's reverse into it, then
    stage 0's from it); its partials one row per block of the grid, used
    by each launch in turn."""
    two = len(gk.DEVICE_MODELS[a.model].plan) == 2
    n_sett = len(a.settings)
    sett = torch.empty((1 + two, n_sett), dtype=torch.float64,
                       device=fields.device)
    fout = lam_mid = sett_mid = None
    if two:
        if out is None:
            out = gk.step(fields, flags, ztab, a)
        if out.device != fields.device or out.dtype != torch.float32 \
                or out.shape != fields.shape or not out.is_contiguous():
            raise ValueError(f"generic2d_step_b's primal output "
                             f"{tuple(out.shape)} {out.dtype} on "
                             f"{out.device}: needs the contiguous float32 "
                             "stack of the step")
        mid = torch.empty_like(fields)
        fout, lam_mid, sett_mid = (out.data_ptr(), mid.data_ptr(),
                                   sett[0].data_ptr())
    lb = gk.lib(a.model)
    dev, stream = gk.device_and_stream(fields)
    ty, tx = gk._LIB[a.model]["tile_b"]
    blocks = -(-a.ny // ty) * -(-a.nx // tx)
    lam_in = torch.empty_like(fields)
    partials = torch.empty((blocks, n_sett), dtype=torch.float64,
                           device=fields.device)
    rc = lb.generic2d_step_b(
        fields.data_ptr(), fout, lam_out.data_ptr(), flags.data_ptr(),
        ztab.data_ptr(), ctypes.byref(a.c_struct), lam_g.data_ptr(),
        lam_mid, lam_in.data_ptr(), partials.data_ptr(), sett_mid,
        sett[-1].data_ptr(), dev, stream)
    gk.check(lb, rc, "generic2d_step_b")
    LAUNCHES["generic2d_step_b"] += 1 + two
    return lam_in, sett[-1]


def _launch_step_b_3d(fields, flags, ztab, a: gk.StepArgs, lam_out, lam_g):
    """``generic3d_step_b``: one launch, its partials one row per block of
    its grid (``g3.n_blocks_b``)."""
    lb = g3.lib(a.model)
    dev, stream = gk.device_and_stream(fields)
    n_sett = len(a.settings)
    lam_in = torch.empty_like(fields)
    partials = torch.empty((g3.n_blocks_b(a), n_sett), dtype=torch.float64,
                           device=fields.device)
    sett = torch.empty((n_sett,), dtype=torch.float64, device=fields.device)
    rc = lb.generic3d_step_b(
        fields.data_ptr(), lam_out.data_ptr(), flags.data_ptr(),
        ztab.data_ptr(), ctypes.byref(a.c_struct), lam_g.data_ptr(),
        lam_in.data_ptr(), partials.data_ptr(), sett.data_ptr(), dev,
        stream)
    gk.check(lb, rc, "generic3d_step_b")
    LAUNCHES["generic3d_step_b"] += 1
    return lam_in, sett


# --------------------------------------------------------------------------- #
# The differentiable step
# --------------------------------------------------------------------------- #


class _KernelStep(torch.autograd.Function):
    """One Iteration: forward ``generic2d_step`` or ``generic3d_step``
    (globals flavour), backward ``step_b``.  ``settings`` routes the
    settings cotangent; the kernels read the settings from ``args``."""

    @staticmethod
    def forward(ctx, fields, settings, flags, ztab, args):
        fwd = g3.step_globals if args.nz else gk.step_globals
        out, g = fwd(fields, flags, ztab, args)
        # a two-stage reverse reads the step's output too (the next step's
        # input: saving it keeps no more memory alive)
        two = len(gk.DEVICE_MODELS[args.model].plan) == 2
        ctx.save_for_backward(fields, flags, ztab, *((out,) if two else ()))
        ctx.args = args
        ctx.settings_dtype = settings.dtype
        return out, g

    @staticmethod
    def backward(ctx, lam_out, lam_g):
        fields, flags, ztab, *out = ctx.saved_tensors
        lam_in, lam_s = step_b(fields, flags, ztab, ctx.args,
                               lam_out.contiguous(), lam_g.contiguous(),
                               *out)
        return lam_in, lam_s.to(ctx.settings_dtype), None, None, None


def make_diff_step(model: Model, shape, dtype=torch.float32):
    """``step(state, params) -> (state, globals)`` advancing one Iteration
    on the kernels, differentiable through ``torch.autograd``: forward
    ``generic2d_step``'s globals flavour, backward ``generic2d_step_b``
    (``generic3d_step`` and ``generic3d_step_b`` for a 3D model, tagged
    ``cuda_adjoint3d``).
    The protocol of the JAX package's ``pallas_adjoint.make_diff_step``:
    ``state.globals_`` keeps the last iteration's globals and the second
    value is the chunk's objective increment (``returns_inc``);
    ``prepare(state, params)`` binds the loop invariants (kernel
    constants, zone table, flags) once per gradient call."""
    if not supports_diff(model, shape, dtype):
        raise ValueError(f"the kernel adjoint does not cover {model.name} "
                         f"{tuple(shape)} {dtype}")
    si = model.setting_index

    def prepare(state: LatticeState, params: SimParams):
        if params.time_series is not None:
            raise NotImplementedError(
                "the kernel adjoint under a <Control> time series (K7's "
                "series flavour) is not ported to PyTorch yet (ROADMAP "
                "queue 1, item 11); the eager adjoint engine reads it")
        ztab = params.zone_table[[si[n] for n in model.zonal_settings]]
        a = gk.step_args(model, tuple(state.flags.shape),
                         params.settings.detach().cpu().numpy())
        ztab = ztab.detach().contiguous()
        flags = state.flags.contiguous()
        sett = params.settings

        def step(s: LatticeState, p2: SimParams):
            out, g = _KernelStep.apply(s.fields.contiguous(), sett, flags,
                                       ztab, a)
            return dataclasses.replace(
                s, fields=out, globals_=g.to(s.globals_.dtype),
                iteration=s.iteration + 1), g
        return step

    def step(state: LatticeState, params: SimParams):
        return prepare(state, params)(state, params)

    step.prepare = prepare
    step.chunk = 1
    step.returns_inc = True
    kind = "cuda_adjoint3d" if model.ndim == 3 else "cuda_adjoint"
    step.engine_name = f"{kind}[{model.name},k=1]"
    return step

