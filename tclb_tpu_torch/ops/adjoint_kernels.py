"""The hand-written backward kernel of the generic 2D engine, its plain
PyTorch version, and the differentiable step the adjoint runs take.

``step_b`` (kernel ``generic2d_step_b``, ``csrc/generic2d_adjoint.cuh``)
replaces the JAX package's fused backward band kernel
(``tclb_tpu/ops/pallas_adjoint.py:make_diff_step``, ``call_bwd``) at chunk
k = 1: given one Iteration's primal input, the cotangent of its output
fields and of its SUM globals, it returns the cotangent of the input
fields and of the settings vector.  The reverse physics is the model's
hand-written ``stage_b<0>`` in its device header (the counterpart of
TCLB's Tapenade-generated ``Run_b``); models with one (``DeviceModel.
adjoint``) build it into their generic library.  Bound by bytes: the
primal, the output cotangent and the flags are read once and the input
cotangent written once (``launch_bytes_b``).

The wrapper launches the kernel for a CUDA tensor (or raises) and runs
``step_b_plain`` for a CPU tensor; it counts its launches in
``LAUNCHES``.  ``step_b_plain`` is ``torch.func.vjp`` of the plain
forward step with the settings entering per node, so that its settings
cotangent is summed in float64 as the kernel sums it.

``make_diff_step`` builds the step ``tclb_tpu_torch.adjoint.run`` drives
on the card: a ``torch.autograd.Function`` whose forward is
``generic_kernels.step_globals`` and whose backward is ``step_b``, with the
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
from tclb_tpu_torch.ops import generic_kernels as gk

KERNELS = ("generic2d_step_b",)
# launches per kernel; the wrapper adds one where it launches, nowhere else
LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_diff(model: Model, shape, dtype) -> bool:
    """Whether the differentiable kernel step covers this configuration:
    the forward kernels run it (``generic_kernels.supports``), the
    model's header has a reverse stage, and its Iteration is one stage
    pulling one node far (the backward kernel's one-node ring)."""
    dm = gk.DEVICE_MODELS.get(model.name)
    return (dm is not None and dm.adjoint
            and gk.supports(model, shape, dtype)
            and len(model.actions["Iteration"]) == 1
            and gk.action_plan(model)[1] <= 1)


# --------------------------------------------------------------------------- #
# Bounds
# --------------------------------------------------------------------------- #


def launch_bytes_b(model: Model, shape) -> int:
    """Device-memory bytes one ``generic2d_step_b`` launch must move: the
    primal fields, the output cotangent and the int32 flags read once, the
    input cotangent written once."""
    n = int(np.prod(shape))
    return (3 * model.n_storage + 1) * 4 * n


def node_step_b_flops(model: Model, flags: np.ndarray) -> int:
    """Floating-point operations of one Iteration's reverse over a flag
    field: the forward it recomputes (``node_step_flops``) and the
    reverse of d2q9_heat_adj's stage, counted by hand from
    ``run_b`` in csrc/models/d2q9_heat_adj.cuh.  A collision node: the
    two collisions' cotangents (9 x 14), the temperature equilibrium's
    (8 x 7 + 1), two reverse equilibria (2 x 110), the settings (12);
    every node: the Brinkman velocity, the divisions by rho and the sums
    (9 x 6 + 14); a WVelocity node its closure and inlet temperature (40),
    an EPressure node its closure (30)."""
    if model.name != "d2q9_heat_adj":
        raise ValueError(f"no reverse flop count for {model.name}")
    coll = gk.count_group(model, flags, "COLLISION")
    return (gk.node_step_flops(model, flags)
            + (126 + 57 + 220 + 12) * coll
            + 68 * int(np.asarray(flags).size)
            + 40 * gk.count_types(model, flags, "WVelocity")
            + 30 * gk.count_types(model, flags, "EPressure"))


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
    planes = sett[:, None, None].expand(len(a.settings), a.ny, a.nx)
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
    return lam_in, lam_planes.double().sum(dim=(1, 2))


# --------------------------------------------------------------------------- #
# The kernel's wrapper
# --------------------------------------------------------------------------- #


def step_b(fields, flags, ztab, a: gk.StepArgs, lam_out, lam_g):
    """The reverse of one Iteration (kernel ``generic2d_step_b``):
    ``(lam_in, settings cotangent)``, the latter float64."""
    if fields.device.type == "cpu":
        return step_b_plain(fields, flags, ztab, a, lam_out, lam_g)
    gk.validate(fields, flags, ztab, a)
    dm = gk.DEVICE_MODELS[a.model]
    if not dm.adjoint:
        raise ValueError(f"{a.model}'s device header has no reverse stage")
    for t, sh in ((lam_out, tuple(fields.shape)), (lam_g, (len(dm.globals_),))):
        if t.device != fields.device or t.dtype != torch.float32 \
                or tuple(t.shape) != sh or not t.is_contiguous():
            raise ValueError(
                f"generic2d_step_b cotangent {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: needs contiguous {sh} float32 on "
                f"{fields.device}")
    lb = gk.lib(a.model)
    dev, stream = gk.device_and_stream(fields)
    ty, tx = gk._LIB[a.model]["tile_b"]
    blocks = -(-a.ny // ty) * -(-a.nx // tx)
    n_sett = len(dm.settings)
    lam_in = torch.empty_like(fields)
    partials = torch.empty((blocks, n_sett), dtype=torch.float64,
                           device=fields.device)
    sett = torch.empty((n_sett,), dtype=torch.float64, device=fields.device)
    rc = lb.generic2d_step_b(
        fields.data_ptr(), lam_out.data_ptr(), flags.data_ptr(),
        ctypes.byref(a.c_struct), lam_g.data_ptr(), lam_in.data_ptr(),
        partials.data_ptr(), sett.data_ptr(), dev, stream)
    gk.check(lb, rc, "generic2d_step_b")
    LAUNCHES["generic2d_step_b"] += 1
    return lam_in, sett


# --------------------------------------------------------------------------- #
# The differentiable step
# --------------------------------------------------------------------------- #


class _KernelStep(torch.autograd.Function):
    """One Iteration: forward ``generic2d_step`` (globals flavour),
    backward ``generic2d_step_b``.  ``settings`` routes the settings
    cotangent; the kernels read the settings from ``args``."""

    @staticmethod
    def forward(ctx, fields, settings, flags, ztab, args):
        out, g = gk.step_globals(fields, flags, ztab, args)
        ctx.save_for_backward(fields, flags, ztab)
        ctx.args = args
        ctx.settings_dtype = settings.dtype
        return out, g

    @staticmethod
    def backward(ctx, lam_out, lam_g):
        fields, flags, ztab = ctx.saved_tensors
        lam_in, lam_s = step_b(fields, flags, ztab, ctx.args,
                               lam_out.contiguous(), lam_g.contiguous())
        return lam_in, lam_s.to(ctx.settings_dtype), None, None, None


def make_diff_step(model: Model, shape, dtype=torch.float32):
    """``step(state, params) -> (state, globals)`` advancing one Iteration
    on the kernels, differentiable through ``torch.autograd``: forward
    ``generic2d_step``'s globals flavour, backward ``generic2d_step_b``.
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
    step.engine_name = f"cuda_adjoint[{model.name},k=1]"
    return step

