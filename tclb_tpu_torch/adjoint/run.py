"""Differentiable objective runs: checkpointed loops, unsteady and steady
gradients, and the finite-difference gradient check.

The port's counterpart of the JAX package's ``adjoint/run.py``:

* unsteady adjoint = the reverse sweep over a recorded horizon with
  log-spaced state snapshots (reference acUSAdjoint,
  src/Handlers.cpp.Rt:1614-1662; SnapLevel, src/Lattice.cu.Rt:34-49):
  :func:`nested_checkpoint_scan`, ``levels`` nested loops with
  ``torch.utils.checkpoint`` between them, O(levels * T^(1/levels)) stored
  states;
* steady adjoint = repeated adjoint iterations against the converged
  primal (acSAdjoint, src/Handlers.cpp.Rt:1664-1707):
  :func:`make_steady_gradient`, a Neumann series of one step's VJPs;
* objective = the InObj-weighted sum of the globals (Lattice::calcGlobals,
  src/Lattice.cu.Rt:1113-1129), summed over the horizon;
* FDTest (acFDTest, src/Handlers.cpp.Rt:1944-2099) = :func:`fd_test`.

Engines: on a CUDA f32 lattice of a model whose device header has a
reverse stage, every step runs forward on ``generic2d_step`` and backward
on ``generic2d_step_b`` (``generic3d_step`` and ``generic3d_step_b`` for
a 3D model; ``ops/adjoint_kernels.py``); otherwise the eager step is
differentiated by ``torch.autograd``.  The choice is made from
what can be observed, never after a failure.  The spilled gradient and
revolve wait for ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tclb_tpu_torch.core.lattice import (LatticeState, SimParams,
                                         make_action_step, resolve_device)
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.utils import log


def objective_weights(model: Model, params: SimParams) -> torch.Tensor:
    """Per-Global weight vector from the ``<name>InObj`` settings."""
    idx = [model.setting_index[g.name + "InObj"] for g in model.globals_]
    return params.settings[idx]


def leaves(theta) -> tuple:
    """A design vector's tensors: ``theta`` itself or its tuple."""
    return tuple(theta) if isinstance(theta, (tuple, list)) else (theta,)


def like(theta, parts):
    """``parts`` in ``theta``'s structure (one tensor or a tuple)."""
    return tuple(parts) if isinstance(theta, (tuple, list)) else parts[0]


def nested_checkpoint_scan(body: Callable, state: Any, niter: int,
                           levels: int = 2) -> tuple[Any, torch.Tensor]:
    """Run ``state, inc = body(state)`` ``niter`` times, summing ``inc``,
    with ``levels`` nested checkpointed loops: the backward pass keeps
    O(levels * niter^(1/levels)) states and recomputes each inner segment
    from its entry state (the reference's log-leveled snapshot store)."""
    if niter <= 0:
        return state, torch.zeros(())
    if levels <= 1 or niter <= 4:
        total = None
        for _ in range(niter):
            state, inc = body(state)
            total = inc if total is None else total + inc
        return state, total
    chunk = max(2, int(round(niter ** (1.0 / levels))))
    n_outer, rem = divmod(niter, chunk)

    def one_chunk(s):
        return nested_checkpoint_scan(body, s, chunk, levels - 1)

    total = None
    for _ in range(n_outer):
        state, inc = checkpoint(one_chunk, state, use_reentrant=False,
                                preserve_rng_state=False)
        total = inc if total is None else total + inc
    if rem:
        state, inc = nested_checkpoint_scan(body, state, rem, levels - 1)
        total = inc if total is None else total + inc
    return state, total


def make_objective_run(model: Model, niter: int, action: str = "Iteration",
                       levels: int = 2,
                       step: Optional[Callable] = None) -> Callable:
    """``run(state, params) -> (objective, final_state)``: iterate ``niter``
    steps summing the InObj-weighted globals of each step.

    ``step`` overrides the eager step: a differentiable ``(state, params)
    -> state`` with per-step globals, or a kernel step
    (``adjoint_kernels.make_diff_step``) advertising ``chunk`` iterations
    per call, ``returns_inc`` (it returns ``(state, chunk_globals)``) and
    ``prepare`` (loop invariants bound once per run)."""
    if step is None:
        step = make_action_step(model, action)
    chunk = int(getattr(step, "chunk", 1))
    returns_inc = bool(getattr(step, "returns_inc", False))
    if niter % chunk:
        raise ValueError(f"niter={niter} not divisible by the engine "
                         f"chunk {chunk}")

    def run(state: LatticeState, params: SimParams):
        w = objective_weights(model, params)
        step_fn = step.prepare(state, params) \
            if hasattr(step, "prepare") else step

        def body(s):
            if returns_inc:
                s2, ginc = step_fn(s, params)
                return s2, torch.sum(w * ginc)
            s2 = step_fn(s, params)
            return s2, torch.sum(w * s2.globals_)

        final, obj = nested_checkpoint_scan(body, state, niter // chunk,
                                            levels)
        return obj, final

    return run


def design_needs(design) -> Optional[set]:
    """What a design's ``put`` touches (``{"state"}`` for the ported
    designs), or None for a design type this classifier does not know."""
    from tclb_tpu_torch.adjoint.design import (CompositeDesign,
                                               InternalTopology)
    if isinstance(design, InternalTopology):
        return {"state"}
    if isinstance(design, CompositeDesign):
        out: set = set()
        for d in design.designs:
            n = design_needs(d)
            if n is None:
                return None
            out |= n
        return out
    return None


def _pick_engine(model: Model, design, engine: str, shape, dtype, device,
                 action: str = "Iteration") -> Optional[Callable]:
    """Resolve ``engine`` ("auto", "cuda" or "eager") to a kernel step, or
    None for the eager step.  "auto" takes the kernels wherever they cover
    the configuration (a CUDA f32 lattice of a model whose header has a
    reverse stage, a state design, the Iteration action) and logs why
    not; "cuda" insists and raises where they do not.  Nothing is tried
    and caught."""
    from tclb_tpu_torch.ops import adjoint_kernels
    if engine == "eager":
        return None
    if engine not in ("auto", "cuda"):
        raise ValueError(f"unknown adjoint engine {engine!r}")
    reasons = []
    if shape is None:
        reasons.append("no lattice shape given")
    if action != "Iteration":
        reasons.append(f"action {action!r}")
    if design_needs(design) is None:
        reasons.append(f"unknown design type {type(design).__name__}")
    if resolve_device(device).type != "cuda":
        reasons.append("not on a CUDA device")
    if shape is not None and not adjoint_kernels.supports_diff(
            model, shape, dtype):
        reasons.append(f"no kernel adjoint for {model.name} "
                       f"{tuple(shape)} {dtype}")
    if reasons:
        if engine == "cuda":
            raise ValueError("the kernel adjoint does not cover this case: "
                             + "; ".join(reasons))
        log.info("adjoint engine: eager (" + "; ".join(reasons) + ")")
        return None
    step = adjoint_kernels.make_diff_step(model, shape, dtype)
    log.info(f"adjoint engine: {step.engine_name}")
    return step


def auto_levels(model: Model, shape, niter: int, chunk: int = 1,
                budget_bytes: float = 6e9,
                dtype: torch.dtype = torch.float32) -> int:
    """The checkpoint depth for the kernel step: 1 (every step's input
    kept, no recompute) where the kept states fit ``budget_bytes``, else
    2 (the reference's snapshot trade)."""
    per = torch.tensor([], dtype=dtype).element_size() \
        * model.n_storage * int(np.prod(shape))
    n_bodies = max(niter // max(chunk, 1), 1)
    return 1 if per * n_bodies <= budget_bytes else 2


def _detached(state: LatticeState) -> LatticeState:
    return dataclasses.replace(state, fields=state.fields.detach(),
                               globals_=state.globals_.detach())


def _grads(obj, theta, parts) -> Any:
    got = torch.autograd.grad(obj, parts, allow_unused=True)
    return like(theta, [torch.zeros_like(p) if g is None else g
                        for p, g in zip(parts, got)])


def make_unsteady_gradient(model: Model, design, niter: int,
                           action: str = "Iteration",
                           levels: Optional[int] = None,
                           engine: str = "auto",
                           shape: Optional[tuple] = None,
                           dtype: torch.dtype = torch.float32,
                           device: Any = None) -> Callable:
    """``grad_fn(theta, state, params) -> (objective, grads, final_state)``
    — reverse-mode sensitivity of the horizon-summed objective with
    respect to the design vector (reference acUSAdjoint + GetParameters,
    src/Handlers.cpp.Rt:1614-1713).  ``design.put`` injects ``theta``
    inside the differentiated function, so the gradient flows to exactly
    the declared degrees of freedom.

    ``engine`` as :func:`_pick_engine`; ``device`` is the lattice's (None
    means the card).  ``levels=None`` picks the checkpoint depth:
    :func:`auto_levels` for the kernel step, 2 for the eager step."""
    step = _pick_engine(model, design, engine, shape, dtype, device, action)
    if levels is None:
        levels = auto_levels(model, shape, niter, step.chunk,
                             dtype=dtype) if step is not None else 2
    run = make_objective_run(model, niter, action, levels, step=step)

    def grad_fn(theta, state: LatticeState, params: SimParams):
        parts = [t.detach().requires_grad_() for t in leaves(theta)]
        with torch.enable_grad():
            st, pa = design.put(like(theta, parts), state, params)
            obj, final = run(st, pa)
            g = _grads(obj, theta, parts)
        return obj.detach(), g, _detached(final)

    grad_fn.engine_name = getattr(step, "engine_name", "eager")
    return grad_fn


def _norm(ts) -> float:
    return float(torch.sqrt(sum(torch.sum(t * t) for t in ts) + 1e-300))


def make_steady_gradient(model: Model, design, n_adjoint: int = 100,
                         action: str = "Iteration", tol: float = 1e-10,
                         strict: bool = False, engine: str = "auto",
                         shape: Optional[tuple] = None,
                         dtype: torch.dtype = torch.float32,
                         device: Any = None) -> Callable:
    """Fixed-point (steady) adjoint: with the primal converged, solve
    ``lambda = A^T lambda + dJ/ds`` by up to ``n_adjoint`` adjoint
    iterations (the Neumann series of one step's VJPs) and return
    ``dJ/dtheta`` (reference acSAdjoint with ITER_STEADY,
    src/Handlers.cpp.Rt:1664-1707).

    ``grad_fn(theta, state, params) -> (objective, grads)``, the objective
    being one step's InObj-weighted globals at the fixed point.  The
    series stops once the gradient increment falls below ``tol`` relative
    to the accumulated gradient; a series still far from converged warns
    (raises with ``strict``), a diverging one raises."""
    step = _pick_engine(model, design, engine, shape, dtype, device, action)
    returns_inc = bool(getattr(step, "returns_inc", False))
    if step is None:
        step = make_action_step(model, action)

    def grad_fn(theta, state: LatticeState, params: SimParams):
        parts = [t.detach().requires_grad_() for t in leaves(theta)]
        fields = state.fields.detach().requires_grad_()
        with torch.enable_grad():
            st, pa = design.put(like(theta, parts),
                                dataclasses.replace(state, fields=fields),
                                params)
            w = objective_weights(model, pa)
            step_fn = step.prepare(st, pa) if hasattr(step, "prepare") \
                else step
            if returns_inc:
                s2, ginc = step_fn(st, pa)
                obj = torch.sum(w * ginc)
            else:
                s2 = step_fn(st, pa)
                obj = torch.sum(w * s2.globals_)
        new_fields = s2.fields

        def vjp(lam_f, lam_obj):
            got = torch.autograd.grad((new_fields, obj), parts + [fields],
                                      (lam_f, lam_obj), retain_graph=True,
                                      allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(parts + [fields], got)]
            return got[:-1], got[-1]

        acc, lam = vjp(torch.zeros_like(new_fields), torch.ones_like(obj))
        k, rel_inc = 0, 1.0
        while k < n_adjoint and rel_inc > tol:
            dth, lam = vjp(lam, torch.zeros_like(obj))
            acc = [a + d for a, d in zip(acc, dth)]
            rel_inc = _norm(dth) / max(_norm(acc), 1e-30)
            k += 1
        if not np.isfinite(rel_inc):
            raise FloatingPointError(
                "steady adjoint diverged: the primal state is not a stable "
                f"fixed point (gradient increment {rel_inc} after {k} "
                "passes)")
        if k >= n_adjoint and rel_inc > 1e-4:
            msg = (f"steady adjoint not fully converged: relative gradient "
                   f"increment {rel_inc:.3e} after {k} passes — the "
                   "gradient is approximate (raise n_adjoint or converge "
                   "the primal further)")
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return obj.detach(), like(theta, acc)

    grad_fn.engine_name = getattr(step, "engine_name", "eager")
    return grad_fn


def fd_test(loss: Callable, grad: Any, theta: Any, n_checks: int = 5,
            eps: float = 1e-5, seed: int = 0,
            indices: Optional[Any] = None) -> list[dict]:
    """Central-difference check of an adjoint gradient at ``n_checks``
    random components (reference acFDTest, src/Handlers.cpp.Rt:1944-2099),
    or at the flat ``indices`` given: ``loss(theta) -> scalar``, ``grad``
    in ``theta``'s structure.  One record per probed component with the
    analytic value, the FD value and the relative error."""
    parts = leaves(theta)
    flat = torch.cat([t.detach().reshape(-1) for t in parts])
    gflat = torch.cat([g.detach().reshape(-1) for g in leaves(grad)])
    sizes = [t.numel() for t in parts]

    def unravel(v):
        return like(theta, [c.reshape(t.shape)
                            for c, t in zip(torch.split(v, sizes), parts)])

    if indices is None:
        rng = np.random.default_rng(seed)
        idx = rng.choice(flat.numel(), size=min(n_checks, flat.numel()),
                         replace=False)
    else:
        idx = np.asarray(indices)
    out = []
    with torch.no_grad():
        for i in idx:
            e = torch.zeros_like(flat)
            e[int(i)] = eps
            fp = float(loss(unravel(flat + e)))
            fm = float(loss(unravel(flat - e)))
            fd = (fp - fm) / (2 * eps)
            an = float(gflat[int(i)])
            denom = max(abs(fd), abs(an), 1e-300)
            out.append({"index": int(i), "adjoint": an, "fd": fd,
                        "rel_err": abs(fd - an) / denom})
    return out
