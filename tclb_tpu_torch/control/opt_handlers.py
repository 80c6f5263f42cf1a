"""Optimization and adjoint XML handlers.

The port's counterpart of the JAX package's ``control/opt_handlers.py``
(reference src/Handlers.cpp.Rt): ``<InternalTopology>`` (:166),
``<Adjoint>`` (acUSAdjoint :1614 / acSAdjoint :1664), ``<FDTest>``
(acFDTest :1944), ``<Optimize>`` (acOptimize :1815) and
``<Threshold>``/``<ThresholdNow>`` (:2100/:2149).  Design handlers
register :class:`~tclb_tpu_torch.adjoint.design.Design` objects on the
solver; the actions build a differentiable objective over a fixed horizon
and record ``solver.adjoint_engine``, ``solver.objective`` and
``solver.gradient``.  ``<OptSolve>`` and the Control-series designs wait
(``handlers._WAITING``).
"""

from __future__ import annotations

import numpy as np
import torch

from tclb_tpu_torch.adjoint import (CompositeDesign, InternalTopology,
                                    fd_test, make_objective_run,
                                    make_steady_gradient,
                                    make_unsteady_gradient, optimize,
                                    threshold_topology)
from tclb_tpu_torch.adjoint.optimize import ravel
from tclb_tpu_torch.adjoint.run import leaves
from tclb_tpu_torch.control.handlers import GenericAction, Handler
from tclb_tpu_torch.control.solver import Solver
from tclb_tpu_torch.utils import log


def _active_design(solver: Solver):
    """The registered designs, or the model's parameter fields if none was
    declared."""
    if solver.designs:
        if len(solver.designs) == 1:
            return solver.designs[0]
        return CompositeDesign(solver.designs)
    return InternalTopology(solver.model)


def _design_bounds(design):
    b = design.bounds()
    if isinstance(b, tuple) and len(b) == 2 and not isinstance(b[0], tuple):
        return b
    # composite: the tightest common box
    los = [x[0] for x in b if x[0] is not None]
    his = [x[1] for x in b if x[1] is not None]
    return (max(los) if los else None, min(his) if his else None)


def _unsteady(s: Solver, design, niter: int):
    lat = s.lattice
    grad_fn = make_unsteady_gradient(s.model, design, niter,
                                     shape=lat.shape, dtype=lat.dtype,
                                     device=lat.device)
    s.adjoint_engine = grad_fn.engine_name
    return grad_fn


class dInternalTopology(Handler):
    """<InternalTopology/>: the parameter=True fields on the DesignSpace
    nodes are the design variables."""

    kind = "design"

    def init(self) -> int:
        super().init()
        self.solver.designs.append(InternalTopology(self.solver.model))
        return 0


class acAdjoint(GenericAction):
    """<Adjoint type="unsteady|steady" Iterations="N">: the children first,
    then the gradient of the InObj-weighted objective with respect to the
    active design; an unsteady adjoint advances the primal state."""

    def init(self) -> int:
        Handler.init(self)
        ret = self.execute_internal()
        if ret not in (0, None):
            return ret
        s = self.solver
        lat = s.lattice
        design = _active_design(s)
        theta = design.get(lat.state, lat.params)
        if self.node.get("type", "unsteady") == "steady":
            n_adj = int(round(s.units.alt(self.node.get("NAdjoint", "100"))))
            grad_fn = make_steady_gradient(s.model, design, n_adjoint=n_adj,
                                           shape=lat.shape, dtype=lat.dtype,
                                           device=lat.device)
            s.adjoint_engine = grad_fn.engine_name
            obj, g = grad_fn(theta, lat.state, lat.params)
        else:
            niter = int(round(s.units.alt(self.node.get("Iterations", "0"))))
            if niter <= 0:
                raise ValueError("unsteady <Adjoint> needs Iterations=")
            obj, g, final = _unsteady(s, design, niter)(theta, lat.state,
                                                         lat.params)
            lat.state = final
            s.iter += niter
        s.objective = float(obj)
        s.gradient = g
        s.design = design
        self.unstack()
        return 0


class acFDTest(GenericAction):
    """<FDTest Iterations="N" Checks="K" Epsilon="eps">: the adjoint
    gradient against central differences of the eager objective, logged
    (records in ``solver.fd_records``)."""

    def init(self) -> int:
        Handler.init(self)
        s = self.solver
        lat = s.lattice
        design = _active_design(s)
        niter = int(round(s.units.alt(self.node.get("Iterations", "4"))))
        checks = int(self.node.get("Checks", "5"))
        eps = float(self.node.get("Epsilon", "1e-6"))
        theta = design.get(lat.state, lat.params)
        obj, g, _ = _unsteady(s, design, niter)(theta, lat.state,
                                                lat.params)
        run = make_objective_run(s.model, niter)

        def loss(th):
            st, pa = design.put(th, lat.state, lat.params)
            return run(st, pa)[0]

        records = fd_test(loss, g, theta, n_checks=checks, eps=eps)
        s.fd_records = records
        s.objective = float(obj)
        s.gradient = g
        worst = max((r["rel_err"] for r in records
                     if not (r["adjoint"] == 0 and abs(r["fd"]) < 1e-12)),
                    default=0.0)
        log.info(f"FDTest: objective={float(obj):.6g} worst rel err="
                 f"{worst:.3e}")
        for r in records:
            log.info(f"  component {r['index']}: adjoint={r['adjoint']:.8g} "
                     f"fd={r['fd']:.8g} rel_err={r['rel_err']:.3e}")
        return 0


class acThresholdNow(Handler):
    """<ThresholdNow Level="0.5"/>: binarize the topology now."""

    def init(self) -> int:
        super().init()
        self.do_threshold()
        return 0

    def do_threshold(self) -> None:
        s = self.solver
        level = float(self.node.get("Level", "0.5"))
        s.lattice.state = threshold_topology(s.model, s.lattice.state, level)


class acThreshold(acThresholdNow):
    """<Threshold Iterations="N">: binarize periodically."""

    kind = "callback"

    def init(self) -> int:
        Handler.init(self)
        if not self.every_iter:
            self.do_threshold()
        return 0

    def do_it(self) -> int:
        self.do_threshold()
        return 0


def _material_mask(design, theta, state) -> np.ndarray:
    """Per-entry material weights: an InternalTopology theta is the whole
    plane, so only its design nodes count; every entry of another design
    counts."""
    children = design.designs if isinstance(design, CompositeDesign) \
        else (design,)
    out = []
    for d, th in zip(children, leaves(theta)):
        if isinstance(d, InternalTopology):
            m = d._mask(state).cpu().numpy()
            out.append(np.broadcast_to(m[None], tuple(th.shape))
                       .astype(np.float64).ravel())
        else:
            out.append(np.ones(th.numel()))
    return np.concatenate(out)


class acOptimize(GenericAction):
    """<Optimize Method="MMA" MaxEvaluations="20" Iterations="N" Step="1"
    Material="more|less">: the outer optimization over the registered
    designs; each evaluation is the objective over ``Iterations`` steps
    from the current state and its gradient.  Records each evaluation's
    objective in ``solver.opt_history`` and the material constraint's
    start and end in ``solver.opt_material``."""

    def init(self) -> int:
        Handler.init(self)
        ret = self.execute_internal()
        if ret not in (0, None):
            return ret
        s = self.solver
        lat = s.lattice
        design = _active_design(s)
        niter = int(round(s.units.alt(self.node.get("Iterations", "0"))))
        if niter <= 0:
            raise ValueError("<Optimize> needs Iterations= (objective "
                             "horizon per evaluation)")
        method = self.node.get("Method", "MMA")
        max_eval = int(self.node.get("MaxEvaluations", "20"))
        step = float(self.node.get("Step", "1.0"))
        grad_full = _unsteady(s, design, niter)
        s.opt_history = []

        def grad_fn(theta):
            obj, g, _ = grad_full(theta, lat.state, lat.params)
            return obj, g

        def cb(k, obj, theta):
            s.opt_iter = k
            s.opt_history.append(obj)
            log.info(f"Optimize[{method}] eval {k}: objective={obj:.8g}")

        theta0 = design.get(lat.state, lat.params)
        material = None
        mat = self.node.get("Material")
        if mat is not None:
            if mat not in ("more", "less"):
                raise ValueError('Material attribute in Optimize should '
                                 'be "more" or "less"')
            mask = _material_mask(design, theta0, lat.state)
            m0 = float(ravel(theta0)[0] @ mask)
            material = (mat, m0, mask)
            log.info(f"Optimize material constraint: {mat} than {m0:.6g}")
        theta, obj = optimize(grad_fn, theta0, method=method,
                              max_eval=max_eval, step=step,
                              bounds=_design_bounds(design), callback=cb,
                              material=material)
        if material is not None:
            s.opt_material = {"direction": mat, "start": material[1],
                              "end": float(ravel(theta)[0] @ material[2])}
        with torch.no_grad():
            lat.state, lat.params = design.put(theta, lat.state, lat.params)
        s.objective = obj
        self.unstack()
        return 0


HANDLERS = {
    "Adjoint": acAdjoint,
    "FDTest": acFDTest,
    "Threshold": acThreshold,
    "ThresholdNow": acThresholdNow,
    "Optimize": acOptimize,
    "InternalTopology": dInternalTopology,
}
