"""Adjoint and optimization on PyTorch — the port's counterpart of the JAX
package's ``tclb_tpu/adjoint`` (the reference's Tapenade machinery and
its optimization handlers).

The whole iteration is differentiated with ``torch.autograd``: through
the eager step (``make_action_step``) at any dtype, or on the card through
the generic kernels with their hand-written backward kernel
(:func:`tclb_tpu_torch.ops.adjoint_kernels.make_diff_step`).  Memory is
traded against recompute with nested checkpointing, as the reference's
snapshot hierarchy does.  The spilled gradient, revolve and the Control
series designs wait for ROADMAP queue 1 items 10 and 11.
"""

from tclb_tpu_torch.adjoint.design import (BSpline, CompositeDesign,
                                           ControlSecond, Design, Fourier,
                                           InternalTopology, OptimalControl,
                                           RepeatControl,
                                           threshold_topology)
from tclb_tpu_torch.adjoint.optimize import batched_descent, optimize
from tclb_tpu_torch.adjoint.run import (auto_levels, fd_test,
                                        make_objective_run,
                                        make_steady_gradient,
                                        make_unsteady_gradient,
                                        nested_checkpoint_scan,
                                        objective_weights)

__all__ = [
    "nested_checkpoint_scan", "objective_weights", "make_objective_run",
    "make_unsteady_gradient", "make_steady_gradient", "fd_test",
    "auto_levels", "Design", "InternalTopology", "OptimalControl",
    "Fourier", "BSpline", "RepeatControl", "ControlSecond",
    "CompositeDesign", "threshold_topology", "optimize", "batched_descent",
]
