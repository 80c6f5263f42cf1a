"""The one-step reverse of the port's 3D heat design family (K8's plain
version, ``step_b_plain``) against ``jax.vjp`` of the JAX package's step
at f64, on the CPU, and the JAX package's derivative conventions that
the family's reverse follows (the clip's 0.5 at its bounds, |u_x|'s +1 at
0), pinned.  The design gradients are in
``tests/test_torch_heat_adj3d_grad.py``.
"""

# jax 0.9 turned batching.primitive_batchers into a proxy without ``in``,
# which the JAX package's ops/lbm.py uses at import; give it one
from jax._src.interpreters import batching as _batching

if not hasattr(type(_batching.primitive_batchers), "__contains__"):
    type(_batching.primitive_batchers).__contains__ = (
        lambda self, k: k in _batching.fancy_primitive_batchers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tclb_tpu.core.lattice import Lattice as JaxLattice  # noqa: E402
from tclb_tpu.core.lattice import make_action_step as jax_step  # noqa: E402
from tclb_tpu.models import get_model as jax_model  # noqa: E402
from tclb_tpu_torch import Lattice, get_model  # noqa: E402
from tclb_tpu_torch.models.d3q19_heat_adj import clip01  # noqa: E402
from tclb_tpu_torch.ops import adjoint_kernels as ak  # noqa: E402
from tclb_tpu_torch.ops import generic_kernels as gk  # noqa: E402
from torch_cases import (HEAT3D_SHAPE, heat3d_settings,  # noqa: E402
                         paint_rich_heat3d)

torch.set_num_threads(1)

F64_TOL = dict(rtol=1e-10, atol=1e-12)


def lattice_pair(name, seed=3):
    """The same rich f64 state in both packages."""
    a = JaxLattice(jax_model(name), HEAT3D_SHAPE, dtype=jnp.float64,
                   settings=heat3d_settings(jax_model(name)))
    b = Lattice(get_model(name), HEAT3D_SHAPE, dtype=torch.float64,
                settings=heat3d_settings(get_model(name)), device="cpu")
    return paint_rich_heat3d(a, seed), paint_rich_heat3d(b, seed)


# --------------------------------------------------------------------------- #
# the reverse and the gradients
# --------------------------------------------------------------------------- #


def test_step_b_plain_matches_jax_vjp():
    """lam_in and the settings cotangent of one _prop Iteration
    (``step_b`` on CPU tensors: its plain version) against ``jax.vjp`` of
    the JAX package's step at f64 on the rich state, whose w sits at 0 and
    1 on some nodes and whose Propagate nodes pull w1 = 1 on some (the
    clip's bounds); w's and w1's cotangents count.  (The base and _art
    variants' reverses are held to ``jax.grad`` through their design
    gradients.)"""
    a, b = lattice_pair("d3q19_heat_adj_prop")
    rng = np.random.default_rng(7)
    lam = rng.standard_normal((b.model.n_storage,) + HEAT3D_SHAPE)
    lam_g = rng.standard_normal(b.model.n_globals)
    step = jax_step(a.model)

    def fn(fields, sett):
        s = step(a.state.replace(fields=fields),
                 a.params.replace(settings=sett))
        return s.fields, s.globals_

    _, vjp = jax.vjp(fn, a.state.fields, a.params.settings)
    want_in, want_s = vjp((jnp.asarray(lam), jnp.asarray(lam_g)))
    f, flags, ztab, args = gk.kernel_inputs(b.model, b.state, b.params)
    ak.reset_launches()
    got_in, got_s = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                              torch.tensor(lam_g))
    assert set(ak.LAUNCHES.values()) == {0}     # plain on the CPU
    np.testing.assert_allclose(got_in.numpy(), np.asarray(want_in),
                               **F64_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-9, atol=1e-12)
    for plane in ("w", "w1"):
        assert np.abs(np.asarray(want_in)[b.model.storage_index[plane]]
                      ).max() > 0, plane
    assert np.isfinite(np.asarray(want_in)).all()


# --------------------------------------------------------------------------- #
# the JAX package's derivative conventions, pinned
# --------------------------------------------------------------------------- #


def test_clip_derivative_at_bounds_is_jax_convention():
    """``jnp.clip(x, 0, 1)`` has derivative 0.5 at x = 0 and x = 1 (a tie
    of maximum, then of minimum); the port's ``clip01`` follows it, where
    ``torch.clamp`` gives 1.  _prop's w_eff is such a clip, and its
    fluid nodes start at w = 1 exactly."""
    xs = [-0.5, 0.0, 0.5, 1.0, 1.5]
    want = [float(jax.grad(lambda x: jnp.clip(x, 0.0, 1.0))(jnp.float64(x)))
            for x in xs]
    assert want == [0.0, 0.5, 1.0, 0.5, 0.0]
    x = torch.tensor(xs, dtype=torch.float64, requires_grad=True)
    got, = torch.autograd.grad(clip01(x).sum(), x)
    assert got.tolist() == want
    x = torch.tensor(xs, dtype=torch.float64, requires_grad=True)
    clamp, = torch.autograd.grad(torch.clamp(x, 0.0, 1.0).sum(), x)
    assert clamp.tolist() == [0.0, 1.0, 1.0, 1.0, 0.0]


def test_abs_derivative_at_rest_is_jax_convention():
    """On a lattice at rest (u_x = 0 exactly on every node) with w = 0.5,
    Drag's cotangent reaches the populations through ``|u_x|``'s
    derivative at 0: +1 in JAX and in the port's step (``abs_jax``), so
    the +x populations take (1 - w) / rho, where ``torch.abs`` would give
    them none."""
    name = "d3q19_heat_adj"
    shape = (2, 4, 4)
    a = JaxLattice(jax_model(name), shape, dtype=jnp.float64,
                   settings={"Velocity": 0.0, "Porocity": 0.5})
    b = Lattice(get_model(name), shape, dtype=torch.float64,
                settings={"Velocity": 0.0, "Porocity": 0.5}, device="cpu")
    for lat in (a, b):
        lat.set_flags(np.full(shape, lat.model.flag_for("MRT"), np.uint16))
        lat.init()
    m = b.model
    assert float(b.get_quantity("U")[0].abs().max()) == 0.0
    assert float(b.fields_raw()[m.storage_index["w"]].min()) == 0.5
    lam_g = np.zeros(m.n_globals)
    lam_g[[g.name for g in m.globals_].index("Drag")] = 1.0
    lam = np.zeros((m.n_storage,) + shape)
    step = jax_step(a.model)
    _, vjp = jax.vjp(lambda f: step(a.state.replace(fields=f),
                                    a.params).globals_, a.state.fields)
    want, = vjp(jnp.asarray(lam_g))
    f, flags, ztab, args = gk.kernel_inputs(m, b.state, b.params)
    got, _ = ak.step_b(f, flags, ztab, args, torch.tensor(lam),
                       torch.tensor(lam_g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)
    rho = float(f[:19, 0, 0, 0].sum())
    assert float(got[1, 0, 0, 0]) == pytest.approx(0.5 / rho, rel=1e-12)
